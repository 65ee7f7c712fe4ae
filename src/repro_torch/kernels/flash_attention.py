"""Blockwise (flash) attention with online softmax: the Hopper kernels,
their wrappers and their plain PyTorch versions.

Port of ``src/repro/kernels/flash_attention.py``:

* :func:`flash_attention` (``flash_attention``, body ``_flash_kernel``) —
  q ``(B, Hq, Sq, D)`` against K/V ``(B, Hkv, Sk, D)`` (bf16, float32, or
  int8 with ``(B, Hkv, Sk)`` float32 scales folded into the scores and the
  probabilities), GQA by head index, causal masking aligned to the top
  left (``q_pos >= k_pos``, both from 0) with KV blocks above the diagonal
  skipped, padding masked by the static ``kv_len`` or per-lane ``kv_lens``;
* :func:`paged_flash_attention` (``paged_flash_attention``, body
  ``_paged_kernel``) — decode attention straight off the int8 page pools
  ``(n_pages, page_size, Hkv, D)`` and their scale pools through block
  tables ``(B, P)``; pages at or past a lane's length are skipped.

Both compute, per KV block (one page for the paged kernel), in float32::

    s = (q . k) * sm_scale; s *= k_scale; masked -> -1e30
    m_new = max(m, rowmax s); p = exp(s - m_new); alpha = exp(m - m_new)
    l = alpha * l + sum p; p *= v_scale; acc = acc * alpha + p . v

and return ``acc / max(l, 1e-30)``. This is the kernels' function, not
the serving path's ``_decode_gqa`` (which rounds the probabilities to
bf16 before the value product). The kernel source, with its design note,
is ``csrc/flash_attn.cu``. Three bodies, each chosen by the call's
arguments (:func:`dense_body`, :func:`paged_body`):

* the tensor-core prefill body (``csrc/attn_mma.cuh``): dense calls with
  bf16 q, bf16 or int8 K/V, ``block_q`` a multiple of 16, head_dim 64 or
  128 and 16-byte-aligned operands; :func:`mma_body_model` is the plain
  model of its rounding;
* the split-KV decode body on the tensor cores (``csrc/attn_decode.cuh``):
  the paged kernel for bf16 q at head_dim 64 or 128 with at most
  :data:`DECODE_COLS` query rows a KV head, and the dense decode call that
  is its twin (bf16 q, int8 K/V, ``block_q < 16``, non-causal with
  ``kv_lens``). Each lane's positions are cut into splits of
  :data:`DECODE_SPLIT_KEYS`, each split's partial softmax state goes to a
  float32 workspace, and a second pass merges them;
  :func:`paged_decode_model` and :func:`dense_decode_model` are the plain
  models of its rounding. On gathered pools the two calls give the same
  bits;
* the float32 CUDA-core body, ``csrc/attn_common.cuh``, for every other
  call, shared by the two kernels likewise.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors — the query's device decides, nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _exact_matmul

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: head dims the tensor-core body is instantiated for
MMA_HEAD_DIMS = (64, 128)
#: K/V positions the tensor-core body stages per tile
MMA_KEYS = 64


#: positions of one split of the decode body (``csrc/attn_decode.cuh``
#: kSplitKeys: two stages of 64, four warp tiles of 16 each)
DECODE_SPLIT_KEYS = 128
DECODE_STAGE_KEYS = 64
DECODE_TILE_KEYS = 16
DECODE_WARPS = 4
#: query rows (group heads x Sq) a decode block holds: the mma's n8 side
DECODE_COLS = 8


def dense_body(q_dtype: torch.dtype, kv_dtype: torch.dtype, block_q: int, head_dim: int,
               aligned: bool, *, causal: bool = True, lens: bool = False,
               rows: int = 1) -> str:
    """The dense kernel's body for a call: ``"tensor_core"`` for bf16 q,
    bf16 or int8 K/V, ``block_q`` a multiple of 16, a head dim in
    :data:`MMA_HEAD_DIMS` and 16-byte-aligned q/K/V (prefill);
    ``"tensor_core_decode"`` for bf16 q, int8 K/V, ``block_q < 16``, a
    non-causal call with per-lane lengths (``lens``), a head dim in
    :data:`MMA_HEAD_DIMS`, at most :data:`DECODE_COLS` query ``rows`` a KV
    head (group heads x Sq) and aligned operands (decode: the paged
    kernel's twin); else ``"cuda_core"`` — float32 q or K/V, where the
    tensor cores would round, other head dims, and causal or static-length
    calls at ``block_q < 16``."""
    tc = q_dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS and aligned
    if tc and kv_dtype in (torch.bfloat16, torch.int8) and block_q % 16 == 0:
        return "tensor_core"
    if (tc and kv_dtype == torch.int8 and block_q < 16 and not causal and lens
            and rows <= DECODE_COLS):
        return "tensor_core_decode"
    return "cuda_core"


def paged_body(q_dtype: torch.dtype, head_dim: int, rows: int, aligned: bool) -> str:
    """The paged kernel's body for a call: ``"tensor_core_decode"`` for bf16
    q, a head dim in :data:`MMA_HEAD_DIMS`, at most :data:`DECODE_COLS`
    query ``rows`` a KV head (group heads x Sq) and 16-byte-aligned q and
    pools; else ``"cuda_core"``."""
    if (q_dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS and rows <= DECODE_COLS
            and aligned):
        return "tensor_core_decode"
    return "cuda_core"


def decode_launch(b: int, hkv: int, rows: int, head_dim: int, n_keys: int) -> dict:
    """Launch shape of the decode body for ``b`` lanes of ``n_keys``
    positions (the table's span, or Sk): splits a lane, blocks of the split
    pass's grid (one per split, KV head and lane; those past a lane's length
    exit at once) and of the combine pass, and the workspace's bytes."""
    splits = -(-n_keys // DECODE_SPLIT_KEYS)
    return {"split_keys": DECODE_SPLIT_KEYS, "splits": splits,
            "grid_blocks": splits * hkv * b, "combine_blocks": hkv * b,
            "workspace_bytes": 4 * b * hkv * splits * (rows * head_dim + 2 * DECODE_COLS)}


# ---------------------------------------------------------------------------
# Argument checks (shared by the kernels and the plain versions, with the
# reference wrappers' messages)
# ---------------------------------------------------------------------------


def _check_dense(q, k, v, *, block_q, block_k, kv_len, kv_lens, k_scale, v_scale) -> int:
    """The reference ``flash_attention``'s checks; returns the static
    KV length."""
    b, hq, sq, _ = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}")
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq lens ({sq},{sk}) must tile by ({block_q},{block_k})")
    if kv_lens is not None and kv_len is not None:
        raise ValueError("kv_len (static) and kv_lens (per-sequence) are exclusive")
    if kv_lens is not None and tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
    for name, scale in (("k_scale", k_scale), ("v_scale", v_scale)):
        if scale is not None and tuple(scale.shape) != (b, hkv, sk):
            raise ValueError(f"{name} must be ({b},{hkv},{sk}), got {tuple(scale.shape)}")
    static_kv_len = sk if kv_len is None else kv_len
    if not 0 < static_kv_len <= sk:
        raise ValueError(f"kv_len {static_kv_len} out of range (0, {sk}]")
    return static_kv_len


def _check_paged(q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_lens, *,
                 block_q) -> None:
    """The reference ``paged_flash_attention``'s checks."""
    b, hq, sq, _ = q.shape
    hkv = k_pool.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}")
    if sq % block_q:
        raise ValueError(f"Sq={sq} must tile by block_q={block_q}")
    if block_tables.shape[0] != b or block_tables.ndim != 2:
        raise ValueError(f"block_tables must be ({b}, P), got {tuple(block_tables.shape)}")
    if tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
    for name, pool, shape in (
        ("v_pool", v_pool, tuple(k_pool.shape)),
        ("k_scale_pool", k_scale_pool, tuple(k_pool.shape[:-1])),
        ("v_scale_pool", v_scale_pool, tuple(k_pool.shape[:-1])),
    ):
        if tuple(pool.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(pool.shape)}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _block_update(state, q, k, v, ks, vs, mask, sm_scale):
    """One KV block of the online softmax, in the kernels' operation order.
    q (B, H, R, D), k / v (B, H, BK, D) float32; ks / vs (B, H, BK) or
    None; ``mask`` broadcasts against the (B, H, R, BK) scores."""
    m, l, acc = state
    s = _exact_matmul(q, k.transpose(-1, -2)) * sm_scale
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = alpha * l + p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs[:, :, None, :]
    acc = acc * alpha + _exact_matmul(p, v)
    return m_new, l, acc


def _keep(run, new, old):
    """The state after a block that runs only where ``run`` holds."""
    return tuple(torch.where(run, n, o) for n, o in zip(new, old))


def _init_state(b, h, r, d, device):
    return (
        torch.full((b, h, r, 1), NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((b, h, r, 1), dtype=torch.float32, device=device),
        torch.zeros((b, h, r, d), dtype=torch.float32, device=device),
    )


def _f32_block(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    kv_len: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel (any device): the same
    blocks, masks, skipped blocks and float32 operation order."""
    static_kv_len = _check_dense(q, k, v, block_q=block_q, block_k=block_k, kv_len=kv_len,
                                 kv_lens=kv_lens, k_scale=k_scale, v_scale=v_scale)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d**-0.5
    dev = q.device
    # the group's query heads share one K/V head: rows (g, i) of one KV head
    qf = q.to(torch.float32).reshape(b, hkv, group * sq, d)
    q_pos = torch.arange(group * sq, device=dev) % sq
    kv_steps = sk // block_k
    lens = None if kv_lens is None else kv_lens.to(device=dev, dtype=torch.int64)
    state = _init_state(b, hkv, group * sq, d, dev)
    for ki in range(kv_steps):
        blk = slice(ki * block_k, (ki + 1) * block_k)
        k_pos = ki * block_k + torch.arange(block_k, device=dev)
        mask = torch.ones((group * sq, block_k), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if lens is not None:
            mask = mask & (k_pos[None, None, None, :] < lens[:, None, None, None])
        elif static_kv_len < kv_steps * block_k:
            mask = mask & (k_pos[None, :] < static_kv_len)
        new = _block_update(
            state, qf, _f32_block(k[:, :, blk]), _f32_block(v[:, :, blk]),
            None if k_scale is None else k_scale[:, :, blk].to(torch.float32),
            None if v_scale is None else v_scale[:, :, blk].to(torch.float32),
            mask, sm_scale,
        )
        if causal:  # the kernel skips blocks above each query block's diagonal
            run = ki * block_k <= (q_pos // block_q) * block_q + block_q - 1
            state = _keep(run[None, None, :, None], new, state)
        else:
            state = new
    _, l, acc = state
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype if out_dtype is None else out_dtype)


def mma_body_model(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    kv_len: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain model of the tensor-core body's rounding (float32 output):
    bf16 q and K (int8 K exact in bf16) with the products summed exactly
    and rounded to float32; tiles of :data:`MMA_KEYS` positions over the
    KV blocks each query block runs, masked to NEG_INF inside them and to
    -inf past them; the scales in the kernel's order; the probabilities
    split into a bf16 high and low part, each times bf16 V, summed exactly
    and rounded to float32."""
    static_kv_len = _check_dense(q, k, v, block_q=block_q, block_k=block_k, kv_len=kv_len,
                                 kv_lens=kv_lens, k_scale=k_scale, v_scale=v_scale)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    sm_scale = d**-0.5 if sm_scale is None else sm_scale
    f64 = torch.float64
    qf = q.to(torch.bfloat16).to(f64)
    kf = k.to(torch.bfloat16).to(f64).repeat_interleave(group, dim=1)
    vf = v.to(torch.bfloat16).to(f64).repeat_interleave(group, dim=1)
    ks = None if k_scale is None else k_scale.float().repeat_interleave(group, dim=1)
    vs = None if v_scale is None else v_scale.float().repeat_interleave(group, dim=1)
    limit = (torch.full((b,), static_kv_len) if kv_lens is None else kv_lens.to(torch.int64))
    rows = torch.arange(sq)
    steps = sk // block_k
    # the positions each row's query block runs
    end = (torch.clamp_max((rows // block_q * block_q + block_q - 1) // block_k + 1, steps)
           * block_k if causal else torch.full((sq,), steps * block_k))
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    o = torch.zeros((b, hq, sq, d))
    for t0 in range(0, int(end.max()), MMA_KEYS):
        keys = torch.arange(t0, min(t0 + MMA_KEYS, sk))
        s = (qf @ kf[:, :, keys].transpose(-1, -2)).to(torch.float32) * sm_scale
        if ks is not None:
            s = s * ks[:, :, None, keys]
        keep = (keys[None, :] < limit[:, None])[:, None, None, :]
        if causal:
            keep = keep & (rows[:, None] >= keys[None, :])
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        s = torch.where(keys[None, :] < end[:, None], s, torch.full_like(s, float("-inf")))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if vs is not None:
            p = p * vs[:, :, None, keys]
        p_hi = p.to(torch.bfloat16)
        p_lo = (p - p_hi.float()).to(torch.bfloat16)
        pv = p_hi.to(f64) @ vf[:, :, keys] + p_lo.to(f64) @ vf[:, :, keys]
        o = o * alpha + pv.to(torch.float32)
        m = m_new
    return o / torch.clamp_min(l, 1e-30)


def paged_flash_attention_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale_pool: torch.Tensor,
    v_scale_pool: torch.Tensor,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    block_q: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel (any device): one block
    per page through the table, pages at or past a lane's length skipped."""
    _check_paged(q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_lens,
                 block_q=block_q)
    b, hq, sq, d = q.shape
    _, page_size, hkv, _ = k_pool.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d**-0.5
    dev = q.device
    qf = q.to(torch.float32).reshape(b, hkv, group * sq, d)
    tables = block_tables.to(device=dev, dtype=torch.int64)
    lens = kv_lens.to(device=dev, dtype=torch.int64)
    state = _init_state(b, hkv, group * sq, d, dev)
    for ki in range(tables.shape[1]):
        pages = tables[:, ki]
        k_pos = ki * page_size + torch.arange(page_size, device=dev)
        mask = k_pos[None, None, None, :] < lens[:, None, None, None]
        new = _block_update(
            state, qf,
            _f32_block(k_pool[pages].permute(0, 2, 1, 3)),
            _f32_block(v_pool[pages].permute(0, 2, 1, 3)),
            k_scale_pool[pages].permute(0, 2, 1).to(torch.float32),
            v_scale_pool[pages].permute(0, 2, 1).to(torch.float32),
            mask, sm_scale,
        )
        run = ki * page_size < lens
        state = _keep(run[:, None, None, None], new, state)
    _, l, acc = state
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, d).to(torch.bfloat16 if out_dtype is None else out_dtype)


def _split_decode_model(q, k, v, ks, vs, lens, run_end, sm_scale):
    """The decode body's rounding on K/V laid out per lane, (B, Hkv, S, D)
    int8 with (B, Hkv, S) scales or None: lane b runs positions [0,
    run_end[b]), masked to NEG_INF from lens[b] on."""
    b, hq, sq, d = q.shape
    hkv, n_keys = k.shape[1], k.shape[2]
    rows = hq // hkv * sq
    f64 = torch.float64
    qf = q.to(torch.bfloat16).to(f64).reshape(b, hkv, rows, d)
    kf, vf = k.to(f64), v.to(f64)  # int8 is exact in bf16
    ks = torch.ones(k.shape[:3]) if ks is None else ks.float()
    vs = torch.ones(k.shape[:3]) if vs is None else vs.float()
    inf = float("inf")

    def merge(states):  # in order: factors exp(m_i - max m), each sum in turn
        mm = states[0][0]
        for m, _, _ in states[1:]:
            mm = torch.maximum(mm, m)
        l_sum, o_sum = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
        for m, l, o in states:
            f = torch.exp(m - mm)
            o_sum = o_sum + f * o
            l_sum = l_sum + f * l
        return mm, l_sum, o_sum

    out = torch.zeros((b, hkv, rows, d))
    for lane in range(b):
        end, n = int(run_end[lane]), int(lens[lane])
        parts = []
        for key0 in range(0, end, DECODE_SPLIT_KEYS):
            warps = []
            for w in range(DECODE_WARPS):
                m = torch.full((hkv, rows, 1), -inf)
                l = torch.zeros((hkv, rows, 1))
                o = torch.zeros((hkv, rows, d))
                for t0 in range(key0 + w * DECODE_TILE_KEYS, key0 + DECODE_SPLIT_KEYS,
                                DECODE_STAGE_KEYS):
                    if t0 >= end:
                        continue
                    keys = torch.arange(t0, t0 + DECODE_TILE_KEYS)
                    at = keys.clamp_max(n_keys - 1)
                    s = (qf[lane] @ kf[lane][:, at].transpose(-1, -2)).to(torch.float32)
                    s = s * sm_scale * ks[lane][:, None, at]
                    s = torch.where(keys < n, s, torch.full_like(s, NEG_INF))
                    s = torch.where(keys < end, s, torch.full_like(s, -inf))
                    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                    p = torch.exp(s - m_new)
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum(dim=-1, keepdim=True)
                    p = p * vs[lane][:, None, at]
                    p_hi = p.to(torch.bfloat16)
                    p_lo = (p - p_hi.float()).to(torch.bfloat16)
                    pv = p_hi.to(f64) @ vf[lane][:, at] + p_lo.to(f64) @ vf[lane][:, at]
                    o = o * alpha + pv.to(torch.float32)
                    m = m_new
                warps.append((m, l, o))
            parts.append(merge(warps))
        if parts:
            _, l, o = merge(parts)
            out[lane] = o / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, d)


def paged_decode_model(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale_pool: torch.Tensor,
    v_scale_pool: torch.Tensor,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain model of the split-KV decode body's rounding for a paged call
    (float32 output, CPU): bf16 q times int8 K (exact in bf16), the products
    summed exactly and rounded to float32; each lane's positions up to its
    length cut into splits of :data:`DECODE_SPLIT_KEYS`, each split into
    two stages of four warp tiles of :data:`DECODE_TILE_KEYS`, warp w taking
    tile w of each stage with its own online softmax (positions past the
    length -inf); the scales in the kernel's order; p split into a bf16 high
    and low part, each times int8 V, summed exactly and rounded to float32;
    the warps' states merged in warp order, then the splits' in split
    order; a lane of length 0 gives 0."""
    _check_paged(q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_lens,
                 block_q=1)
    b, p = block_tables.shape
    ps = k_pool.shape[1]
    flat = block_tables.to(torch.int64).reshape(-1)

    def lanes(pool):  # (n_pages, ps, Hkv[, D]) -> (B, Hkv, P * ps[, D])
        x = pool[flat].reshape(b, p * ps, *pool.shape[2:])
        return x.transpose(1, 2)

    lens = kv_lens.to(torch.int64)
    return _split_decode_model(
        q, lanes(k_pool), lanes(v_pool), lanes(k_scale_pool), lanes(v_scale_pool), lens,
        lens.clamp(0, p * ps), q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)


def dense_decode_model(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_lens: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain model of the same body for the dense decode call, the paged
    kernel's twin (non-causal, per-lane ``kv_lens``, int8 K/V): the same
    positions and rounding, except that a lane of length 0 runs all its Sk
    positions, each masked, as the dense plain version does."""
    sk = k.shape[2]
    lens = kv_lens.to(torch.int64)
    run_end = torch.where(lens > 0, lens.clamp_max(sk), torch.full_like(lens, sk))
    return _split_decode_model(q, k, v, k_scale, v_scale, lens, run_end,
                               q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("flash_attn")
    dense, paged = lib.flash_attention_launch, lib.paged_flash_attention_launch
    if dense.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dense.argtypes = [
            p, i, p, p, i,  # q, q dtype, k, v, kv dtype
            p, p, p,  # k_scale, v_scale, kv_lens
            p, i,  # out, out dtype
            i, i, i, i, i, i,  # B, Hq, Hkv, Sq, Sk, D
            i, i, i, i, f, i, i,  # block_q, block_k, causal, kv_len, sm_scale, vec, body
            p, p,  # workspace, stream
        ]
        dense.restype = ctypes.c_int
        paged.argtypes = [
            p, i, p, p, p, p,  # q, q dtype, pools
            p, p,  # tables, kv_lens
            p, i,  # out, out dtype
            i, i, i, i, i, i, i,  # B, Hq, Hkv, Sq, D, page_size, P
            f, i, i,  # sm_scale, vec, body
            p, p,  # workspace, stream
        ]
        paged.restype = ctypes.c_int
        if lib.decode_split_keys() != DECODE_SPLIT_KEYS:
            raise RuntimeError(f"the decode body splits by {lib.decode_split_keys()} positions, "
                               f"the wrapper sizes its workspace by {DECODE_SPLIT_KEYS}")
    return dense, paged


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on(t: torch.Tensor, dev, dtypes, name) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {[str(x) for x in dtypes]}, got {t.dtype}")
    return t.contiguous()


def _vec(d: int, elem: int, *tensors) -> int:
    """16-byte loads: every row 16-byte aligned."""
    return int((d * elem) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


_FLOATS = (torch.float32, torch.bfloat16)
# the C entry points' body codes (flash_attn.cu)
_BODY_CODES = {"cuda_core": 0, "tensor_core": 1, "tensor_core_decode": 2}
_PAGED_BODY_CODES = {"cuda_core": 0, "tensor_core_decode": 1}


def _workspace(shape: dict, dev) -> torch.Tensor:
    """The decode body's float32 workspace of split partials (every
    element written before it is read)."""
    return torch.empty(shape["workspace_bytes"] // 4, dtype=torch.float32, device=dev)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    kv_len: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0 (GQA).

    Sq % block_q == 0 and Sk % block_k == 0 (``ops.flash_attention`` pads
    otherwise). ``kv_len``: the number of real KV positions (<= Sk), the
    rest masked; ``kv_lens``: (B,) per-lane valid lengths instead (lanes of
    length 0 give finite values, never NaN). ``k_scale``/``v_scale``: (B,
    Hkv, Sk) float32 scales of an int8 K/V. ``out_dtype`` defaults to q's.
    Returns (B, Hq, Sq, D). CPU tensors run :func:`flash_attention_plain`;
    CUDA tensors launch the kernel, and arguments it does not take raise.
    The kernel's body follows the arguments (:func:`dense_body`): the
    tensor-core body for bf16 q with bf16 or int8 K/V at ``block_q`` a
    multiple of 16 (prefill), the split-KV decode body for bf16 q with int8
    K/V at ``block_q < 16``, non-causal with ``kv_lens`` (the paged
    kernel's twin), the float32 CUDA-core body otherwise."""
    kw = dict(causal=causal, sm_scale=sm_scale, block_q=block_q, block_k=block_k,
              kv_len=kv_len, kv_lens=kv_lens, k_scale=k_scale, v_scale=v_scale,
              out_dtype=out_dtype)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    static_kv_len = _check_dense(q, k, v, block_q=block_q, block_k=block_k, kv_len=kv_len,
                                 kv_lens=kv_lens, k_scale=k_scale, v_scale=v_scale)
    dev = q.device
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.dtype != v.dtype:
        raise ValueError(f"k and v must share a dtype, got {k.dtype} / {v.dtype}")
    qc = _on(q, dev, _FLOATS, "q")
    kc = _on(k, dev, tuple(_DTYPE_CODES), "k")
    vc = _on(v, dev, tuple(_DTYPE_CODES), "v")
    ksc = None if k_scale is None else _on(k_scale.to(torch.float32), dev, _FLOATS, "k_scale")
    vsc = None if v_scale is None else _on(v_scale.to(torch.float32), dev, _FLOATS, "v_scale")
    lens = None if kv_lens is None else _on(kv_lens.to(torch.int32), dev, (torch.int32,),
                                            "kv_lens")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty(q.shape, dtype=out_dtype, device=dev)
    vec = _vec(d, kc.element_size(), kc, vc)
    rows = hq // hkv * sq
    body = dense_body(qc.dtype, kc.dtype, block_q, d, bool(vec) and qc.data_ptr() % 16 == 0,
                      causal=causal, lens=lens is not None, rows=rows)
    ws = (_workspace(decode_launch(b, hkv, rows, d, sk), dev)
          if body == "tensor_core_decode" else None)
    flash_attention.launches += 1
    err = _lib()[0](
        _ptr(qc), _DTYPE_CODES[qc.dtype], _ptr(kc), _ptr(vc), _DTYPE_CODES[kc.dtype],
        _ptr(ksc), _ptr(vsc), _ptr(lens), _ptr(out), _DTYPE_CODES[out_dtype],
        b, hq, hkv, sq, sk, d, block_q, block_k, int(causal), static_kv_len,
        float(d**-0.5 if sm_scale is None else sm_scale), vec, _BODY_CODES[body], _ptr(ws),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out


flash_attention.launches = 0


def paged_flash_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale_pool: torch.Tensor,
    v_scale_pool: torch.Tensor,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    block_q: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Decode attention straight off the paged int8 KV pools.

    q: (B, Hq, Sq, D); pools: (n_pages, page_size, Hkv, D) int8 with
    (n_pages, page_size, Hkv) float32 scales (one layer's pools, as
    ``models.paging.paged_init_cache`` stores them); block_tables: (B, P);
    kv_lens: (B,). One KV block is one page; pages at or past a lane's
    length are skipped, so table entries past it (the null page) are never
    read. The length mask is the only mask (a decode query sits at
    ``len - 1``). Returns (B, Hq, Sq, D) in ``out_dtype`` (bf16 by
    default). CPU tensors run :func:`paged_flash_attention_plain`; CUDA
    tensors launch the kernel, and arguments it does not take raise. The
    kernel's body follows the arguments (:func:`paged_body`): the split-KV
    decode body on the tensor cores for bf16 q (two launches: the splits,
    then their combine; nothing is read back on the host), the float32
    CUDA-core body otherwise. Inside a cost report (``launch/cost.py``) the
    call is charged by its function (``paged_attention_cost``)."""
    from repro_torch.core.plan import charged

    args = (q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_lens)
    kw = dict(sm_scale=sm_scale, block_q=block_q, out_dtype=out_dtype)
    return charged(
        lambda: paged_attention_cost(*args),
        lambda: _paged_flash_attention(*args, **kw),
        lambda: q.new_empty(q.shape, dtype=torch.bfloat16 if out_dtype is None else out_dtype),
        q.is_meta,
    )


def paged_attention_cost(q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables,
                         kv_lens):
    """What one paged call's function needs (``launch/roofline.attention_call``):
    4 operations per (query head, query, live key, d); q, the live pages'
    K/V and scales, the tables and lengths read once, the output written
    once. The live keys are the lengths' sum (read back), or on meta
    tensors the tables' whole span."""
    from repro_torch.launch import roofline

    b, hq, sq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    if kv_lens.is_meta:
        keys = b * block_tables.shape[1] * page
        pages = b * block_tables.shape[1]
    else:
        lens = [int(v) for v in kv_lens.tolist()]
        keys, pages = sum(lens), sum(-(-n // page) for n in lens)
    page_bytes = page * hkv * (2 * d * k_pool.element_size() + 2 * k_scale_pool.element_size())
    n_bytes = (2 * q.numel() * q.element_size() + pages * page_bytes
               + block_tables.numel() * block_tables.element_size()
               + kv_lens.numel() * kv_lens.element_size())
    return roofline.attention_call(hq, keys * sq, d, n_bytes)


def _paged_flash_attention(q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables,
                           kv_lens, *, sm_scale, block_q, out_dtype):
    if not q.is_cuda:
        return paged_flash_attention_plain(
            q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_lens,
            sm_scale=sm_scale, block_q=block_q, out_dtype=out_dtype,
        )
    _check_paged(q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_lens,
                 block_q=block_q)
    dev = q.device
    b, hq, sq, d = q.shape
    _, page_size, hkv, _ = k_pool.shape
    qc = _on(q, dev, _FLOATS, "q")
    kp = _on(k_pool, dev, (torch.int8,), "k_pool")
    vp = _on(v_pool, dev, (torch.int8,), "v_pool")
    ksp = _on(k_scale_pool.to(torch.float32), dev, (torch.float32,), "k_scale_pool")
    vsp = _on(v_scale_pool.to(torch.float32), dev, (torch.float32,), "v_scale_pool")
    tables = _on(block_tables.to(torch.int32), dev, (torch.int32,), "block_tables")
    lens = _on(kv_lens.to(torch.int32), dev, (torch.int32,), "kv_lens")
    out_dtype = torch.bfloat16 if out_dtype is None else out_dtype
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty(q.shape, dtype=out_dtype, device=dev)
    vec = _vec(d, 1, kp, vp)
    rows = hq // hkv * sq
    n_keys = tables.shape[1] * page_size
    body = paged_body(qc.dtype, d, rows, bool(vec) and qc.data_ptr() % 16 == 0)
    ws = (_workspace(decode_launch(b, hkv, rows, d, n_keys), dev)
          if body == "tensor_core_decode" else None)
    paged_flash_attention.launches += 1
    err = _lib()[1](
        _ptr(qc), _DTYPE_CODES[qc.dtype], _ptr(kp), _ptr(vp), _ptr(ksp), _ptr(vsp),
        _ptr(tables), _ptr(lens), _ptr(out), _DTYPE_CODES[out_dtype],
        b, hq, hkv, sq, d, page_size, tables.shape[1],
        float(d**-0.5 if sm_scale is None else sm_scale), vec, _PAGED_BODY_CODES[body],
        _ptr(ws), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_flash_attention launch failed: CUDA error {err}")
    return out


paged_flash_attention.launches = 0
