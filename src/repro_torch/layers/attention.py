"""Grouped-query attention over a dense or paged, slot-indexed KV cache.

Prefill runs an online-softmax scan over KV chunks (the flash schedule in
plain PyTorch); when it fills a cache it attends over the cache's whole
extent under a kv-length mask, as the reference does. Decode attends one
token per slot against the cache; an int8 cache stays int8 — the K scale
folds into the scores and the V scale into the softmax weights, so
dequantized K/V are never materialized. Projections go through
:mod:`repro_torch.layers.linear`.

A paged cache (``models/paging.py``: int8 page pools, a block table per
slot) is decode-only. The append scatters each slot's new vector into its
current page, in place (as ``models.paging`` updates the cache); the
attention then reads the pools through the tables: with
the Hopper kernels (backend ``"auto"`` on the card, or ``"cuda"``) in the
paged flash-attention kernel, with no gather; with the plain versions
(``"torch"``) as the reference does, by gathering each slot's pages into
the dense view and running the same ``_decode_gqa`` as a dense cache.
The two are close but not bit-equal: ``_decode_gqa`` rounds the softmax
weights to bf16 before the value product, the kernel keeps them in
float32.

Q/K/V keep their storage dtype (bf16) and the score and value products
accumulate in float32, the reference's dtypes.

A sliding-window layer (``window > 0``, the hybrid's local attention)
keeps a ring of ``min(window, max_len)`` rows: decode writes at
``len % rows`` and attends the filled extent (softmax does not depend on
the order of its keys, and RoPE is already applied). Its prefill attends
the chunk's own K/V with the block-pair trick (:func:`_local_gqa`) and
stores the trailing rows. The two windowed prefills the reference gets
wrong (one that continues a filled ring, one longer than the ring and not
a multiple of it) are refused by the model before they reach this layer
(``models.transformer.check_prefill``).
Paged caches refuse windows (``models.paging``). The windowed attention
runs inside the ``torch.profiler`` range ``family.ring_attention``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import paged_flash_attention
from repro_torch.kernels.ops import resolve_backend
from repro_torch.layers.linear import linear_init, projection
from repro_torch.layers.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.layers.rotary import apply_rope
from repro_torch.models.cache import quantize_kv

NEG_INF = -1e30
_NO_RANGE = contextlib.nullcontext()


def attention_init(gen, d_model, n_heads, n_kv_heads, head_dim, dtype=torch.bfloat16,
                   qk_norm=False, device=None):
    params = {
        "q_proj": linear_init(gen, d_model, n_heads * head_dim, dtype, device),
        "k_proj": linear_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "v_proj": linear_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "o_proj": linear_init(gen, n_heads * head_dim, d_model, dtype, device),
    }
    if qk_norm:
        params["q_norm"] = rmsnorm_init(head_dim, device)
        params["k_norm"] = rmsnorm_init(head_dim, device)
    return params


def _chunked_gqa(q, k, v, *, causal: bool, chunk: int, q_offset: int, kv_len=None,
                 remat: bool = False):
    """Online-softmax attention. q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D) bf16.

    ``q_offset``: absolute position of q[0] minus that of k[0];
    ``kv_len``: valid KV length (the rest of the extent is masked).
    ``remat``: each chunk's step runs under ``torch.utils.checkpoint``, so
    the backward recomputes its scores instead of keeping them (the
    reference's ``jax.checkpoint`` on the scan body)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.reshape(b, sq, hkv, group, d).to(torch.float32)
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None] + q_offset

    def step(m, l, acc, kj, vj, j):
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kj.to(torch.float32)) * (d**-0.5)
        k_pos = j * chunk + torch.arange(chunk, device=dev)[None, :]
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos >= k_pos
        if kv_len is not None:
            mask &= k_pos < kv_len
        if pad:
            mask &= k_pos < skv
        s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vj.dtype).to(torch.float32), vj.to(torch.float32)
        )
        return m_new, l, acc * alpha + pv

    m = torch.full((b, sq, hkv, group, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, group, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, group, d), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        if kj.shape[1] < chunk:
            extra = chunk - kj.shape[1]
            kj = torch.cat([kj, kj.new_zeros((b, extra, hkv, d))], dim=1)
            vj = torch.cat([vj, vj.new_zeros((b, extra, hkv, d))], dim=1)
        if remat:
            m, l, acc = checkpoint(step, m, l, acc, kj, vj, j, use_reentrant=False)
        else:
            m, l, acc = step(m, l, acc, kj, vj, j)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, sq, hq, d)


def _local_gqa(q, k, v, *, window: int):
    """Sliding-window attention by the block-pair trick: the sequence is cut
    into ``window``-sized blocks (zero-padded at the end) and each query
    block attends its own and the previous block under a banded causal
    mask, in float32. q: (B,S,Hq,D); k,v: (B,S,Hkv,D)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    w = window
    pad = (-s) % w
    if pad:
        q = torch.cat([q, q.new_zeros((b, pad, hq, d))], dim=1)
        k = torch.cat([k, k.new_zeros((b, pad, hkv, d))], dim=1)
        v = torch.cat([v, v.new_zeros((b, pad, hkv, d))], dim=1)
    sp = s + pad
    nb = sp // w
    dev = q.device
    qb = q.to(torch.float32).reshape(b, nb, w, hkv, group, d) * (d**-0.5)
    kb = k.to(torch.float32).reshape(b, nb, w, hkv, d)
    vb = v.to(torch.float32).reshape(b, nb, w, hkv, d)
    # the previous block (zeros for block 0)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)  # (B, nb, 2w, Hkv, D)
    v2 = torch.cat([vprev, vb], dim=2)
    s_ = torch.einsum("bnqhgd,bnkhd->bnqhgk", qb, k2)  # (B,nb,w,Hkv,G,2w)
    qpos = torch.arange(w, device=dev)[:, None] + w  # position within the 2w pair
    kpos = torch.arange(2 * w, device=dev)[None, :]
    blk = torch.arange(nb, device=dev)[:, None, None]
    mask = (qpos >= kpos) & (qpos - kpos < w)  # causal sliding band
    kv_abs = blk * w + kpos - w
    # block 0 has no previous block; the tail padding is masked too
    mask = mask[None] & (kv_abs >= 0) & (kv_abs < s)
    s_ = torch.where(mask[None, :, :, None, None, :], s_, torch.full_like(s_, NEG_INF))
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bnqhgk,bnkhd->bnqhgd", p, v2)
    return out.reshape(b, sp, hq, d)[:, :s]


def _decode_gqa(q, k_cache, v_cache, valid, k_scale=None, v_scale=None):
    """One-token decode over a slot cache. q: (B,1,Hq,D); ``valid`` (B,S)
    marks live KV positions; int8 caches pass their per-(position, head)
    scales, folded into scores (K) and softmax weights (V).

    The two products and the softmax sum run one KV head at a time, on the
    shapes of one head: over several heads at once the library picks its
    reduction order by their number (cuBLAS's batched products do on the
    card), and a tensor-parallel rank, which holds ``Hkv / P`` of them,
    would then round otherwise than one device. The element-wise steps
    between them, and the maximum (exact in any order), run on every head
    at once. The operands are laid out head-major, so every head's slices
    have the same strides, and each head's slice starts 16-byte aligned
    (or is copied), as the library's kernel choice also reads alignment."""
    b, _, hq, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qf = q.reshape(b, hkv, group, d).transpose(0, 1).to(torch.float32).contiguous()
    kc = (k_cache.to(q.dtype) if k_scale is not None else k_cache).to(torch.float32)
    kc = kc.permute(2, 0, 1, 3).contiguous()  # (Hkv, B, S, D)
    vc = v_cache.to(q.dtype) if v_scale is not None else v_cache
    vf = vc.to(torch.float32).permute(2, 0, 1, 3).contiguous()
    s = torch.stack([torch.bmm(qf[h], kc[h].transpose(1, 2)) for h in range(hkv)])
    s = s * (d**-0.5)  # (Hkv, B, G, S)
    if k_scale is not None:
        s = s * k_scale.permute(2, 0, 1)[:, :, None, :]
    s = torch.where(valid[None, :, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    pv = p * v_scale.permute(2, 0, 1)[:, :, None, :] if v_scale is not None else p
    pv = pv.to(vc.dtype).to(torch.float32)
    head = (lambda t: t.clone()) if (b * group * s_len) % 4 else (lambda t: t)
    l = torch.stack([head(p[h]).sum(dim=-1, keepdim=True) for h in range(hkv)])
    out = torch.stack([torch.bmm(head(pv[h]), vf[h]) for h in range(hkv)])
    out = out / torch.clamp_min(l, 1e-30)  # (Hkv, B, G, D)
    return out.transpose(0, 1).reshape(b, 1, hq, d)


def attention_apply(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    causal: bool = True,
    window: int = 0,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    qk_norm: bool = False,
    chunk: int = 1024,
    policy,
    training: bool = False,
    backend: str = "auto",
    name: str = "attn",
    cache: Optional[dict] = None,
    q_rows: Optional[tuple] = None,
):
    """Returns (out, new_cache). ``cache``: a dense slot cache
    ``{'k_q','k_scale','v_q','v_scale','len'}`` (int8) or ``{'k','v','len'}``
    (raw bf16) with k/v (B, S_max, Hkv, D), or a paged block
    ``{'k_q','k_scale','v_q','v_scale','block_table','len'}`` with pools
    (n_pages, page_size, Hkv, D); one token per slot decodes, several
    prefill (into a raw cache only). ``window > 0``: a sliding window, the
    cache a ring of rows (module docstring). Decode updates ``cache`` in place
    (the new row and ``len``) and returns it, so a step leaves its results
    in the buffers it reads; prefill leaves its input cache as it was and
    returns a new one. ``training``: the projections fake-quantize under an
    active policy (QAT), and the cache-free attention recomputes each KV
    chunk's scores in the backward. ``use_rope=False`` leaves q and k
    unrotated; ``causal=False`` (cache-free) attends every position.

    ``q_rows=(lo, hi)`` (cache-free, unwindowed): only query rows
    ``lo:hi`` are computed, against every key, and the output holds those
    rows (a context-parallel rank's share of the sequence)."""
    b, s, _ = x.shape
    la = projection(policy=policy, training=training, backend=backend)
    lo, hi = (0, s) if q_rows is None else q_rows
    xq, q_pos = (x, positions) if q_rows is None else (x[:, lo:hi], positions[:, lo:hi])
    q = la(params["q_proj"], xq, name=f"{name}/q_proj").reshape(b, hi - lo, n_heads, head_dim)
    k = la(params["k_proj"], x, name=f"{name}/k_proj").reshape(b, s, n_kv_heads, head_dim)
    v = la(params["v_proj"], x, name=f"{name}/v_proj").reshape(b, s, n_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm_apply(params["q_norm"], q)
        k = rmsnorm_apply(params["k_norm"], k)
    if use_rope:
        q = apply_rope(q, q_pos, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if q_rows is not None and (cache is not None or window):
        raise ValueError("q_rows is for the cache-free, unwindowed attention")

    new_cache = cache
    if cache is not None and s == 1 and "block_table" in cache:  # paged decode
        # the append, in place: one (position, head) vector into each slot's
        # current page; free lanes (table cleared to the null page 0) write
        # there, never into a page since reallocated to another tenant. A
        # lane at or past its table's span (a free lane's length keeps
        # counting) writes nothing, as the reference's scatter drops an
        # out-of-range page: its index is clamped to the last table entry
        # and that row is written back as it was
        bt = cache["block_table"]  # (B, P) int32
        ps = cache["k_q"].shape[1]
        pos = cache["len"].to(torch.int64)
        inside = pos // ps < bt.shape[1]
        page = torch.clamp(pos // ps, max=bt.shape[1] - 1)
        phys = torch.gather(bt.to(torch.int64), 1, page[:, None])[:, 0]
        row = pos % ps
        k_new, ks_new = quantize_kv(k)
        v_new, vs_new = quantize_kv(v)
        for key, val in (("k_q", k_new), ("k_scale", ks_new), ("v_q", v_new), ("v_scale", vs_new)):
            pool = cache[key]
            keep = inside.reshape((b,) + (1,) * (val.dim() - 2))
            pool[phys, row] = torch.where(keep, val[:, 0], pool[phys, row])
        kv_len = cache["len"] + 1
        pools = (cache["k_q"], cache["v_q"], cache["k_scale"], cache["v_scale"])
        if resolve_backend(backend, x.device) == "cuda":
            out = paged_flash_attention(q.permute(0, 2, 1, 3), *pools, bt, kv_len)
            out = out.permute(0, 2, 1, 3)
        else:
            b_, p_ = bt.shape
            s_max = p_ * ps
            flat = bt.to(torch.int64).reshape(-1)
            kd, vd, ksd, vsd = (pool[flat].reshape(b_, s_max, *pool.shape[2:]) for pool in pools)
            valid = torch.arange(s_max, device=x.device)[None, :] < kv_len[:, None]
            out = _decode_gqa(q, kd, vd, valid, ksd, vsd)
        cache["len"].copy_(kv_len)
    elif cache is not None and s == 1:  # decode step
        # the append, in place: each slot's new (position, head) vector into
        # its row ``len`` (a ring: ``len % rows``); past the extent of a full
        # cache a slot writes nothing (its last row is written back as it was)
        quantized = "k_q" in cache
        pos = cache["len"]  # (B,) tokens already in each slot
        s_max = (cache["k_q"] if quantized else cache["k"]).shape[1]
        rows = torch.arange(s_max, device=x.device)[None, :]
        kv_len = pos + 1
        lane = torch.arange(b, device=x.device)
        if window:
            valid = rows < torch.clamp(kv_len, max=s_max)[:, None]
            at = torch.remainder(pos, s_max).to(torch.int64)
            inside = torch.ones_like(pos, dtype=torch.bool)
        else:
            valid = rows < kv_len[:, None]
            at = torch.clamp(pos, max=s_max - 1).to(torch.int64)
            inside = pos < s_max

        def append(leaf, val):
            keep = inside.reshape((b,) + (1,) * (val.dim() - 2))
            leaf[lane, at] = torch.where(keep, val[:, 0].to(leaf.dtype), leaf[lane, at])

        with record_function("family.ring_attention") if window else _NO_RANGE:
            if quantized:
                k_new, ks_new = quantize_kv(k)
                v_new, vs_new = quantize_kv(v)
                for key, val in (("k_q", k_new), ("k_scale", ks_new), ("v_q", v_new),
                                 ("v_scale", vs_new)):
                    append(cache[key], val)
                out = _decode_gqa(q, cache["k_q"], cache["v_q"], valid, cache["k_scale"],
                                  cache["v_scale"])
            else:
                append(cache["k"], k)
                append(cache["v"], v)
                out = _decode_gqa(q, cache["k"], cache["v"], valid)
            cache["len"].copy_(kv_len)
    elif cache is None:
        if window:
            with record_function("family.ring_attention"):
                out = _local_gqa(q, k, v, window=window)
        else:
            out = _chunked_gqa(q, k, v, causal=causal, chunk=chunk, q_offset=lo,
                               remat=training)
    elif window:
        # windowed prefill into a fresh raw scratch ring: attend the
        # prompt's own K/V and keep its trailing rows (the model refuses a
        # prefill that continues the ring or lands misaligned in it:
        # models.transformer.check_prefill)
        if "k" not in cache:
            raise ValueError(
                "prefill runs against a raw (bf16) scratch cache; quantize it "
                "afterwards with models.cache.quantize_scratch"
            )
        s_max = cache["k"].shape[1]
        kw, vw = (k[:, -s_max:], v[:, -s_max:]) if s > s_max else (k, v)
        k_cache = cache["k"].clone()
        v_cache = cache["v"].clone()
        k_cache[:, :kw.shape[1]] = kw.to(k_cache.dtype)
        v_cache[:, :vw.shape[1]] = vw.to(v_cache.dtype)
        new_cache = {"k": k_cache, "v": v_cache,
                     "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
        with record_function("family.ring_attention"):
            out = _local_gqa(q, k, v, window=window)
    else:
        # prefill into a raw scratch: append at the running length (0
        # when fresh) and attend the cache's whole extent under a
        # length mask; int8 KV is made afterwards (quantize_scratch)
        if "block_table" in cache:
            raise ValueError(
                "paged caches are decode-only: prefill runs against a raw "
                "scratch cache and commits via models.paging.paged_commit"
            )
        if "k" not in cache:
            raise ValueError(
                "prefill runs against a raw (bf16) scratch cache; quantize it "
                "afterwards with models.cache.quantize_scratch"
            )
        s_max = cache["k"].shape[1]
        # a dry run's fresh scratch (meta tensors, no values) starts at 0
        off = 0 if cache["len"].is_meta else int(cache["len"][0])
        if off + s > s_max:
            raise ValueError(f"{off + s} tokens exceed the cache extent {s_max}")
        k_cache = cache["k"].clone()
        v_cache = cache["v"].clone()
        k_cache[:, off:off + s] = k.to(k_cache.dtype)
        v_cache[:, off:off + s] = v.to(v_cache.dtype)
        new_cache = {"k": k_cache, "v": v_cache, "len": cache["len"] + s}
        out = _chunked_gqa(
            q, k_cache.to(q.dtype), v_cache.to(q.dtype),
            causal=causal, chunk=chunk, q_offset=off, kv_len=off + s,
        )

    out = out.reshape(b, hi - lo, n_heads * head_dim).to(x.dtype)
    return la(params["o_proj"], out, name=f"{name}/o_proj"), new_cache
