"""Dispatch over the plane-pair and flash-attention kernels.

Backends:
  * ``"cuda"``  — the hand-written Hopper kernels (CUDA tensors only);
  * ``"torch"`` — the plain PyTorch versions (any device);
  * ``"auto"``  — ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise.

``"cuda"`` for a CPU tensor raises: the kernels have no host mode.
Operands stay at their quantized storage width (int8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import bitserial as bs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import bytesplit, plane_mm, plane_mm_fused, plane_mm_packed
from repro_torch.kernels.plane_mm_fused import ACTIVATIONS, epilogue_plain
from repro_torch.kernels.ref import attention_ref, plane_matmul_ref

BACKENDS = ("auto", "cuda", "torch")

__all__ = [
    "ACTIVATIONS",
    "BACKENDS",
    "Epilogue",
    "apply_epilogue",
    "bitserial_matmul",
    "flash_attention",
    "fused_linear",
    "hopper_tiles",
    "k_chunks",
    "plane_matmul",
    "plane_matmul_packed",
    "resolve_backend",
    "tiles_legal",
]

#: plan routes whose kernel is the fused one (its K tile is the weight's
#: pack block) and those whose kernel is the packed one
FUSED_KERNELS = ("fused_cached", "fused_repack")
PACKED_KERNELS = ("cached_packed", "staged_packed")


def resolve_backend(backend: str, device=None) -> str:
    """Resolve ``"auto"`` against the operands' device; reject ``"cuda"``
    for host operands."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    is_cuda = device is not None and torch.device(device).type == "cuda"
    if backend == "auto":
        return "cuda" if is_cuda else "torch"
    if backend == "cuda" and not is_cuda:
        raise ValueError(
            "backend 'cuda' runs the Hopper kernels and needs CUDA tensors "
            f"(got device {device}); use 'torch' for the plain version"
        )
    return backend


def hopper_tiles(
    m: int,
    k: int,
    n: int,
    *,
    kernel: str,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    bk: Optional[int] = None,
    pack_block: Optional[int] = None,
) -> tuple[int, int, int]:
    """Tiles of the Hopper kernels: ``bm`` the row tile (8, 16 or 32 token
    rows), ``bn`` the output columns per CUDA block, ``bk`` the K extent one block
    iteration consumes (one chunk of packed words on the packed route,
    ``plane_matmul``'s K tile) or, on the fused routes, the weight's pack
    block (the kernel stages any block in 16-word chunks). Explicit values
    pass through and the kernels check them."""
    fused = kernel in FUSED_KERNELS
    packed = kernel in PACKED_KERNELS
    if bm is None:
        bm = bytesplit.row_tile(m)
    if bn is None:
        bn = bytesplit.COLS_PER_BLOCK
    if bk is None:
        if fused:
            bk = pack_block or min(bp.DEFAULT_BLOCK, max(128, -(-k // 128) * 128))
        elif packed:
            bk = bytesplit.CHUNK_WORDS * bp.WORD_BITS
        else:
            bk = plane_mm.K_TILE
    return bm, bn, bk


def k_chunks(kernel: str, k: int, bk: int) -> int:
    """The K chunks a route's kernel splits over (the unit of ``k_split``):
    16 packed words on the fused route (whose ``bk``, the pack block, pads
    K to whole blocks) and the packed one, ``plane_mm.K_TILE`` values on
    the plane-pair route and the plain ones."""
    if kernel in FUSED_KERNELS:
        words = -(-k // bk) * bk // bp.WORD_BITS
    elif kernel in PACKED_KERNELS:
        words = -(-k // bp.WORD_BITS)
    else:
        return -(-k // plane_mm.K_TILE)
    return -(-words // bytesplit.CHUNK_WORDS)


def tiles_legal(
    bm: int,
    bn: int,
    bk: int,
    *,
    kernel: str,
    k_split: Optional[int] = None,
    k: Optional[int] = None,
    pack_block: Optional[int] = None,
) -> bool:
    """Would the Hopper kernels of ``kernel``'s route take these tiles?

    The one predicate the autotuner's candidates and its check of a stored
    record share: ``bm`` one of the instantiated row tiles
    (``bytesplit.ROW_TILES``), ``bn`` the 128 columns of a block (four
    warps; the kernels have no other column tile), ``bk`` the route's own
    K extent (:func:`hopper_tiles`: the fused route's pack block, a whole
    number of words, given ``k`` the one its weight is packed with), and
    ``k_split`` an int in ``[1, k_chunks]`` (with ``k``; else >= 1)."""
    if bm not in bytesplit.ROW_TILES or bn != bytesplit.COLS_PER_BLOCK:
        return False
    if kernel in FUSED_KERNELS:
        if bk <= 0 or bk % bp.WORD_BITS:
            return False
        if k is not None and bk != hopper_tiles(1, k, 1, kernel=kernel,
                                                pack_block=pack_block)[2]:
            return False
    elif bk != hopper_tiles(1, k or 1, 1, kernel=kernel)[2]:
        return False
    if k_split is None:
        return True
    if isinstance(k_split, bool) or not isinstance(k_split, int) or k_split < 1:
        return False
    return k is None or k_split <= k_chunks(kernel, k, bk)


# ---------------------------------------------------------------------------
# Epilogue
# ---------------------------------------------------------------------------


class Epilogue(NamedTuple):
    """Dequant/bias/activation epilogue of a quantized linear layer.

    ``a_scale``: per-token activation scales broadcastable against the
    accumulator's leading dims (``lead + (1,)``); ``w_scale``: per-channel
    weight scales. On the fused route it runs inside the kernel; every
    other route applies the same float32 operation order with
    :func:`apply_epilogue`.
    """

    a_scale: torch.Tensor
    w_scale: torch.Tensor
    bias: Optional[torch.Tensor] = None
    activation: str = "none"
    out_dtype: torch.dtype = torch.bfloat16


def apply_epilogue(acc: torch.Tensor, ep: Epilogue) -> torch.Tensor:
    return epilogue_plain(acc, ep.a_scale, ep.w_scale, ep.bias, ep.activation, ep.out_dtype)


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------

_PAIR_WEIGHTS: dict = {}


def _pair_weights(wa: tuple, ww: tuple, device) -> torch.Tensor:
    """int32-wrapped pair weights ``wa[i] * ww[j]``, built once per
    (plane weights, device): the serving loop asks for the same few. Each
    carries its factors (:func:`bytesplit.tag_pair_weights`), so the
    tensor-core kernels take it without reading it back."""
    key = (tuple(wa), tuple(ww), str(device))
    pw = _PAIR_WEIGHTS.get(key)
    if pw is None:
        with torch.inference_mode(False):  # a version counter keeps the tag honest
            pw = bs._wrap_weights([x * y for x in wa for y in ww], device=device)
        _PAIR_WEIGHTS[key] = bytesplit.tag_pair_weights(pw, wa, ww)
    return pw


def plane_matmul(
    a_planes: torch.Tensor,
    w_planes: torch.Tensor,
    pair_weights: torch.Tensor,
    *,
    backend: str = "auto",
    bm: Optional[int] = None,
    k_split: Optional[int] = None,
) -> torch.Tensor:
    """Plane-pair matmul: the Hopper kernel or its plain version."""
    backend = resolve_backend(backend, a_planes.device)
    if backend == "torch":
        return plane_matmul_ref(a_planes, w_planes, pair_weights)
    return plane_mm.plane_matmul(a_planes, w_planes, pair_weights, bm=bm, k_split=k_split)


def plane_matmul_packed(
    packed_a: bp.PackedPlanes,
    packed_w: bp.PackedPlanes,
    pair_weights: torch.Tensor,
    *,
    backend: str = "auto",
    bm: Optional[int] = None,
    gate: bool = False,
    k_split: Optional[int] = None,
) -> torch.Tensor:
    """Packed plane matmul: the Hopper kernel or its plain version.
    ``gate`` skips all-zero plane work in the kernel (bit-identical); the
    plain version has no passes to skip and ignores it, as the
    reference's jnp oracle does."""
    backend = resolve_backend(backend, packed_a.mag.device)
    if backend == "torch":
        return plane_mm_packed.plane_matmul_packed_plain(packed_a, packed_w, pair_weights)
    return plane_mm_packed.plane_matmul_packed(
        packed_a, packed_w, pair_weights, bm=bm, gate=gate, k_split=k_split
    )


def fused_linear(
    x_q: torch.Tensor,
    packed_w: bp.PackedPlanes,
    epilogue: Optional[Epilogue],
    *,
    a_bits: int,
    variant: str,
    backend: str = "auto",
    bm: Optional[int] = None,
    gate: bool = False,
    k_split: Optional[int] = None,
) -> torch.Tensor:
    """Fully-fused bit-serial linear over 2-D quantized activations.

    ``x_q`` (M, K) int8; ``packed_w`` blocked-layout packed weight planes;
    ``epilogue`` the dequant epilogue (``None`` returns the raw int32
    accumulator). The torch backend is the kernel's plain version. The
    kernel's epilogue writes bf16: an epilogue with another ``out_dtype``
    (the encoder's float32 hidden state) takes the kernel's raw
    accumulator and the plain epilogue, in the same operation order.
    """
    backend = resolve_backend(backend, x_q.device)
    pair_w = _pair_weights(bp.plane_weights(a_bits, variant), packed_w.weights, x_q.device)
    ep = {} if epilogue is None else dict(
        a_scale=epilogue.a_scale, w_scale=epilogue.w_scale, bias=epilogue.bias,
        activation=epilogue.activation, out_dtype=epilogue.out_dtype,
    )
    if backend == "torch":
        return plane_mm_fused.fused_plane_linear_plain(
            x_q, packed_w, pair_w, a_bits=a_bits, variant=variant, **ep
        )
    if epilogue is not None and epilogue.out_dtype != torch.bfloat16:
        acc = plane_mm_fused.fused_plane_linear(
            x_q, packed_w, pair_w, a_bits=a_bits, variant=variant, bm=bm, gate=gate,
            k_split=k_split,
        )
        m, n = acc.shape
        return epilogue_plain(
            acc, torch.broadcast_to(epilogue.a_scale.reshape(-1, 1).to(torch.float32), (m, 1)),
            torch.broadcast_to(epilogue.w_scale.reshape(1, -1).to(torch.float32), (1, n)),
            epilogue.bias, epilogue.activation, epilogue.out_dtype,
        )
    return plane_mm_fused.fused_plane_linear(
        x_q, packed_w, pair_w, a_bits=a_bits, variant=variant, bm=bm, gate=gate,
        k_split=k_split, **ep
    )


def _matmul_cached(
    a2: torch.Tensor, w_planes: bp.WeightPlanes, *, a_bits: int, variant: str, level: str
) -> torch.Tensor:
    """Plain plane-pair contraction over cached weight planes (the
    reference's ``_matmul_cached_jnp``), minus the weight-side work."""
    if level == "bitplane":
        dec_a = bp.to_bitplanes(a2, a_bits, variant)
        wpl = (
            w_planes.planes
            if w_planes.planes is not None
            else bp.unpack_planes(w_planes.packed)
        )
    else:
        dec_a = bp.to_digits(a2, a_bits, variant)
        wpl = w_planes.planes
    return bs._plane_pair_scan(dec_a, bp.PlaneDecomposition(wpl, w_planes.weights))


def bitserial_matmul(
    a: torch.Tensor,
    w: torch.Tensor,
    *,
    a_bits: int,
    w_bits: int,
    variant: str = "booth",
    level: str = "digit",
    mode: str = "fully_serial",
    backend: str = "auto",
    accum_dtype=torch.int32,
    packed: Optional[bool] = None,
    w_planes: Optional[bp.WeightPlanes] = None,
    fused: Optional[bool] = None,
    epilogue: Optional[Epilogue] = None,
    **tile_kw,
) -> torch.Tensor:
    """Kernel-dispatching bit-serial matmul — the reference's **legacy
    compatibility shim** (``src/repro/kernels/ops.py::bitserial_matmul``).

    It builds (or fetches, interned by shape, precision, backend and cache
    layout) a :class:`~repro_torch.core.plan.MatmulPlan` for ``a``'s device
    and runs it, with the reference's dispatch semantics: ``packed=True``
    raises for configurations it cannot pack (digit planes, non-serial
    modes, non-int32 accumulation), ``fused=True`` for those the fused
    kernel cannot serve; ``None`` is auto, ``fused=False`` keeps the
    staged kernels and the plain epilogue; ``w_planes`` supplies the
    decompose-once cache; ``bm``/``bn``/``bk`` are requested tiles. The
    ``packed=``/``fused=``/``epilogue=`` keywords are deprecated (one
    :class:`DeprecationWarning` each per process): resolve a plan once
    with :func:`~repro_torch.core.plan.plan_for_operands` or ``make_plan``
    and call it."""
    from repro_torch.core import plan as plan_mod

    unknown = set(tile_kw) - {"bm", "bn", "bk"}
    if unknown:
        raise TypeError(
            f"bitserial_matmul got unexpected keyword argument(s) {sorted(unknown)}; "
            "tile keywords are bm/bn/bk"
        )
    for kw_name, val in (("packed", packed), ("fused", fused), ("epilogue", epilogue)):
        if val is not None:
            plan_mod._warn_deprecated(kw_name)
    plan = plan_mod.plan_for_operands(
        (a.shape, w.shape),
        a_bits=a_bits,
        w_bits=w_bits,
        variant=variant,
        level=level,
        mode=mode,
        backend=backend,
        device=a.device,
        accum_dtype=accum_dtype,
        has_epilogue=epilogue is not None,
        w_planes=w_planes,
        fused=fused,
        packed=packed,
        bm=tile_kw.get("bm"),
        bn=tile_kw.get("bn"),
        bk=tile_kw.get("bk"),
    )
    return plan(a, w, w_planes=w_planes, epilogue=epilogue)


def _pad_to(x: torch.Tensor, multiples: tuple) -> torch.Tensor:
    """Zero-pad each axis of ``x`` up to a multiple of ``multiples[i]``
    (0 leaves the axis)."""
    pads = []
    for dim, mult in zip(reversed(x.shape), reversed(multiples)):
        pads += [0, (-dim) % mult if mult else 0]
    if any(pads):
        x = torch.nn.functional.pad(x, pads)
    return x


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    backend: str = "auto",
    block_q: int = 128,
    block_k: int = 128,
    kv_lens: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Padding + dispatch wrapper over the dense flash-attention kernel.
    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D); ``kv_lens`` (B,) per-lane
    valid lengths; ``k_scale``/``v_scale`` (B, Hkv, Sk) scales of an int8
    K/V, folded into the kernel. The torch backend dequantizes K/V, casts
    them to q's dtype and runs :func:`attention_ref`, as the reference's
    jnp path does (its causal mask is aligned to the bottom right, the
    kernel's to the top left: they agree when Sq == Sk). Inside a cost
    report (``launch/cost.py``) the call is charged by its function
    (:func:`attention_cost`)."""
    from repro_torch.core.plan import charged

    return charged(
        lambda: attention_cost(q, k, v, causal=causal, kv_lens=kv_lens, k_scale=k_scale,
                               v_scale=v_scale),
        lambda: _flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, backend=backend,
                                 block_q=block_q, block_k=block_k, kv_lens=kv_lens,
                                 k_scale=k_scale, v_scale=v_scale),
        lambda: q.new_empty(q.shape),
        q.is_meta,
    )


def attention_cost(q, k, v, *, causal=True, kv_lens=None, k_scale=None, v_scale=None):
    """What one dense attention call's function needs
    (``launch/roofline.attention_call``): 4 operations per (query head,
    (query, key) pair, d) over the pairs its masks keep (causal from the
    top left; a lane's keys below its length, read back, or on meta
    tensors all of them); q, K, V and their scales read once, the output
    written once."""
    from repro_torch.launch import roofline

    b, hq, sq, d = q.shape
    sk = k.shape[2]
    lens = [sk] * b if kv_lens is None or kv_lens.is_meta else [
        min(int(n), sk) for n in kv_lens.tolist()]
    pairs = sum(roofline.attention_pairs(sq, n, causal) for n in lens)

    def nbytes(t):
        return 0 if t is None else t.numel() * t.element_size()

    n_bytes = 2 * nbytes(q) + nbytes(k) + nbytes(v) + nbytes(k_scale) + nbytes(v_scale)
    return roofline.attention_call(hq, pairs, d, n_bytes)


def _flash_attention(q, k, v, *, causal, sm_scale, backend, block_q, block_k, kv_lens,
                     k_scale, v_scale):
    backend = resolve_backend(backend, q.device)
    if backend == "torch":
        if k_scale is not None:
            k = k.to(torch.float32) * k_scale[..., None]
        if v_scale is not None:
            v = v.to(torch.float32) * v_scale[..., None]
        return attention_ref(q, k.to(q.dtype), v.to(q.dtype), causal=causal,
                             sm_scale=sm_scale, kv_lens=kv_lens)
    sq, sk = q.shape[2], k.shape[2]
    quant_kw = {}
    if k_scale is not None:
        quant_kw["k_scale"] = _pad_to(k_scale, (0, 0, block_k))
    if v_scale is not None:
        quant_kw["v_scale"] = _pad_to(v_scale, (0, 0, block_k))
    out = fa.flash_attention(
        _pad_to(q, (0, 0, block_q, 0)),
        _pad_to(k, (0, 0, block_k, 0)),
        _pad_to(v, (0, 0, block_k, 0)),
        causal=causal, sm_scale=sm_scale, block_q=block_q, block_k=block_k,
        # padded KV columns are masked out of the softmax, either by the
        # per-lane lengths or by the static unpadded length
        kv_len=None if kv_lens is not None else sk,
        kv_lens=kv_lens, **quant_kw,
    )
    return out[:, :, :sq, :]
