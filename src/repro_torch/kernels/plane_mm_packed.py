"""Packed plane-pair matrix multiplication: the Hopper kernel, its wrapper
and its plain PyTorch version.

Port of ``src/repro/kernels/plane_mm_packed.py::plane_matmul_packed``:
both operands arrive as packed plane words, A ``(P_a, M, KW)`` packed on
axis 2 and W ``(P_w, KW, N)`` packed on axis 1 (optional Booth sign words
of the same shapes), and the result is
``sum_{i,j} pw[i*P_w+j] * (A_i @ W_j)`` exactly in int32. Both operands
must share one word layout (global planar or blocked); the contraction
runs over (word, bit) pairs, so neither side is un-permuted. The kernel
regroups the plane pairs by their outer-product pair weights into byte
digits of A and W and multiplies those on the int8 tensor cores
(``kernels/bytesplit.py``); its source, with its design note, is
``csrc/plane_mm_packed.cu``. Pair weights that are not that outer product,
and operands packed without plane weights, take the all-pairs path: both
operands unpacked to int8 planes on the card, then ``plane_matmul``'s
kernel (exact for any pw). The route is decided on the host before any
launch (:func:`bytesplit.pair_route`); no serving call reaches the
all-pairs path, since every plan executor passes the outer product.

:func:`plane_matmul_packed` launches a kernel for CUDA tensors and runs
:func:`plane_matmul_packed_plain` for CPU tensors — the operands' device
decides, nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.bitplanes import WORD_BITS, PackedPlanes, occupancy_per_tile, unpack_planes
from repro_torch.kernels import _build, bytesplit, plane_mm
from repro_torch.kernels.bytesplit import CHUNK_WORDS, _sm_count, row_tile
from repro_torch.kernels.ref import plane_matmul_ref


def validate_packed_operands(
    packed_a: PackedPlanes, packed_w: PackedPlanes, pair_weights: torch.Tensor
) -> None:
    """Operand checks shared by the kernel and the plain version, so the
    contract errors do not depend on the device."""
    if packed_a.axis != 2 or packed_w.axis != 1:
        raise ValueError(
            f"expected A packed on axis 2 and W on axis 1, got "
            f"{packed_a.axis} / {packed_w.axis}"
        )
    if packed_a.k != packed_w.k or packed_a.n_words != packed_w.n_words:
        raise ValueError(
            f"operands packed against different K: "
            f"{packed_a.k}/{packed_a.n_words} vs {packed_w.k}/{packed_w.n_words}"
        )
    if packed_a.block != packed_w.block:
        # a shared word layout contracts matching K subsets per word slice;
        # a global-planar operand against a blocked one would not
        raise ValueError(
            f"operands packed with different layouts: block="
            f"{packed_a.block} vs {packed_w.block}"
        )
    n_a = packed_a.mag.shape[0]
    n_w = packed_w.mag.shape[0]
    if tuple(pair_weights.shape) != (n_a * n_w,):
        raise ValueError("pair_weights must have shape (P_a * P_w,)")


def plane_matmul_packed_plain(
    packed_a: PackedPlanes, packed_w: PackedPlanes, pair_weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version (any device): unpack both operands, then the
    exact plane-pair contraction."""
    validate_packed_operands(packed_a, packed_w, pair_weights)
    return plane_matmul_ref(unpack_planes(packed_a), unpack_planes(packed_w), pair_weights)


def _lib():
    fn = _build.load("plane_mm_packed").plane_matmul_packed_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            p, p, i, i,  # amag, asign, n_a, M
            p, p, i, i,  # wmag, wsign, kw, N
            p, p, i,  # plan, wocc, gate
            p, p, i, i, i,  # out, adig, ksplit, bm, vec4
            p,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def plane_matmul_packed(
    packed_a: PackedPlanes,
    packed_w: PackedPlanes,
    pair_weights: torch.Tensor,
    *,
    bm: Optional[int] = None,
    gate: bool = False,
    k_split: Optional[int] = None,
) -> torch.Tensor:
    """sum_{i,j} pair_weights[i*P_w+j] * (A_i @ W_j) as (M, N) int32 from
    packed planes, for any int32 pair weights. When ``pair_weights`` is the
    wrapped outer product of the operands' plane weights (``weights``, as
    ``pack_decomposition`` records them) the byte-split kernel runs and
    counts a launch; otherwise, and for operands packed without weights,
    the all-pairs path runs (unpack, ``plane_mm.plane_matmul``, which
    counts its own launch) — outside the serving path, which always passes
    the outer product. The route is decided on the host before any launch
    (:func:`bytesplit.pair_route`: no read-back for a pw that
    ``ops._pair_weights`` built, which must not be written; any other pw
    is read back on every call). ``gate`` skips weight tiles the pack-time
    occupancy marks zero, with a bit-identical result. ``bm`` (the row
    tile) and ``k_split`` (the ranges the K chunks split into) choose the
    launch's geometry, never its result; None takes
    :func:`bytesplit.row_tile` / :func:`bytesplit.k_split`. CPU tensors run
    the plain version; CUDA tensors launch a kernel, and arguments it does
    not take raise."""
    if gate and packed_w.occupancy is None:
        raise ValueError(
            "gate=True needs weight occupancy metadata; re-pack the weight "
            "operand (pack_planes computes it) or pass gate=False"
        )
    bytesplit.checked_k_split(k_split)
    if not packed_a.mag.is_cuda:
        return plane_matmul_packed_plain(packed_a, packed_w, pair_weights)
    validate_packed_operands(packed_a, packed_w, pair_weights)
    dev = packed_a.mag.device
    n_a, m, kw = packed_a.mag.shape
    n_w, _, n = packed_w.mag.shape
    for side in (packed_a, packed_w):
        if side.sign is not None and side.sign.shape != side.mag.shape:
            raise ValueError("sign words must match the magnitude words' shape")
    words = [packed_a.mag, packed_a.sign, packed_w.mag, packed_w.sign]
    for t in [*words, pair_weights]:
        if t is not None and (t.device != dev or t.dtype != torch.int32):
            raise ValueError(
                f"packed words and pair_weights must be int32 on {dev}, got "
                f"{t.dtype} on {t.device}"
            )
    # the words of one call are packed per call (A) or sliced from the cache
    # (truncated tiers): make them dense row-major, as the kernel indexes them
    am, asg, wm, wsg = (None if t is None else t.contiguous() for t in words)
    if bytesplit.pair_route(pair_weights, packed_a.weights, packed_w.weights, n_a,
                            n_w) == bytesplit.ALL_PAIRS:
        return plane_mm.plane_matmul(unpack_planes(packed_a).contiguous(),
                                     unpack_planes(packed_w).contiguous(),
                                     pair_weights.contiguous(), bm=bm, k_split=k_split)
    occ = None
    if gate:
        if packed_w.occupancy.device != dev:
            raise ValueError(f"weight occupancy is on {packed_w.occupancy.device}, expected {dev}")
        occ = occupancy_per_tile(packed_w.occupancy, CHUNK_WORDS).contiguous()
    # the pair weights' factors, from the operands' plane weights
    n_ad = bytesplit.signed_byte_count(tuple(packed_a.weights), asg is not None)
    plan = bytesplit.digit_plan(tuple(packed_a.weights), tuple(packed_w.weights),
                                wsg is not None, n_ad)
    tile = row_tile(m, bm)
    ksplit = k_split or bytesplit.k_split(m, n, -(-kw // CHUNK_WORDS), tile, _sm_count(dev))
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    adig = torch.empty((n_ad, m, bytesplit.padded_words(kw) * WORD_BITS), dtype=torch.uint8,
                       device=dev)
    plane_matmul_packed.launches += 1
    err = _lib()(
        _ptr(am), _ptr(asg), n_a, m,
        _ptr(wm), _ptr(wsg), kw, n,
        ctypes.addressof(plan), _ptr(occ), int(gate),
        _ptr(out), _ptr(adig), ksplit, tile, int(bytesplit.vec4_ok(n, wm, wsg)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"plane_matmul_packed launch failed: CUDA error {err}")
    return out


plane_matmul_packed.launches = 0
