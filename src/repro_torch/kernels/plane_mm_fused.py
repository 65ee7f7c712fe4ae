"""Fully-fused bit-serial linear: the Hopper kernel, its wrapper and its
plain PyTorch version.

Port of ``src/repro/kernels/plane_mm_fused.py::fused_plane_linear``. One
call stages the raw int8 activation as bytes, unpacks the blocked packed
weight plane words into byte digits, multiplies them on the int8 tensor
cores (two exact products per (m, n, k) at 8 Booth planes, the plane-pair
sum regrouped by its outer-product pair weights, ``kernels/bytesplit.py``)
and applies the dequant/bias/activation epilogue, writing bf16 (or the raw
int32 accumulator with no scales). The kernel source, with its design
note, is ``csrc/plane_mm_fused.cu``. Pair weights that are not the outer
product of the activation's and the weight's plane weights, and weights
packed without plane weights, take the all-pairs path: x sliced into
planes and the words unpacked on the card, ``plane_matmul``'s kernel, then
this library's epilogue kernel alone. The route is decided on the host
before any launch (:func:`bytesplit.pair_route`); no serving call reaches
the all-pairs path.

:func:`fused_plane_linear` launches a kernel for CUDA tensors and runs
:func:`fused_plane_linear_plain` for CPU tensors — the device of the
operands decides, nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core.bitplanes import WORD_BITS, PackedPlanes, unpack_planes
from repro_torch.kernels import _build, bytesplit, plane_mm
from repro_torch.kernels.bytesplit import row_tile
from repro_torch.kernels.ref import plane_matmul_ref
_ACT_CODES = {"none": 0, "silu": 1, "gelu": 2}


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu (tanh form), one rounding per operation
    x3 = x * x * x
    inner = 0.7978845608028654 * (x + 0.044715 * x3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTIVATIONS = {
    "none": lambda x: x,
    "gelu": _gelu_tanh,
    "silu": _silu,
}


def epilogue_plain(
    acc: torch.Tensor,
    a_scale: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``((acc * a_scale) * w_scale) [+ bias] -> activation -> out_dtype`` in
    float32, one rounding per operation — the kernel's epilogue order."""
    out = acc.to(torch.float32) * a_scale * w_scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    out = ACTIVATIONS[activation](out)
    return out.to(out_dtype)


def slice_activation_planes(x: torch.Tensor, a_bits: int, variant: str) -> list[torch.Tensor]:
    """Bit-slice live integer activations into int8 planes (shift/mask, as
    the kernel does on chip); Booth planes are ``b[i-1] - b[i]``."""
    u = x.to(torch.int32) & ((1 << a_bits) - 1)
    cur = [(u >> i) & 1 for i in range(a_bits)]
    if variant == "booth":
        planes = [(cur[i - 1] if i else 0) - cur[i] for i in range(a_bits)]
    else:  # sbmwc / unsigned share raw bit planes; only the weights differ
        planes = cur
    return [p.to(torch.int8) for p in planes]


def _check(x_q, packed_w, pair_weights, a_bits, gate, a_scale, bias):
    if gate and packed_w.occupancy is None:
        raise ValueError(
            "gate=True needs weight occupancy metadata; re-pack the weight "
            "operand (pack_planes computes it) or pass gate=False"
        )
    if packed_w.axis != 1:
        raise ValueError(f"expected W packed on axis 1, got {packed_w.axis}")
    if packed_w.block is None:
        raise ValueError(
            "fused_plane_linear needs blocked-layout packed weights "
            "(pack_planes(..., block=...)); the global planar layout permutes "
            "K and cannot contract against raw activations"
        )
    if x_q.dim() != 2:
        raise ValueError(f"x_q must be (M, K), got {tuple(x_q.shape)}")
    if x_q.shape[1] != packed_w.k:
        raise ValueError(
            f"K mismatch: x {tuple(x_q.shape)} vs packed weight k={packed_w.k}"
        )
    if tuple(pair_weights.shape) != (a_bits * packed_w.mag.shape[0],):
        raise ValueError("pair_weights must have shape (a_bits * P_w,)")
    if bias is not None and a_scale is None:
        raise ValueError("bias requires the epilogue (a_scale/w_scale)")


def fused_plane_linear_plain(
    x_q: torch.Tensor,
    packed_w: PackedPlanes,
    pair_weights: torch.Tensor,
    *,
    a_bits: int,
    variant: str,
    a_scale: Optional[torch.Tensor] = None,
    w_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (any device): slice,
    unpack, exact plane-pair contraction, epilogue."""
    _check(x_q, packed_w, pair_weights, a_bits, False, a_scale, bias)
    a_planes = torch.stack(slice_activation_planes(x_q, a_bits, variant))
    acc = plane_matmul_ref(a_planes, unpack_planes(packed_w), pair_weights)
    if a_scale is None:
        return acc
    m, n = acc.shape
    asc = torch.broadcast_to(a_scale.reshape(-1, 1).to(torch.float32), (m, 1))
    wsc = torch.broadcast_to(w_scale.reshape(1, -1).to(torch.float32), (1, n))
    return epilogue_plain(acc, asc, wsc, bias, activation, out_dtype)


def _vec(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.dtype == torch.float32 and t.numel() == n and t.is_contiguous():
        return t  # already n dense floats: the kernel reads it as such
    return torch.broadcast_to(t.reshape(-1).to(torch.float32), (n,)).contiguous()


def _lib():
    lib = _build.load("plane_mm_fused")
    fn = lib.fused_plane_linear_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            p, i, i,  # x, M, K
            p, p, i, i, i,  # wmag, wsign, kw, N, bkw
            p, i, i,  # plan, a_bits, au8
            p, p, p, i,  # a_scale, w_scale, bias, act
            p, i, p, p,  # out, raw, ws, adig
            i, i, i,  # ksplit, bm, vec4
            p,  # stream
        ]
        fn.restype = ctypes.c_int
        ep = lib.fused_epilogue_launch
        ep.argtypes = [p, i, i, p, p, p, i, p, p]  # acc, M, N, scales, bias, act, out, stream
        ep.restype = ctypes.c_int
    return fn, lib.fused_epilogue_launch


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_plane_linear(
    x_q: torch.Tensor,
    packed_w: PackedPlanes,
    pair_weights: torch.Tensor,
    *,
    a_bits: int,
    variant: str,
    a_scale: Optional[torch.Tensor] = None,
    w_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
    bm: Optional[int] = None,
    gate: bool = False,
    k_split: Optional[int] = None,
) -> torch.Tensor:
    """Fused bit-serial linear: quantized matmul + dequant epilogue.

    ``x_q`` (M, K) int8 in natural K order; ``packed_w`` blocked-layout
    words (P_w, KW, N) packed on axis 1; ``pair_weights`` (a_bits*P_w,)
    int32, any values. When it is the wrapped outer product of the
    activation planes' weights (``plane_weights(a_bits, variant)``) and
    ``packed_w.weights`` the fused kernel runs; otherwise, and for weights
    packed without plane weights, the all-pairs path runs (slice, unpack,
    ``plane_mm.plane_matmul``, then the fused library's epilogue kernel) —
    outside the serving path, which always passes the outer product. The
    route is decided on the host before any launch
    (:func:`bytesplit.pair_route`: no read-back for a pw that
    ``ops._pair_weights`` built, which must not be written; any other pw
    is read back on every call); ``launches`` counts the calls that
    launch this library's kernels (the all-pairs path's plane product is
    counted by ``plane_matmul``). With ``a_scale``/``w_scale`` the
    epilogue runs and the result is bf16; without, the raw int32
    accumulator comes back. ``gate`` (occupancy-gated pairs) gives the same
    result; the kernel reads every word. ``bm`` (the row tile) and
    ``k_split`` (the ranges the K chunks split into) choose the launch's
    geometry, never its result; None takes :func:`bytesplit.row_tile` /
    :func:`bytesplit.k_split`. CPU tensors run the plain version; CUDA
    tensors launch a kernel, and arguments it does not take raise.
    """
    bytesplit.checked_k_split(k_split)
    if not x_q.is_cuda:
        return fused_plane_linear_plain(
            x_q, packed_w, pair_weights, a_bits=a_bits, variant=variant,
            a_scale=a_scale, w_scale=w_scale, bias=bias, activation=activation,
            out_dtype=out_dtype,
        )
    _check(x_q, packed_w, pair_weights, a_bits, gate, a_scale, bias)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a_scale is not None and out_dtype != torch.bfloat16:
        raise ValueError(f"the kernel's epilogue writes bfloat16, got {out_dtype}")
    if not 1 <= a_bits <= 8:
        raise ValueError(f"the kernel takes a_bits in [1, 8], got {a_bits}")
    dev = x_q.device
    tensors = [x_q, packed_w.mag, pair_weights]
    if packed_w.sign is not None:
        tensors.append(packed_w.sign)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands must share one device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be int8, got {x_q.dtype}")
    if packed_w.mag.dtype != torch.int32 or (
        packed_w.sign is not None and packed_w.sign.dtype != torch.int32
    ):
        raise ValueError("packed words must be int32")
    if pair_weights.dtype != torch.int32:
        raise ValueError(f"pair_weights must be int32, got {pair_weights.dtype}")
    m, k = x_q.shape
    _, kw, n = packed_w.mag.shape
    if packed_w.sign is not None and packed_w.sign.shape != packed_w.mag.shape:
        raise ValueError("sign words must match the magnitude words' shape")
    raw = a_scale is None
    asc = None if raw else _vec(a_scale, m)
    wsc = None if raw else _vec(w_scale, n)
    bia = None if bias is None else _vec(bias, n)
    for t in (asc, wsc, bia):
        if t is not None and t.device != dev:
            raise ValueError("scales and bias must be on the operands' device")
    main, epilogue = _lib()
    wa = bp.plane_weights(a_bits, variant)
    if bytesplit.pair_route(pair_weights, wa, packed_w.weights, a_bits,
                            packed_w.mag.shape[0]) == bytesplit.ALL_PAIRS:
        acc = plane_mm.plane_matmul(torch.stack(slice_activation_planes(x_q, a_bits, variant)),
                                    unpack_planes(packed_w).contiguous(), pair_weights, bm=bm,
                                    k_split=k_split)
        if raw:
            return acc
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        fused_plane_linear.launches += 1
        err = epilogue(_ptr(acc), m, n, _ptr(asc), _ptr(wsc), _ptr(bia), _ACT_CODES[activation],
                       _ptr(out), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_plane_linear epilogue launch failed: CUDA error {err}")
        return out
    # the pair weights' factors, from the plane weights
    plan = bytesplit.digit_plan(wa, tuple(packed_w.weights), packed_w.sign is not None, 1)
    tile = row_tile(m, bm)
    ksplit = k_split or bytesplit.k_split(m, n, -(-kw // bytesplit.CHUNK_WORDS), tile,
                                          bytesplit._sm_count(dev))
    out = torch.empty((m, n), dtype=torch.int32 if raw else torch.bfloat16, device=dev)
    ws = torch.empty((m, n), dtype=torch.int32, device=dev) if ksplit > 1 else None
    adig = torch.empty((m, bytesplit.padded_words(kw) * WORD_BITS), dtype=torch.uint8, device=dev)
    fused_plane_linear.launches += 1
    err = main(
        _ptr(x_q), m, k,
        _ptr(packed_w.mag), _ptr(packed_w.sign), kw, n, packed_w.block // WORD_BITS,
        ctypes.addressof(plan), a_bits, int(variant == "unsigned"),
        _ptr(asc), _ptr(wsc), _ptr(bia), _ACT_CODES[activation],
        _ptr(out), int(raw), _ptr(ws), _ptr(adig),
        ksplit, tile, int(bytesplit.vec4_ok(n, packed_w.mag, packed_w.sign)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_plane_linear launch failed: CUDA error {err}")
    return out


fused_plane_linear.launches = 0
