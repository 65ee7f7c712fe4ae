"""Symmetric integer quantization.

Weights are quantized per output channel, activations dynamically per
token. The arithmetic repeats the reference's: divide by the scale (not
multiply by its reciprocal, which would round differently), round half
to even, clip.

The scale itself is ``amax / qmax``. Inside the reference's compiled
serving steps XLA folds that division by a constant into a multiply by
``float32(1 / qmax)``, which rounds differently in about 5% of rows;
``reciprocal_scale=True`` reproduces it (activations quantized per token
during serving), the default divides (weights quantized at load, which
the reference runs eagerly).

:func:`fake_quant` is the quantization-aware-training form: quantize and
dequantize in one pass, with a straight-through gradient through the
rounding.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.bitplanes import signed_range


class Quantized(NamedTuple):
    values: torch.Tensor  # int8 (bits <= 8) or int32
    scale: torch.Tensor  # float32, broadcastable against ``values``
    bits: int


def _qmax(bits: int) -> int:
    _, hi = signed_range(bits)
    return max(hi, 1)


@functools.lru_cache(maxsize=None)
def _recip(qmax: int) -> torch.Tensor:
    """float32(1 / qmax) as a 0-dim host tensor (a scalar operand on any
    device), built once: a tensor built from host data per call is a copy
    a CUDA graph cannot capture. Never written."""
    return torch.tensor(1.0 / qmax, dtype=torch.float32)


def quantize(x: torch.Tensor, bits: int, axis=None, *, reciprocal_scale: bool = False,
             amax: torch.Tensor | None = None) -> Quantized:
    """Symmetric quantization of ``x`` to ``bits``-bit integers.

    ``axis``: axis to *reduce* for the scale (None = per tensor); for a
    ``(K, N)`` weight ``axis=0`` (or -2) gives per-output-channel scales,
    for ``(..., K)`` activations ``axis=-1`` gives per-token scales.

    ``amax``: a precomputed |x| maximum, broadcastable against ``x``, in
    place of the local reduction. The row-parallel projections pass the
    maximum over every rank's slice of a K-sharded activation
    (:meth:`~repro_torch.sharding.tp.TPContext.global_amax`), so each rank
    quantizes its slice with the scale of the whole row.
    """
    qmax = _qmax(bits)
    if amax is None:
        amax = x.abs().amax() if axis is None else x.abs().amax(dim=axis, keepdim=True)
    amax = torch.clamp_min(amax, 1e-8).to(torch.float32)
    if reciprocal_scale:
        scale = amax * _recip(qmax)
    else:
        scale = amax / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1 if bits > 1 else 0, qmax)
    store_dtype = torch.int8 if bits <= 8 else torch.int32
    return Quantized(q.to(store_dtype), scale, bits)


class _SteRound(torch.autograd.Function):
    """Round half to even; the gradient passes through unchanged (the
    reference's ``_ste_round`` custom VJP)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor, bits, axis=None, amax_reduce=None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT).

    The forward emits the values the bit-serial inference path computes
    with; the backward passes the gradient through the rounding and keeps
    the clip's. The scale is ``amax / qmax`` with ``amax`` detached (the
    reference's ``stop_gradient``). The clip is ``minimum(maximum(v, lo),
    hi)`` on tensor bounds: like ``jnp.clip`` it gives half the gradient
    to a value equal to a bound (``torch.clamp`` would give all of it), and
    a row's maximum lands exactly on ``qmax``. The gradient then reads
    ``(g * scale) / scale``, as the reference's does. The scale is
    ``amax * float32(1 / qmax)``, as the reference's compiled train step
    computes it (see :func:`quantize`).

    ``amax_reduce``: applied to the amax before the scale is taken (a
    row-parallel operand's maximum over the ranks holding the rest of its
    reduced axis, so every block quantizes with the whole's scale)."""
    if bits is None:
        return x
    qmax = _qmax(bits)
    xd = x.detach()
    amax = xd.abs().amax() if axis is None else xd.abs().amax(dim=axis, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = torch.clamp_min(amax, 1e-8) * _recip(qmax).to(amax.dtype)
    lo_v = -qmax - 1 if bits > 1 else 0
    if not (torch.is_grad_enabled() and x.requires_grad):
        # no gradient: the same values from scalar bounds, no tensor built
        # from host data (a CUDA graph captures this form), in place on one
        # temporary (an MoE layer's expert stack is gigabytes)
        q = x / scale
        return q.round_().clamp_(lo_v, qmax).mul_(scale).to(x.dtype)
    lo = torch.tensor(lo_v, dtype=x.dtype, device=x.device)
    hi = torch.tensor(qmax, dtype=x.dtype, device=x.device)
    q = torch.minimum(torch.maximum(_SteRound.apply(x / scale), lo), hi)
    return (q * scale).to(x.dtype)


def dequantize(q: Quantized) -> torch.Tensor:
    """``values * scale`` in float32."""
    return q.values.to(torch.float32) * q.scale


def quantization_error(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """RMS relative error of the symmetric quantizer at ``bits``: the
    accuracy-against-bits trade-off the precision dial moves along."""
    q = quantize(x, bits, axis=axis)
    err = dequantize(q) - x
    return torch.sqrt(torch.mean(err**2)) / (torch.sqrt(torch.mean(x**2)) + 1e-12)
