"""The plain bit-serial contraction: ``A @ W = sum_{i,j} w_i w_j (A_i @ W_j)``
over the planes of :mod:`repro_torch.core.bitplanes` (the reference's
``src/repro/core/bitserial.py``: its ``_plane_pair_scan`` and
``_plane_scan_serial_parallel``).

The accumulator is int32 (exact, with wraparound) or float32 (the
reference's rule beyond 8 bits):

* int32 — integer accumulation is modular, so plane weights are wrapped
  into int32 first (:func:`_wrap_weights`): Booth's redundant third digit
  pair has weight 2^32 = 0 (mod 2^32) and its contribution vanishes, as in
  the reference;
* float32 — the weights stay as they are (2^32 is a float32 like any other
  power of two). Each plane-pair product is a float32 ``torch.matmul`` (the
  reference's ``lax.dot_general`` with a float32 result; no matmul
  precision switch is set, and the operands — planes and digits — are
  exact in any float format the card may round them to), and the running
  sum adds ``pair_w * product`` in the reference's scan order, pair
  ``i * n_w + j`` with ``i`` over the activation planes. Every term is
  exact while the products are (``pair_w`` is a power of two), so the sum
  rounds exactly as the reference's does.

Modes: ``fully_serial`` decomposes both operands (the paper's design);
``serial_parallel`` decomposes only the activation and multiplies each of
its planes by the whole weight. Level ``fused`` is one product of the
undecomposed operands.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes as bp


def _wrap_weights(ws, accum_dtype=torch.int32, device=None) -> torch.Tensor:
    """Plane weights as a tensor of the accumulator dtype, wrapped modulo
    2^width when it is an integer type."""
    return torch.tensor(_wrapped(ws, accum_dtype), dtype=accum_dtype, device=device)


def _wrapped(ws, accum_dtype) -> list:
    if accum_dtype.is_floating_point:
        return [float(w) for w in ws]
    width = torch.iinfo(accum_dtype).bits
    half = 1 << (width - 1)
    return [((int(w) + half) % (1 << width)) - half for w in ws]


def _int32_wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _dot(a: torch.Tensor, b: torch.Tensor, accum_dtype) -> torch.Tensor:
    """``a (..., K) @ b (K, N)`` of integer operands in the accumulator
    dtype: float32 is a float32 matmul; int32 is exact modulo 2^32 (a
    float64 product, exact while ``K * max|a| * max|b| < 2^53``, as it is
    for every 16-bit operand, then wrapped)."""
    if accum_dtype == torch.float32:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    prod = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return _int32_wrap(prod.to(torch.int64))


def _plane_pair_scan(dec_a: bp.PlaneDecomposition, dec_w: bp.PlaneDecomposition,
                     accum_dtype=torch.int32) -> torch.Tensor:
    """sum_{i,j} w_i w_j (A_i @ W_j) — planes ``(P_a, ..., K)`` and
    ``(P_w, K, N)``; leading activation dims are kept."""
    a = dec_a.planes
    lead = a.shape[1:-1]
    a2 = a.reshape(a.shape[0], -1, a.shape[-1])
    if accum_dtype == torch.float32:
        out = _pair_scan_f32(a2, dec_w.planes,
                             _wrapped([wa * ww for wa in dec_a.weights for ww in dec_w.weights],
                                      accum_dtype))
    else:
        from repro_torch.kernels.ref import plane_matmul_ref

        pair_w = _wrap_weights(
            [wa * ww for wa in dec_a.weights for ww in dec_w.weights],
            device=a.device,
        )
        out = plane_matmul_ref(a2, dec_w.planes, pair_w)
    return out.reshape(lead + (out.shape[-1],))


def _pair_scan_f32(a_planes: torch.Tensor, w_planes: torch.Tensor, pair_w: list) -> torch.Tensor:
    """The float32 scan over plane pairs, ``a_planes`` (P_a, M, K) and
    ``w_planes`` (P_w, K, N): each weight plane is multiplied by every
    activation plane at once (one matmul per weight plane), then the
    products are summed in the reference's pair order. No value is read
    back and no tensor is built from host data, so a CUDA graph captures
    it."""
    n_a, m, k = a_planes.shape
    n_w, _, n = w_planes.shape
    a = a_planes.to(torch.float32).reshape(n_a * m, k)
    prods = [torch.matmul(a, w_planes[j].to(torch.float32)).reshape(n_a, m, n)
             for j in range(n_w)]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_planes.device)
    for i in range(n_a):
        for j in range(n_w):
            acc = acc + pair_w[i * n_w + j] * prods[j][i]
    return acc


def _plane_scan_serial_parallel(dec_a: bp.PlaneDecomposition, w: torch.Tensor,
                                accum_dtype) -> torch.Tensor:
    """sum_i w_i (A_i @ W) — only the activation side is serialized."""
    weights = _wrapped(dec_a.weights, accum_dtype)
    acc = None
    for idx in range(len(weights)):
        part = _dot(dec_a.planes[idx], w, accum_dtype)
        if accum_dtype == torch.float32:
            term = weights[idx] * part
            acc = term + 0.0 if acc is None else acc + term
        else:
            term = weights[idx] * part.to(torch.int64)
            acc = term if acc is None else acc + term
    if acc is None:
        raise ValueError("no activation planes")
    return acc if accum_dtype == torch.float32 else _int32_wrap(acc)


def bitserial_matmul(
    a: torch.Tensor,
    w: torch.Tensor,
    *,
    a_bits: int,
    w_bits: int,
    variant: str = "booth",
    level: str = "digit",
    mode: str = "fully_serial",
    radix_bits: int = 8,
    accum_dtype=torch.int32,
) -> torch.Tensor:
    """Exact integer matmul of quantized operands via plane decomposition
    (the oracle route): ``a`` is ``(..., K)`` holding ``a_bits``-bit values,
    ``w`` is ``(K, N)`` with ``w_bits``-bit values; returns ``(..., N)`` in
    ``accum_dtype`` (int32 or float32)."""
    if a.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(w.shape)}")
    if accum_dtype not in (torch.int32, torch.float32):
        raise ValueError(f"accum_dtype must be int32 or float32, got {accum_dtype}")
    if mode not in ("fully_serial", "serial_parallel"):
        raise ValueError(f"unknown mode {mode!r}")
    if level == "fused":
        if max(a_bits, w_bits) <= 8:
            return _dot(a.to(torch.int8), w.to(torch.int8), accum_dtype)
        return _dot(a, w, accum_dtype)
    if level == "bitplane":
        dec_a = bp.to_bitplanes(a, a_bits, variant)
        if mode == "serial_parallel":
            return _plane_scan_serial_parallel(dec_a, w.to(torch.int32), accum_dtype)
        dec_w = bp.to_bitplanes(w, w_bits, variant)
    elif level == "digit":
        dec_a = bp.to_digits(a, a_bits, variant, radix_bits)
        if mode == "serial_parallel":
            return _plane_scan_serial_parallel(dec_a, w.to(torch.int32), accum_dtype)
        dec_w = bp.to_digits(w, w_bits, variant, radix_bits)
    else:
        raise ValueError(f"unknown level {level!r}")
    return _plane_pair_scan(dec_a, dec_w, accum_dtype)


def quantized_matmul(
    a_q: torch.Tensor,
    w_q: torch.Tensor,
    scale_a: torch.Tensor,
    scale_w: torch.Tensor,
    *,
    a_bits: int,
    w_bits: int,
    out_dtype=torch.float32,
    **kwargs,
) -> torch.Tensor:
    """Dequantized product ``(scale_a ⊗ scale_w) * (a_q @ w_q)`` through
    :func:`bitserial_matmul` (``kwargs`` are its options). ``scale_a``
    broadcasts over ``a_q``'s leading dims (per-token scales have shape
    ``a_q.shape[:-1] + (1,)``), ``scale_w`` over the output features
    (per-channel: ``(N,)``); float32, ``(acc * scale_a) * scale_w``, as the
    reference rounds it."""
    acc = bitserial_matmul(a_q, w_q, a_bits=a_bits, w_bits=w_bits, **kwargs)
    return (acc.to(torch.float32) * scale_a * scale_w).to(out_dtype)


def plane_pass_count(a_bits: int, w_bits: int, level: str, mode: str,
                     radix_bits: int = 8) -> int:
    """Plane-pair products one matmul costs at a configuration: the
    software analogue of the paper's cycle counts (the reference's, used by
    the cost model and the benchmarks)."""
    if level == "fused":
        return 1
    if level == "bitplane":
        return a_bits * (w_bits if mode == "fully_serial" else 1)
    if level == "digit":
        da = -(-a_bits // radix_bits)
        dw = -(-w_bits // radix_bits)
        # a Booth recode can add one digit; the common case is reported
        return da * (dw if mode == "fully_serial" else 1)
    raise ValueError(level)
