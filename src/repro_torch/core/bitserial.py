"""The plain bit-serial contraction: ``A @ W = sum_{i,j} w_i w_j (A_i @ W_j)``
over the planes of :mod:`repro_torch.core.bitplanes`, in exact int32
arithmetic with wraparound (the reference's ``_plane_pair_scan``).

Integer accumulation is modular, so plane weights are wrapped into int32
first (:func:`_wrap_weights`): e.g. Booth's redundant third digit pair has
weight 2^32 = 0 (mod 2^32) and its contribution vanishes, exactly as in
the reference.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes as bp


def _wrap_weights(ws, accum_dtype=torch.int32, device=None) -> torch.Tensor:
    """Wrap Python-int plane weights into the (integer) accumulator dtype."""
    if not accum_dtype.is_floating_point:
        width = torch.iinfo(accum_dtype).bits
        half = 1 << (width - 1)
        ws = [((int(w) + half) % (1 << width)) - half for w in ws]
    return torch.tensor(ws, dtype=accum_dtype, device=device)


def _plane_pair_scan(dec_a: bp.PlaneDecomposition, dec_w: bp.PlaneDecomposition) -> torch.Tensor:
    """sum_{i,j} w_i w_j (A_i @ W_j) in int32 — planes ``(P_a, ..., K)`` and
    ``(P_w, K, N)``; leading activation dims are kept."""
    from repro_torch.kernels.ref import plane_matmul_ref

    pair_w = _wrap_weights(
        [wa * ww for wa in dec_a.weights for ww in dec_w.weights],
        device=dec_a.planes.device,
    )
    a = dec_a.planes
    lead = a.shape[1:-1]
    a2 = a.reshape(a.shape[0], -1, a.shape[-1])
    out = plane_matmul_ref(a2, dec_w.planes, pair_w)
    return out.reshape(lead + (out.shape[-1],))


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
) -> torch.Tensor:
    """Exact int32 matmul of quantized operands via plane decomposition
    (the oracle route; ``a`` is ``(..., K)``, ``w`` is ``(K, N)``)."""
    if a.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(w.shape)}")
    if mode != "fully_serial":
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    if level == "bitplane":
        dec_a = bp.to_bitplanes(a, a_bits, variant)
        dec_w = bp.to_bitplanes(w, w_bits, variant)
    elif level == "digit":
        dec_a = bp.to_digits(a, a_bits, variant, radix_bits)
        dec_w = bp.to_digits(w, w_bits, variant, radix_bits)
    else:
        raise ValueError(f"unknown level {level!r}")
    return _plane_pair_scan(dec_a, dec_w)
