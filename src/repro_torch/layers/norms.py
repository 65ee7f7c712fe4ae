"""RMSNorm and LayerNorm with float32 statistics (the reference's
operation order)."""

from __future__ import annotations

import torch


def rmsnorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6, *, x_f32=None) -> torch.Tensor:
    """Statistics in f32; the normalizer is cast to x's dtype and the two
    (..., d)-shaped products run in x's dtype, as in the reference.

    ``x_f32``: x's value before its rounding to x's dtype, when the caller
    has it (a residual sum). The reference's compiled graph (XLA with
    excess precision allowed) computes the statistics of a fused
    ``rmsnorm(a + b)`` from the unrounded sum; passing it here repeats
    that, so the normalized activations agree bit for bit."""
    xf = x.to(torch.float32) if x_f32 is None else x_f32
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.reciprocal(torch.sqrt(var + eps)).to(x.dtype)
    return (x * inv) * params["scale"].to(x.dtype)


def layernorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and (biased) variance in float32, normalized, scaled and
    shifted in float32, then one cast to x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps)) * params["scale"] + params["bias"]
    return out.to(x.dtype)
