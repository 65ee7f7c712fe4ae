"""Rotary position embeddings (RoPE), computed in float32."""

from __future__ import annotations

import torch

_FREQS: dict = {}


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """The (head_dim / 2,) inverse frequencies, built once per (head_dim,
    theta, device): the decode step calls this every layer, and building
    them there would copy ``theta`` from the host each time (a copy a CUDA
    graph cannot capture). Never written."""
    key = (head_dim, float(theta), str(torch.device(device or "cpu")))
    freqs = _FREQS.get(key)
    if freqs is None:
        exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
        base = torch.tensor(theta, dtype=torch.float32, device=device)
        freqs = _FREQS[key] = 1.0 / torch.pow(base, exponent)
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int absolute."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
