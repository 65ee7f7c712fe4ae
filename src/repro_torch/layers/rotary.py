"""Rotary position embeddings (RoPE), computed in float32."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


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
