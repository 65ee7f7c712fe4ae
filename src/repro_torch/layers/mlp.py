"""MLP blocks: gated (SwiGLU / GeGLU) or plain (GELU); the non-linearity
rides into the gate (plain: the up) projection's epilogue (inside the
fused kernel on CUDA)."""

from __future__ import annotations

import torch

from repro_torch.layers.linear import linear_init, projection


def mlp_init(gen, d_model: int, d_ff: int, act: str = "swiglu", dtype=torch.bfloat16,
             device=None):
    if act in ("swiglu", "geglu"):
        return {
            "gate_proj": linear_init(gen, d_model, d_ff, dtype, device),
            "up_proj": linear_init(gen, d_model, d_ff, dtype, device),
            "down_proj": linear_init(gen, d_ff, d_model, dtype, device),
        }
    return {
        "up_proj": linear_init(gen, d_model, d_ff, dtype, device),
        "down_proj": linear_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_apply(params, x, *, act: str = "swiglu", policy, training=False, backend="auto",
              name="mlp"):
    la = projection(policy=policy, training=training, backend=backend)
    if act not in ("swiglu", "geglu"):
        h = la(params["up_proj"], x, name=f"{name}/up_proj", activation="gelu")
        return la(params["down_proj"], h, name=f"{name}/down_proj")
    nl = "silu" if act == "swiglu" else "gelu"
    g = la(params["gate_proj"], x, name=f"{name}/gate_proj", activation=nl)
    u = la(params["up_proj"], x, name=f"{name}/up_proj")
    # the down projection quantizes the unrounded g*u (exact in float32
    # for bf16 factors), as the reference's fused graph does
    return la(params["down_proj"], g * u, name=f"{name}/down_proj",
              x_f32=g.to(torch.float32) * u.to(torch.float32))
