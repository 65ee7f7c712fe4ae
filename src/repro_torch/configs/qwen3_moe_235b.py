"""Qwen3-MoE 235B-A22B — 128 experts top-8, GQA kv=4, qk-norm
[hf:Qwen/Qwen3-235B-A22B family]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    qk_norm=True,
    d_ff=0,
    moe_d_ff=1536,
    n_experts=128,
    top_k=8,
    vocab_size=151936,
    rope_theta=1000000.0,
    # production EP dispatch: bounded buffers (2x uniform load per expert);
    # dropless (cf=0) would need a T_row*k-copy buffer per device
    moe_capacity_factor=2.0,
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    moe_d_ff=64,
    n_experts=8,
    top_k=2,
    vocab_size=512,
)
