"""Llama-4 Scout 17B-A (16 experts, top-1) [hf:meta-llama/Llama-4-Scout-17B-16E].

Treated as a pure-LM MoE per the assignment (the early-fusion vision path
is out of scope for this entry); full attention -> long_500k skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    moe_d_ff=8192,
    n_experts=16,
    top_k=1,
    vocab_size=202048,
    rope_theta=500000.0,
    # top-1 routing: 2x-uniform capacity bounds the EP dispatch buffers
    moe_capacity_factor=2.0,
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    moe_d_ff=128,
    n_experts=4,
    top_k=1,
    vocab_size=512,
)
