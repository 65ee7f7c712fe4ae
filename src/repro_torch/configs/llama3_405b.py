"""Llama-3 405B — dense GQA, 128k vocab [arXiv:2407.21783]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    act="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
)
