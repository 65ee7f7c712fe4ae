"""Yi-6B — llama-arch dense GQA kv=4 [arXiv:2403.04652]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5000000.0,
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
