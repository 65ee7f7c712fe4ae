"""IBM Granite-3 8B — dense GQA [hf:ibm-granite/granite-3.0]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
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
