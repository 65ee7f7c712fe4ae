"""DeepSeek-Coder 33B — llama-arch dense GQA [arXiv:2401.14196]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
    act="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=112,
    n_heads=7,
    n_kv_heads=1,
    head_dim=16,
    d_ff=224,
    vocab_size=512,
)
