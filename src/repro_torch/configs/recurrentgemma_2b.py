"""RecurrentGemma-2B — Griffin: RG-LRU + local attention, 1:2 pattern
(two recurrent blocks per local-attention block), window 2048, MQA
[arXiv:2402.19427]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    period=("rec", "rec", "attn"),
    lru_width=2560,
    local_window=2048,
    rope_theta=10000.0,
    act="geglu",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=3,
    d_model=80,
    n_heads=2,
    n_kv_heads=1,
    head_dim=40,
    d_ff=160,
    lru_width=80,
    local_window=16,
    vocab_size=512,
)
