"""HuBERT X-Large — encoder-only audio transformer [arXiv:2106.07447].

Backbone only: the batch holds precomputed conv-frontend frame features
(``launch.inputs.make_batch``; the front end projects 512 -> d_model).
No decode path.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    act="gelu",
    frontend="audio",
    frontend_dim=512,
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    frontend_dim=32,
)
