"""InternVL2-2B — InternViT frontend (stub) + InternLM2-1.8B LM backbone
[arXiv:2404.16821]. 256 patch embeddings prepended to the text sequence.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1000000.0,
    frontend="vision",
    frontend_dim=1024,
    num_patches=256,
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    frontend_dim=64,
    num_patches=8,
)
