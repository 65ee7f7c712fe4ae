"""Mamba2-1.3B — attention-free SSD (state-space duality) [arXiv:2405.21060].

d_inner = 2*d_model, head_dim P=64 -> 64 SSD heads, state N=128, conv 4.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab_size=50280,
    d_ff=0,
    ssm_d_inner=4096,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_state=128,
    conv_width=4,
    ssd_chunk=256,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    ssm_d_inner=128,
    ssm_heads=4,
    ssm_head_dim=32,
    ssm_state=16,
    ssd_chunk=8,
    vocab_size=512,
)
