"""Model configuration: the fields the dense decoder of this slice uses."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the only family ported so far)
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 500000.0
    causal: bool = True
    # mlp
    d_ff: int = 0
    act: str = "swiglu"
    # misc
    tie_embeddings: bool = False
    attn_chunk: int = 1024  # online-softmax KV chunk
    #: True names every layer ``layers/<kind>`` (the JAX scanned-stack
    #: names); False names them ``layers/<i>/<kind>`` for per-layer
    #: precision overrides, as the reference's unrolled stack does
    scan_layers: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the padded vocabulary the
        reference shards; samplers mask the padding columns)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    def layer_kinds(self) -> Tuple[str, ...]:
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet (dense only)"
            )
        return ("dense",) * self.n_layers
