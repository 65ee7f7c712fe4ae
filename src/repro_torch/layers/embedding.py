"""Token embedding, the LM head, and the modality front ends: projections
of precomputed audio frame or vision patch features into the backbone's
width."""

from __future__ import annotations

import torch

from repro_torch.layers.linear import linear_apply, linear_init


def embedding_init(gen, vocab: int, d_model: int, dtype=torch.bfloat16, device=None):
    emb = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=device)
    return {"embedding": (emb * (d_model**-0.5)).to(dtype)}


def embedding_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def lm_head_init(gen, d_model: int, vocab: int, dtype=torch.bfloat16, device=None):
    return {"head": linear_init(gen, d_model, vocab, dtype, device)}


def lm_head_apply(params, x, *, policy, training=False, backend="auto", name="lm_head"):
    return linear_apply(params["head"], x, name=name, policy=policy, training=training,
                        backend=backend)


def frontend_init(gen, frontend_dim: int, d_model: int, dtype=torch.bfloat16, device=None):
    return {"proj": linear_init(gen, frontend_dim, d_model, dtype, device)}


def frontend_apply(params, feats, *, policy, training=False, backend="auto", name="frontend"):
    """``feats`` (B, S, frontend_dim), float32 as the batch gives them: a
    dense front end returns float32 (``x @ w`` in x's dtype), as the
    reference's does."""
    return linear_apply(params["proj"], feats, name=f"{name}/proj", policy=policy,
                        training=training, backend=backend)
