"""The dense decoder: embedding, a stack of pre-norm attention+MLP blocks,
final norm and LM head.

Parameters are a plain dictionary, ``{"embed", "final_norm", "lm_head",
"layers": [block, ...]}``; the reference stacks its scanned layers on a
leading axis instead, and :func:`params_from_numpy` unstacks them. Layer
names are the reference's: ``layers/dense/...`` for a scanned stack (every
layer), ``layers/<i>/dense/...`` when ``cfg.scan_layers`` is False, and
``lm_head`` — so a :class:`PrecisionPolicy` regex matches the same layers
in both packages. The stack runs as a Python loop.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import integrity
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.layers.attention import attention_apply, attention_init
from repro_torch.layers.embedding import (
    embedding_apply,
    embedding_init,
    lm_head_apply,
    lm_head_init,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.models.config import ModelConfig


def _init_block(gen, cfg: ModelConfig, kind: str, device):
    if kind not in ("dense", "attn"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model
    return {
        "attn_norm": rmsnorm_init(d, device),
        "attn": attention_init(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, cfg.qk_norm, device
        ),
        "mlp_norm": rmsnorm_init(d, device),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.act, cfg.dtype, device),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's distributions (normal
    weights scaled by 1/sqrt(fan-in), embedding by 1/sqrt(d_model), unit
    norm scales), drawn from ``gen`` on ``device``."""
    params = {
        "embed": embedding_init(gen, cfg.vocab_padded, cfg.d_model, cfg.dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(gen, cfg.d_model, cfg.vocab_padded, cfg.dtype, device)
    params["layers"] = [_init_block(gen, cfg, kind, device) for kind in cfg.layer_kinds()]
    return params


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16:  # bf16 bit pattern
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """The reference's ``init_params`` tree, as numpy arrays (bf16 passed
    as ``uint16`` views), converted to the port's parameters. Scanned
    layers stacked under ``periods/b0_<kind>`` on a leading axis are
    unstacked into the port's layer list, which takes the stack's place:
    the keys keep the reference tree's order, so a walk over both trees
    (the fault injector's) meets the same leaves in the same order."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_torch(node, device)

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i].contiguous()

    if tree.get("tail"):
        raise NotImplementedError("period tails are not ported yet")
    out = {}
    for k, v in tree.items():
        if k == "tail":
            continue
        if k == "periods":
            stacked = conv(v[f"b0_{cfg.layer_kinds()[0]}"])
            out["layers"] = [take(stacked, i) for i in range(cfg.n_layers)]
        else:
            out[k] = conv(v)
    return out


def _apply_block(cfg, kind, params, x, positions, *, policy, backend, name, cache=None):
    h = rmsnorm_apply(params["attn_norm"], x)
    attn_out, new_cache = attention_apply(
        params["attn"], h, positions,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        causal=cfg.causal, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        chunk=cfg.attn_chunk, policy=policy, backend=backend, name=f"{name}/attn",
        cache=cache,
    )
    x_f32 = x.to(torch.float32) + attn_out.to(torch.float32)
    x = x + attn_out
    # the norm's statistics read the unrounded residual sum, as the
    # reference's fused graph does (see rmsnorm_apply)
    h = rmsnorm_apply(params["mlp_norm"], x, x_f32=x_f32)
    x = x + mlp_apply(
        params["mlp"], h, act=cfg.act, policy=policy, backend=backend, name=f"{name}/mlp"
    )
    return x, new_cache


def forward(
    cfg: ModelConfig,
    params,
    batch,
    *,
    policy: Optional[PrecisionPolicy] = None,
    cache=None,
    last_only: bool = False,
    backend: str = "auto",
):
    """Returns (logits, aux_loss, new_cache). ``batch = {"tokens": (B, S)}``;
    with a cache, S == 1 decodes at each slot's own position, updating the
    cache in place and returning it, and S > 1 prefills from the running
    per-slot offset into a new cache. The cache's layer blocks
    are dense (``models.cache``) or paged (``models.paging``: page pools,
    block table, length; decode only), passed to each layer's attention. ``last_only`` computes the
    LM head for the final position only. ``backend`` picks the matmul
    kernels ("auto": the Hopper kernels for CUDA tensors)."""
    policy = policy or PrecisionPolicy.off()
    tokens = batch["tokens"]
    x = embedding_apply(params["embed"], tokens)
    b, s = x.shape[:2]
    dev = x.device
    if cache is not None and s == 1:
        positions = cache["step"][:, None].to(torch.int32)
    elif cache is not None:
        positions = cache["step"][:, None].to(torch.int32) + torch.arange(
            s, dtype=torch.int32, device=dev
        )[None, :]
    else:
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)

    new_layers = []
    # a scanned stack reports its ABFT checks as one folded flag, as the
    # reference's lax.scan body does; an unrolled stack reports each
    stack = integrity.scan_scope() if cfg.scan_layers else contextlib.nullcontext()
    with stack:
        for i, (kind, blk) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
            name = f"layers/{kind}" if cfg.scan_layers else f"layers/{i}/{kind}"
            blk_cache = cache["layers"][i] if cache is not None else None
            x, nc = _apply_block(
                cfg, kind, blk, x, positions, policy=policy, backend=backend, name=name,
                cache=blk_cache,
            )
            new_layers.append(nc)
    new_cache = None
    if cache is not None and s == 1:  # decode: the layers updated ``cache`` in place
        cache["step"].add_(1)
        new_cache = cache
    elif cache is not None:
        new_cache = {"step": cache["step"] + s, "layers": new_layers}

    if last_only:
        x = x[:, -1:]
    x = rmsnorm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x.to(torch.float32) @ params["embed"]["embedding"].to(torch.float32).T
    else:
        logits = lm_head_apply(params["lm_head"], x, policy=policy, backend=backend)
    return logits, torch.zeros((), dtype=torch.float32, device=dev), new_cache
