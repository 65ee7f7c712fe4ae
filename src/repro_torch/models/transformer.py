"""The model stack: embedding or front end, pre-norm blocks, final norm
and LM head.

Block kinds are the reference's: ``dense`` (attention + MLP), ``moe``
(attention + mixture of experts), ``ssm`` (Mamba2 SSD), ``rec`` (RG-LRU +
MLP) and ``attn`` (the hybrid's sliding-window attention + MLP). The
audio encoder's input is ``batch["features"]`` through its front end in
place of the token embedding; the VLM puts ``batch["patches"]`` through
its front end in front of the text, and the positions count the patches.
The MoE layers' load-balancing losses are summed in layer order into
``forward``'s ``aux``. Parameters are a plain dictionary, ``{"embed"[,
"frontend"], "final_norm"[, "lm_head"], "layers": [block, ...]}``, one
block per layer in layer order; the reference stacks the layers of its
repeated periods on a leading axis and keeps the remainder as an unrolled
tail, and :func:`params_from_numpy` unstacks both into the list. Layer
names are the reference's (``ModelConfig.layer_name``): ``layers/<kind>/...``
inside a scanned period, ``layers/tail/<kind>/...`` in the tail,
``layers/<i>/<kind>/...`` when ``cfg.scan_layers`` is False, and
``lm_head`` — so a :class:`PrecisionPolicy` regex matches the same layers
in both packages. The stack runs as a Python loop.

Training (``forward(training=True)``, :func:`loss_fn`) takes the
parameters in either layout: the port's layer list, or the reference's
tree (:func:`stack_layers`), whose stacked leaves are unbound into the
layers as views, so gradients and optimizer state are those of the
reference's leaves. Each scanned period runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body; ``cfg.remat_group`` > 1 nests the checkpoints in groups of periods),
the cache-free attention recomputes each KV chunk, and an active policy
fake-quantizes every projection (QAT).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core import integrity
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_map
from repro_torch.layers.attention import attention_apply, attention_init
from repro_torch.layers.embedding import (
    embedding_apply,
    embedding_init,
    frontend_apply,
    frontend_init,
    lm_head_apply,
    lm_head_init,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.layers.rglru import rglru_apply, rglru_init
from repro_torch.layers.ssm import ssm_apply, ssm_init
from repro_torch.models.config import ModelConfig

#: kinds whose state is recurrent (no per-position KV)
RECURRENT_KINDS = ("ssm", "rec")


def _init_block(gen, cfg: ModelConfig, kind: str, device):
    d = cfg.d_model
    if kind in ("dense", "attn", "moe"):
        params = {
            "attn_norm": rmsnorm_init(d, device),
            "attn": attention_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, cfg.qk_norm,
                device,
            ),
            "mlp_norm": rmsnorm_init(d, device),
        }
        if kind == "moe":
            params["moe"] = moe_init(gen, d, cfg.moe_d_ff, cfg.n_experts, cfg.dtype, device)
        else:
            params["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.act, cfg.dtype, device)
        return params
    if kind == "ssm":
        return {
            "norm": rmsnorm_init(d, device),
            "ssm": ssm_init(
                gen, d, d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads,
                head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                conv_width=cfg.conv_width, dtype=cfg.dtype, device=device,
            ),
        }
    if kind == "rec":
        return {
            "norm": rmsnorm_init(d, device),
            "rglru": rglru_init(gen, d, cfg.lru_width, cfg.conv_width, cfg.dtype, device),
            "mlp_norm": rmsnorm_init(d, device),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.act, cfg.dtype, device),
        }
    raise ValueError(f"unknown block kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class SeededParams:
    """The parameters :func:`init_params` draws from a generator seeded
    with ``seed`` on the device they are drawn for, handed to an engine
    undrawn: a single-device engine draws the whole tree, a
    tensor-parallel rank only its shard, one part at a time
    (``sharding.tp.load_shard``)."""

    seed: int = 0

    def generator(self, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        return gen


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None, each=None) -> dict:
    """Random parameters with the reference's distributions (normal
    weights scaled by 1/sqrt(fan-in), embedding by 1/sqrt(d_model), unit
    norm scales), drawn from ``gen`` on ``device``. ``each(part, path)``:
    what is kept of each part, called as soon as the part is drawn with its
    path in the reference's tree (``/embed``, ``/frontend``,
    ``/final_norm``, ``/lm_head``, then each layer's ``cfg.param_path(i)``,
    in that order): a tensor-parallel rank keeps its shard of each
    (``sharding.tp.load_shard``), so the whole tree is never held."""
    put = (lambda t, path: t) if each is None else each
    params = {"embed": put(embedding_init(gen, cfg.vocab_padded, cfg.d_model, cfg.dtype,
                                          device), "/embed")}
    if cfg.frontend != "none":
        params["frontend"] = put(frontend_init(gen, cfg.frontend_dim, cfg.d_model, cfg.dtype,
                                               device), "/frontend")
    params["final_norm"] = put(rmsnorm_init(cfg.d_model, device), "/final_norm")
    if not cfg.tie_embeddings:
        params["lm_head"] = put(lm_head_init(gen, cfg.d_model, cfg.vocab_padded, cfg.dtype,
                                             device), "/lm_head")
    params["layers"] = [put(_init_block(gen, cfg, kind, device), cfg.param_path(i))
                        for i, kind in enumerate(cfg.layer_kinds())]
    return params


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16:  # bf16 bit pattern
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """The reference's ``init_params`` tree, as numpy arrays (bf16 passed
    as ``uint16`` views), converted to the port's parameters. The layers
    of the scanned periods, stacked under ``periods/b<j>_<kind>`` on a
    leading axis, are unstacked into the port's layer list in layer order
    and the ``tail`` blocks appended; the list takes the place of
    ``periods`` (an unrolled tree's ``layers`` list is taken as it is), so
    the keys keep the reference tree's order and a walk over both trees
    (the fault injector's) meets the leaves of a layer in the same order."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_torch(node, device)

    return unstack_layers(cfg, conv(tree))


def stack_layers(cfg: ModelConfig, params) -> dict:
    """The port's parameters as the reference's ``init_params`` tree: with
    ``cfg.scan_layers`` the layers of the whole periods stacked on a
    leading axis under ``periods/b<j>_<kind>`` and the rest kept as the
    ``tail`` list (an unrolled config's ``layers`` list is that tree
    already). The stacks are new tensors."""
    if not cfg.scan_layers or "layers" not in params:
        return params
    period, n_full = cfg.period_layout()
    plen = len(period)
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["periods"] = {
        f"b{j}_{kind}": tree_map(lambda *xs: torch.stack(xs),
                                 *[layers[i * plen + j] for i in range(n_full)])
        for j, kind in enumerate(period)
    } if n_full else {}
    out["tail"] = list(layers[n_full * plen:])
    return out


def unstack_layers(cfg: ModelConfig, tree) -> dict:
    """The reference's tree (:func:`stack_layers`) as the port's layer
    list: the layers of the periods in layer order, then the ``tail``
    blocks; the list takes the place of ``periods`` (a tree that holds a
    ``layers`` list is returned as it is). Each stacked leaf is unbound
    once into per-layer views, so the backward of a forward over the list
    stacks the layers' gradients into the stacked leaf's in one pass."""
    if "layers" in tree:
        return tree
    period, n_full = cfg.period_layout()
    unbound = [tree_map(lambda a: a.unbind(0), tree["periods"][f"b{j}_{kind}"])
               for j, kind in enumerate(period)] if n_full else []

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    layers = [take(unbound[j], i) for i in range(n_full) for j in range(len(period))]
    layers += list(tree.get("tail", []))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"the tree holds {len(layers)} layers, the config {cfg.n_layers}")
    return {("layers" if k == "periods" else k): (layers if k == "periods" else v)
            for k, v in tree.items() if k != "tail"}


def _apply_block(cfg, kind, params, x, positions, *, policy, backend, name, cache=None,
                 x_f32=None, training=False, st=None, spec=None):
    """Pre-norm residual block; returns (x, new_cache, the residual sum
    before its rounding to x's dtype, the MoE load-balancing loss or
    None). ``x_f32``: the unrounded value of ``x``, which the first norm's
    statistics read (see rmsnorm_apply). ``st`` and ``spec``: the sharded
    train step (``sharding/fsdp.ShardedTrain``) and the block's specs: ``params`` are then the
    rank's blocks, the norms and mixers gathered whole, attention, the MLP
    and the experts run tensor or expert parallel."""
    if st is not None:
        params = dict(params)
        for k in ("norm", "attn_norm", "mlp_norm"):
            if k in params:
                params[k] = st.whole(params[k], spec[k])
        for k in ("ssm", "rglru"):
            if k in params:
                params[k] = st.whole(params[k], spec[k])
    if kind == "ssm":
        h = rmsnorm_apply(params["norm"], x, x_f32=x_f32)
        out, new_cache = ssm_apply(
            params["ssm"], h, d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads,
            head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state, conv_width=cfg.conv_width,
            chunk=cfg.ssd_chunk, policy=policy, training=training, backend=backend,
            name=f"{name}/ssm", cache=cache,
        )
        return x + out, new_cache, x.to(torch.float32) + out.to(torch.float32), None
    if kind == "rec":
        h = rmsnorm_apply(params["norm"], x, x_f32=x_f32)
        out, new_cache = rglru_apply(
            params["rglru"], h, lru_width=cfg.lru_width, conv_width=cfg.conv_width,
            policy=policy, training=training, backend=backend, name=f"{name}/rglru",
            cache=cache,
        )
    else:
        h = rmsnorm_apply(params["attn_norm"], x, x_f32=x_f32)
        window = cfg.local_window if kind == "attn" else 0
        if st is not None:
            out = st.attention(params["attn"], spec["attn"], h, positions, cfg=cfg,
                               window=window, policy=policy, training=training,
                               backend=backend, name=f"{name}/attn")
            new_cache = None
        else:
            out, new_cache = attention_apply(
                params["attn"], h, positions,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                causal=cfg.causal, window=window,
                rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                chunk=cfg.attn_chunk, policy=policy, training=training, backend=backend,
                name=f"{name}/attn", cache=cache,
            )
    x_f32 = x.to(torch.float32) + out.to(torch.float32)
    x = x + out
    # the norm's statistics read the unrounded residual sum, as the
    # reference's fused graph does (see rmsnorm_apply)
    h = rmsnorm_apply(params["mlp_norm"], x, x_f32=x_f32)
    aux = None
    if kind == "moe":
        mlp_out, aux = moe_apply(
            params["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k, policy=policy,
            training=training, name=f"{name}/moe", impl=cfg.moe_impl,
            capacity_factor=cfg.moe_capacity_factor, mesh=None if st is None else st.mesh,
        )
    elif st is not None:
        mlp_out = st.mlp(params["mlp"], spec["mlp"], h, act=cfg.act, policy=policy,
                         training=training, backend=backend, name=f"{name}/mlp")
    else:
        mlp_out = mlp_apply(
            params["mlp"], h, act=cfg.act, policy=policy, training=training, backend=backend,
            name=f"{name}/mlp",
        )
    return x + mlp_out, new_cache, x.to(torch.float32) + mlp_out.to(torch.float32), aux


def check_prefill(cfg: ModelConfig, s: int, offset: int, rows: int) -> None:
    """Refuse the prefills the reference gets wrong on recurrent and
    sliding-window layers: ``s`` tokens from the running ``offset`` into a
    cache whose windowed layers keep rings of ``rows`` rows.

    * A prefill that continues a filled cache (chunked prefill): the
      reference restarts the SSD and RG-LRU states from zero on every
      multi-token call, and writes a windowed chunk at ring row 0 and
      attends only within it (reference defect E).
    * A windowed prefill longer than the ring and not a multiple of it:
      the reference stores its trailing rows unrotated, so decode then
      evicts the wrong position (reference defect F).

    The port raises a ``ValueError`` instead of copying either."""
    kinds = set(cfg.layer_kinds())
    if offset and kinds & {"ssm", "rec", "attn"}:
        raise ValueError(
            f"{cfg.name}: a prefill that continues a filled cache (chunked "
            "prefill) is refused for recurrent and sliding-window layers — the "
            "reference restarts their state from zero on every chunk and writes "
            "a windowed chunk at ring row 0 (reference defect E); prefill the "
            "whole prompt at once (prefill_chunk=0)"
        )
    if "attn" in kinds and s > rows and s % rows:
        raise ValueError(
            f"{cfg.name}: a windowed prefill of {s} tokens into a {rows}-row ring "
            "is refused: longer than the ring and not a multiple of it, the "
            "reference stores its trailing rows unrotated and decode then evicts "
            "the wrong position (reference defect F)"
        )


def forward(
    cfg: ModelConfig,
    params,
    batch,
    *,
    policy: Optional[PrecisionPolicy] = None,
    training: bool = False,
    cache=None,
    last_only: bool | int = False,
    backend: str = "auto",
    shard=None,
):
    """Returns (logits, aux_loss, new_cache). ``batch = {"tokens": (B, S)}``,
    plus ``"patches"`` (B, P, frontend_dim) for a VLM (put in front of the
    text; S counts them from here on), or ``{"features": (B, S,
    frontend_dim)}`` for the audio encoder; ``aux_loss`` is the MoE layers'
    load-balancing loss (0 without one). With a cache, S == 1 decodes at
    each slot's own position, updating the cache in place and returning
    it, and S > 1 prefills from the running per-slot offset into a new
    cache (from a fresh cache only, on a model with recurrent or
    sliding-window layers). The cache's layer blocks
    are dense (``models.cache``: KV, a KV ring, or SSM / RG-LRU state) or
    paged (``models.paging``: page pools, block table, length; decode
    only), passed to each layer. ``last_only`` computes the LM head for
    the final position only (an int ``n``: the last ``n`` positions).
    ``backend`` picks the matmul kernels ("auto": the Hopper kernels for
    CUDA tensors). ``training``: cache-free, the scanned periods
    recomputed in the backward and, under an active policy, every
    projection fake-quantized (module docstring); ``params`` may be the
    reference's tree."""
    policy = policy or PrecisionPolicy.off()
    if training and cache is not None:
        raise ValueError("training runs without a cache")
    st = shard
    if st is not None and cache is not None:
        raise ValueError("a sharded train step runs without a cache")
    specs = st.layer_specs(cfg) if st is not None else None
    params = unstack_layers(cfg, params)
    front = params.get("frontend")
    if st is not None and front is not None:
        front = st.whole(front, specs["frontend"])
    if cfg.frontend == "audio":
        x = frontend_apply(front, batch["features"], policy=policy,
                           training=training, backend=backend)
    else:
        if st is not None:
            x = st.embed(params["embed"], specs["embed"], batch["tokens"])
        else:
            x = embedding_apply(params["embed"], batch["tokens"])
        if cfg.frontend == "vision" and "patches" in batch:
            patch = frontend_apply(front, batch["patches"], policy=policy,
                                   training=training, backend=backend)
            x = torch.cat([patch.to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    dev = x.device
    if cfg.frontend == "audio":
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
    elif cache is not None and s == 1:
        positions = cache["step"][:, None].to(torch.int32)
    elif cache is not None:
        positions = cache["step"][:, None].to(torch.int32) + torch.arange(
            s, dtype=torch.int32, device=dev
        )[None, :]
    else:
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)

    kinds = cfg.layer_kinds()
    if cache is not None and s > 1 and set(kinds) & {"ssm", "rec", "attn"}:
        rows = next((blk["k"].shape[1] for k, blk in zip(kinds, cache["layers"])
                     if k == "attn" and "k" in blk), 0)
        # a dry run's fresh cache (meta tensors, no values) starts at 0
        check_prefill(cfg, s, 0 if cache["step"].is_meta else int(cache["step"].max()), rows)

    period, n_full = cfg.period_layout()
    plen = len(period)
    n_scanned = n_full * plen if cfg.scan_layers else 0
    new_layers = []

    def run(lo, hi, x, aux):
        """Layers ``lo:hi``; returns x, the last one's unrounded residual
        sum (None after a dense layer) and ``aux`` plus the MoE layers'
        losses. Each block's first norm reads its predecessor's unrounded
        sum where the reference's compiled graph fuses the two: inside one
        period of the scanned stack, and between consecutive unrolled (or
        tail) layers; the scan's carry, at a period boundary, is rounded. A dense stack
        rounds at every layer boundary, as the port always has (on an
        unrolled dense stack the reference does not: its logits differ by
        a bf16 step or two)."""
        x_f32 = None
        for i in range(lo, hi):
            blk_cache = cache["layers"][i] if cache is not None else None
            fused = (i % plen if i < n_scanned else i > lo) and kinds[i - 1] != "dense"
            x, nc, x_f32, a = _apply_block(
                cfg, kinds[i], params["layers"][i], x, positions, policy=policy,
                backend=backend, name=cfg.layer_name(i), cache=blk_cache,
                x_f32=x_f32 if fused else None, training=training,
                st=st, spec=None if specs is None else specs["layers"][i],
            )
            if a is not None:
                aux = aux + a
            if cache is not None:
                new_layers.append(nc)
        return x, x_f32 if hi > lo and kinds[hi - 1] != "dense" else None, aux

    def period_body(x, aux, p):
        x, _, aux = run(p * plen, (p + 1) * plen, x, aux)
        return x, aux

    # the scanned periods report their ABFT checks as one folded flag, as
    # the reference's lax.scan body does; the tail and an unrolled stack
    # report each
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    with integrity.scan_scope() if n_scanned else contextlib.nullcontext():
        if not (training and n_scanned):
            x, _, aux = run(0, n_scanned, x, aux)
        elif cfg.remat_group > 1 and n_full % cfg.remat_group == 0:
            # two-level remat: one saved residual per group of periods, and
            # the group's backward recomputes period by period
            grp = cfg.remat_group

            def group_body(x, aux, g):
                for p in range(g * grp, (g + 1) * grp):
                    x, aux = checkpoint(period_body, x, aux, p, use_reentrant=False)
                return x, aux

            for g in range(n_full // grp):
                x, aux = checkpoint(group_body, x, aux, g, use_reentrant=False)
        else:
            for p in range(n_full):
                x, aux = checkpoint(period_body, x, aux, p, use_reentrant=False)
    # the final norm reads an unrolled last layer's unrounded sum too
    x, x_last, aux = run(n_scanned, cfg.n_layers, x, aux)
    new_cache = None
    if cache is not None and s == 1:  # decode: the layers updated ``cache`` in place
        cache["step"].add_(1)
        new_cache = cache
    elif cache is not None:
        new_cache = {"step": cache["step"] + s, "layers": new_layers}

    if last_only:
        rows = 1 if last_only is True else int(last_only)
        x = x[:, -rows:]
        x_last = None if x_last is None else x_last[:, -rows:]
    final_norm = params["final_norm"]
    if st is not None:
        final_norm = st.whole(final_norm, specs["final_norm"])
    x = rmsnorm_apply(final_norm, x, x_f32=x_last)
    if st is not None:
        logits, _ = st.head(params, specs, x, cfg=cfg, policy=policy, training=training,
                            backend=backend)
    elif cfg.tie_embeddings:
        with record_function("family.tied_head"):
            logits = x.to(torch.float32) @ params["embed"]["embedding"].to(torch.float32).T
    else:
        logits = lm_head_apply(params["lm_head"], x, policy=policy, training=training,
                               backend=backend)
    return logits, aux, new_cache


def cross_entropy(logits, targets, mask=None, n_valid=None) -> torch.Tensor:
    """Mean token cross entropy in float32, the reference's stable form
    (max, log-sum-exp, gold logit). ``n_valid`` masks the padded vocab
    columns out of the partition function; ``mask`` weights the tokens."""
    logits = logits.to(torch.float32)
    if n_valid is not None and n_valid != logits.shape[-1]:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < n_valid, logits, torch.full_like(logits, -1e30))
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    gold = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(cfg: ModelConfig, params, batch, *, policy=None, training=True, aux_weight=0.01,
            shard=None):
    """Returns (total, {"loss", "aux_loss"}): the cross entropy of
    ``batch["targets"]`` (``batch.get("loss_mask")`` weighting tokens) plus
    ``aux_weight`` times the MoE layers' load-balancing loss. A VLM's
    patch positions carry no target: their logits are dropped. ``shard``
    (``sharding/fsdp.ShardedTrain``): one rank's term of a sharded train
    step; ``params`` and ``batch`` are then the rank's blocks and rows,
    and the metrics add ``"total"``, the global value."""
    logits, aux, _ = forward(cfg, params, batch, policy=policy, training=training, shard=shard)
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:, :]
    st = shard
    if st is not None:
        # this rank's term of the loss (the data ranks' terms sum to it);
        # "total" is the global value the one-device step reports
        term, loss = st.cross_entropy(logits, batch["targets"], batch.get("loss_mask"),
                                      cfg.vocab_size, _vocab_lo(st, cfg, logits))
        total = loss + aux_weight * aux.detach()
        return term + aux_weight * aux, {"loss": loss, "aux_loss": aux, "total": total}
    loss = cross_entropy(logits, batch["targets"], batch.get("loss_mask"),
                         n_valid=cfg.vocab_size)
    return loss + aux_weight * aux, {"loss": loss, "aux_loss": aux}


def _vocab_lo(st, cfg, logits):
    """The first vocab column of a sharded step's logits block, or None
    when the logits are whole."""
    if cfg.tie_embeddings:
        sharded = st.vocab_block(st.specs["embed"]["embedding"]) == 0
    else:
        sharded = st.vocab_block(st.specs["lm_head"]["head"]["w"]) == 1
    return st.model_rank * logits.shape[-1] if sharded else None
