"""Step functions: the train step (gradient accumulation over
microbatches, optional compressed gradients), and the serving steps —
prefill (whole or in chunks), the lockstep engine's decode and serve
steps, and the continuous-batching decode step.

The factories take an optional ``precision=(a_bits, w_bits)`` runtime
dial: the policy is re-stamped with
:meth:`PrecisionPolicy.with_runtime_bits`, so every projection resolves
its plan at the dialed width (weight planes by MSB-prefix truncation of
the stored decomposition, activations quantized at the lower width).
On the card the engines capture the decode step as one CUDA graph per
precision (:mod:`repro_torch.launch.graphs`), the counterpart of the
reference's ``jax.jit`` of it; prefill runs eagerly.

With a ``collector`` (:class:`~repro_torch.core.integrity.Collector`) a
step runs its forward under ABFT alarm collection and returns one more
output, the ``(n_checks,)`` bool alarm vector on the device: the engine
reads it back once per step, with the tokens.

The tensor-parallel steps (:func:`make_tp_prefill_step`,
:func:`make_tp_chunk_prefill_step`, :func:`make_tp_cb_decode_step`; the
reference's ``src/repro/launch/steps.py:285-434``) build the same steps on
the rank's local config (``n_heads / P`` and ``n_kv_heads / P`` heads, so
caches hold the rank's heads), run them under the
:class:`~repro_torch.sharding.tp.TPContext`'s scope on the rank's shard
tree and OR-reduce the alarm vector over the ranks. Logits and tokens come
back replicated on every rank: every rank samples the same tokens from
the same gathered logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import tree as tr
from repro_torch.core.integrity import Collector
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import sampling
from repro_torch.launch.graphs import clone_tree
from repro_torch.models.cache import init_cache, quantize_scratch
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, loss_fn
from repro_torch.optim import OptimConfig, apply_updates, clip_by_global_norm
from repro_torch.optim import compress as gcomp


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimConfig,
    policy: Optional[PrecisionPolicy] = None,
    microbatches: int = 1,
    compress_grads: bool = False,
    mesh=None,
    specs=None,
    grad_accum_dtype=torch.float32,
):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics {"loss", "grad_norm"}), the reference's step:

    * the gradients of :func:`~repro_torch.models.transformer.loss_fn`
      (``training=True``; eager autograd); with ``microbatches`` > 1 they
      accumulate in ``grad_accum_dtype`` (a torch dtype or its name;
      float32 by default, the dry run's profiles take bfloat16 for the
      largest models) over equal slices of the batch and are divided by
      their number, as is the loss (the gradients then keep that dtype);
    * with ``compress_grads`` they pass through int8 error-feedback
      compression, the error buffer riding in ``opt_state["_gc_error"]``;
    * then :func:`~repro_torch.optim.clip_by_global_norm`
      (``opt_cfg.clip_norm``), the optimizer's update and
      :func:`~repro_torch.optim.apply_updates`.

    ``params`` is any tree :func:`loss_fn` takes (the trainer passes the
    reference's layout, so the optimizer state lines up with its leaves);
    ``batch`` holds ``tokens`` and ``targets`` (B, S) on the device;
    ``step`` is the int step. The tensors given are not modified. The
    step runs inside ``torch.profiler`` ranges: ``train.grads`` (the
    forward and backward; the backward itself runs on autograd's thread),
    ``train.clip`` (compression and clipping) and ``train.update`` (the
    optimizer and ``apply_updates``).

    ``mesh`` (``launch/mesh.Mesh``) and ``specs`` (the parameters' specs,
    ``sharding/rules.tree_param_specs``): the step of one rank of a
    sharded run. ``params`` and ``opt_state`` are then the rank's blocks
    (``optim.state_specs``), ``batch`` the global batch: each microbatch's
    rows are split over the batch axes (``pod`` and ``data``) where they
    divide, else every such rank takes all of them; on a mesh with a
    ``pod`` axis the gradients are then all-reduced over it. The forward
    and backward run under
    ``sharding/fsdp.ShardedTrain`` (their collectives in ``train.allgather``,
    ``train.reduce_scatter`` and ``train.allreduce`` ranges), the clip,
    the compressor and Adafactor reduce over every block, and the loss
    reported is the global one."""
    from repro_torch.sharding.collectives import all_reduce_, layout_of
    from repro_torch.sharding.fsdp import ShardedTrain, batch_axes

    layout = layout_of(mesh, specs)
    shard = None if mesh is None else ShardedTrain(mesh, specs)
    optimizer = opt_cfg.build(layout=layout)
    inv_mb = float(np.float32(1.0) / np.float32(microbatches))
    if isinstance(grad_accum_dtype, str):
        grad_accum_dtype = getattr(torch, grad_accum_dtype)
    baxes = () if mesh is None else batch_axes(mesh)
    dsize = 1 if mesh is None else mesh.extent(baxes)
    pod = None if mesh is None or "pod" not in mesh.axis_names else mesh.group("pod")

    def rows(mb):
        """This rank's rows of a (micro)batch on a mesh: its block over the
        batch axes where the rows divide, else all of them."""
        b = next(iter(mb.values())).shape[0]
        if dsize == 1 or b % dsize:
            return mb
        lo = mesh.index(baxes) * (b // dsize)
        return {k: v[lo:lo + b // dsize] for k, v in mb.items()}

    def grads_of(params, mb):
        leaves = [p.detach().requires_grad_() for p in tr.leaves(params)]
        if mesh is None:
            total, _ = loss_fn(cfg, tr.unflatten_like(params, leaves), mb, policy=policy)
            value = total.detach()
        else:
            total, metrics = loss_fn(cfg, tr.unflatten_like(params, leaves), rows(mb),
                                     policy=policy, shard=shard)
            value = metrics["total"]
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # an unused leaf's gradient is zero, as the reference's
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return value, tr.unflatten_like(params, grads)

    def train_step(params, opt_state, batch, step):
        with record_function("train.grads"):
            loss, grads = accumulated_grads(params, batch)
            if pod is not None:  # pure data parallel across pods
                for g in tr.leaves(grads):
                    all_reduce_(g, pod)
        with torch.no_grad():
            with record_function("train.clip"):
                if compress_grads:
                    qs, scales, err = gcomp.compress_tree(grads, opt_state["_gc_error"],
                                                          layout=layout)
                    grads = gcomp.decompress_tree(qs, scales)
                grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm, layout)
            with record_function("train.update"):
                inner = {k: v for k, v in opt_state.items() if not k.startswith("_")}
                updates, inner = optimizer.update(grads, inner, params, step)
                params = apply_updates(params, updates)
        new_state = {**inner, **{k: v for k, v in opt_state.items() if k.startswith("_")}}
        if compress_grads:
            new_state["_gc_error"] = err
        return params, new_state, {"loss": loss, "grad_norm": gnorm}

    def accumulated_grads(params, batch):
        if microbatches > 1:
            mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                   for k, v in batch.items()}
            gsum = tr.tree_map(
                lambda p: torch.zeros(p.shape, dtype=grad_accum_dtype, device=p.device), params)
            lsum = None
            for i in range(microbatches):
                loss_i, g = grads_of(params, {k: v[i] for k, v in mbs.items()})
                for a, b in zip(tr.leaves(gsum), tr.leaves(g)):
                    a.add_(b.to(grad_accum_dtype))
                lsum = loss_i if lsum is None else lsum + loss_i
            # XLA's form of the divisions by the constant count
            return lsum * inv_mb, tr.tree_map(lambda g: g * inv_mb, gsum)
        return grads_of(params, batch)

    return train_step


def init_opt_state(cfg, opt_cfg: OptimConfig, params, compress_grads: bool = False) -> dict:
    """The optimizer's initial state for ``params`` (plus the zero error
    buffer ``_gc_error`` with ``compress_grads``)."""
    state = dict(opt_cfg.build().init(params))
    if compress_grads:
        state["_gc_error"] = gcomp.init_error(params)
    return state


def _dial(policy, precision: Optional[Tuple[int, int]]):
    if precision is None or policy is None:
        return policy
    return policy.with_runtime_bits(*precision)


def _collected(collector: Optional[Collector], body, device):
    """Run ``body()`` under ``collector``: (result, alarm vector)."""
    if collector is None:
        return body(), None
    with collector.collect():
        result = body()
        alarms = collector.stacked(device)
    return result, alarms


def make_prefill_step(
    cfg: ModelConfig,
    policy=None,
    max_len: Optional[int] = None,
    kv_quant: bool = False,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
    collector: Optional[Collector] = None,
):
    """prefill_step(params, tokens (B, S), scratch=None) -> (last_logits
    (B, V), cache[, alarms]). ``tokens`` may be the reference's batch dict
    instead: ``{"tokens"}``, a VLM's ``{"tokens", "patches"}`` (the cache
    then holds the patches' positions first, and decode continues after
    them) or the encoder's ``{"features"}`` (no cache: the cache returned
    is None and the logits are the last frame's, as the reference's step
    returns them; the encoder's whole output is ``forward``'s).

    The forward appends ``tokens`` to a **raw** bf16 scratch cache at its
    running length and attends the whole written extent under a length
    mask: a fresh scratch of ``max_len`` positions (default ``S``), or the
    given ``scratch``. Chunked prefill passes the previous chunk's result;
    the input scratch is not modified, so shared-prefix snapshots keep
    earlier chunk states. With ``kv_quant`` the result is quantized once at
    the end — the reference's schedule, so prefill logits and committed KV
    match it.

    On the CPU any chunk schedule gives the one-chunk prefill's logits bit
    for bit, as the reference's does. On CUDA it need not: the float32
    reductions of the plain operations can depend on a chunk's row count
    (PERF.md, PR 14)."""
    policy = _dial(policy, precision)

    def prefill_step(params, tokens, scratch=None):
        batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        if cfg.frontend == "audio":
            bsz, s = batch["features"].shape[:2]
        else:
            bsz, s = batch["tokens"].shape
            if cfg.frontend == "vision" and "patches" in batch:
                s += batch["patches"].shape[1]
        device = next(iter(batch.values())).device
        if not cfg.is_decoder:
            scratch = None
        elif scratch is None:
            scratch = init_cache(cfg, bsz, max_len or s, cfg.dtype, kv_quant=False,
                                 device=device)
        elif s == 1:
            # a one-token chunk takes the forward's decode branch, which
            # writes its cache in place: keep the given scratch as it was
            scratch = clone_tree(scratch)

        def body():
            with torch.no_grad():
                return forward(
                    cfg, params, batch, policy=policy, cache=scratch,
                    last_only=cfg.is_decoder, backend=backend,
                )

        (logits, _aux, cache), alarms = _collected(collector, body, device)
        if kv_quant and cache is not None:
            cache = quantize_scratch(cache)
        if collector is None:
            return logits[:, -1, :], cache
        return logits[:, -1, :], cache, alarms

    return prefill_step


def make_decode_step(cfg: ModelConfig, policy=None, precision: Optional[Tuple[int, int]] = None,
                     backend: str = "auto"):
    """decode_step(params, cache, tokens (B, 1)) -> (logits (B, V), cache):
    one token per row against the cache, which is updated in place."""
    policy = _dial(policy, precision)

    def decode_step(params, cache, tokens):
        with torch.no_grad():
            logits, _aux, cache = forward(
                cfg, params, {"tokens": tokens}, policy=policy, cache=cache, backend=backend,
            )
        return logits[:, -1, :], cache

    return decode_step


def make_serve_step(
    cfg: ModelConfig,
    policy=None,
    sample_fn=None,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
    collector: Optional[Collector] = None,
):
    """One lockstep iteration: decode and sample the next token,
    serve_step(params, cache, tokens (B, 1), gen=None) -> (next_tokens (B, 1),
    cache[, alarms]). ``sample_fn(logits, gen) -> (B,) int32`` over the
    vocab-masked logits (default :func:`~repro_torch.launch.sampling.greedy`)."""
    decode = make_decode_step(cfg, policy, precision=precision, backend=backend)
    sample_fn = sample_fn or sampling.greedy

    def serve_step(params, cache, tokens, gen=None):
        (logits, cache), alarms = _collected(
            collector, lambda: decode(params, cache, tokens), tokens.device
        )
        logits = sampling.mask_vocab(logits, cfg.vocab_size)
        next_tok = sample_fn(logits, gen)[:, None]
        if collector is None:
            return next_tok, cache
        return next_tok, cache, alarms

    return serve_step


def make_cb_decode_step(
    cfg: ModelConfig,
    policy=None,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
    collector: Optional[Collector] = None,
    with_logits: bool = False,
):
    """One continuous-batching iteration over the whole slot array:
    cb_step(params, cache, tokens (B, 1), temps (B,), gen) ->
    (next_tokens (B, 1), cache[, alarms][, logits]). Every slot decodes one
    token at its own length; free slots compute too (their lanes are never
    read). The step updates ``cache`` in place and returns it; it reads
    nothing back to the host and builds no tensor from host data, so the
    engine captures it as one CUDA graph per precision on the card.
    ``with_logits`` adds the raw (unmasked) per-slot logits as the last
    output: the autopilot's shadow probe scores their KL between tiers
    (sliced to ``vocab_size`` before any softmax)."""
    decode = make_decode_step(cfg, policy, precision=precision, backend=backend)

    def cb_step(params, cache, tokens, temps, gen=None):
        (logits, cache), alarms = _collected(
            collector, lambda: decode(params, cache, tokens), tokens.device
        )
        raw = logits
        logits = sampling.mask_vocab(logits, cfg.vocab_size)
        next_tok = sampling.sample_tokens(logits, temps, gen)[:, None]
        out = (next_tok, cache)
        if collector is not None:
            out = out + (alarms,)
        if with_logits:
            out = out + (raw,)
        return out

    return cb_step


def _tp_reduced(tp, out, at: Optional[int]):
    """``out`` with its alarm vector (at index ``at``) OR-reduced over the
    ranks."""
    if at is None:
        return out
    out = list(out)
    out[at] = tp.reduce_alarms(out[at])
    return tuple(out)


def make_tp_prefill_step(
    cfg: ModelConfig,
    tp,
    policy=None,
    max_len: Optional[int] = None,
    kv_quant: bool = False,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
    collector: Optional[Collector] = None,
):
    """Tensor-parallel :func:`make_prefill_step`: the same signature and
    outputs, on this rank's shard tree; the cache (a fresh scratch, or the
    given one) holds the rank's KV heads."""
    inner = make_prefill_step(tp.local_config(cfg), policy, max_len=max_len, kv_quant=kv_quant,
                              precision=precision, backend=backend, collector=collector)

    def prefill_step(params, tokens, scratch=None):
        with tp.scope():
            out = inner(params, tokens, scratch)
        return _tp_reduced(tp, out, None if collector is None else 2)

    return prefill_step


def make_tp_chunk_prefill_step(
    cfg: ModelConfig,
    tp,
    policy=None,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
    collector: Optional[Collector] = None,
):
    """The reference's chunk step under tensor parallelism:
    chunk_step(params, scratch, tokens) -> (last_logits, scratch[, alarms]),
    one chunk appended to the raw scratch (the rank's heads), which is not
    modified (the port's prefill step with a scratch given). The engine
    calls :func:`make_tp_prefill_step` with the scratch itself; only the
    tests call this form, the reference's signature."""
    step = make_tp_prefill_step(cfg, tp, policy, precision=precision, backend=backend,
                                collector=collector)

    def chunk_step(params, scratch, tokens):
        return step(params, tokens, scratch)

    return chunk_step


def make_tp_cb_decode_step(
    cfg: ModelConfig,
    tp,
    policy=None,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
    collector: Optional[Collector] = None,
    with_logits: bool = False,
):
    """Tensor-parallel :func:`make_cb_decode_step`: cb_step(params, cache,
    tokens, temps, gen) on this rank's shard tree and its cache of the
    rank's heads (dense slots or paged pools alike: block tables, lengths
    and page ids are the same on every rank). Sampling runs on every rank
    from the gathered logits, so the tokens are replicated without another
    collective. Reads nothing back: on the card over NCCL it captures into
    a CUDA graph with its collectives inside."""
    inner = make_cb_decode_step(tp.local_config(cfg), policy, precision=precision,
                                backend=backend, collector=collector, with_logits=with_logits)

    def cb_step(params, cache, tokens, temps, gen=None):
        with tp.scope():
            out = inner(params, cache, tokens, temps, gen)
        return _tp_reduced(tp, out, None if collector is None else 2)

    return cb_step
