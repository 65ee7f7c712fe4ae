"""Mixture-of-experts layer: top-k routing, capacity-bounded dispatch,
dense per-expert products and a weighted combine.

Two dispatches, the reference's:

* ``gshard_ep`` (default): each expert takes at most ``capacity`` token
  copies into a zero-padded ``(E, capacity, d)`` buffer; a copy's place
  in its expert is its rank among that expert's copies in flat
  (token, k) order, and copies past the capacity are dropped.
  ``capacity_factor=0`` is dropless (every copy could land on one
  expert). Every shape is static and nothing is read back to the host,
  so a decode step that runs it is captured in a CUDA graph. Which copies
  are dropped depends on every row of the batch: in a continuous-batching
  slot array the free slots take their places too.
* ``global_sort``: the dropless oracle. Copies are sorted by expert and
  each expert's rows multiply its weights (the reference's
  ``lax.ragged_dot``); the group sizes are read back to the host, so it is
  never captured.

The router is a float32 ``{'w'}`` linear and stays dense: a policy that
would quantize it is refused at load (``models.quant``, reference defect
G). Under an active policy the expert products fake-quantize their
operands as the reference's do, every call: the weights per output column
over the d axis (axis 1 of ``(E, d, f)``), the activations per row. The
products take bf16 operands and accumulate in float32 (the reference's
``preferred_element_type``): they run as float32 matmuls, in which the
bf16 products are exact. A token's k contributions are summed in k order
in float32, the order of the reference's scatter-add; no atomics.

The layer's parts run inside ``torch.profiler`` ranges: ``moe.route``,
``moe.dispatch``, ``moe.expert_quant``, ``moe.expert_mm`` and
``moe.combine``. :func:`record_drops` logs each call's dropped copies.

With a ``mesh`` (``launch/mesh.Mesh``, a sharded train step) the
dispatch is expert parallel, the reference's ``_ep_block`` over
``torch.distributed``: the tokens are gathered over the model row when
their sequence is sharded (``moe.ep_gather``), the router and the expert
blocks gathered over the data column (FSDP), every rank of the row routes
the same tokens, dispatches the copies bound for its own experts into its
capacity buffer, runs their products and scatter-adds the weighted
outputs; the row sums them (``moe.ep_combine``: an all-reduce, or a
reduce-scatter back to the sequence blocks). The aux loss is the mean
over the batch axes. Capacity follows the rank's rows, so with
``capacity_factor`` > 0 the dropped copies depend on the mesh, as in the
reference.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core.quantize import fake_quant
from repro_torch.kernels.ops import ACTIVATIONS
from repro_torch.layers.linear import linear_init
from repro_torch.sharding import collectives as col

_silu = ACTIVATIONS["silu"]

#: the list :func:`record_drops` appends to, or None
_DROP_LOG: Optional[list] = None


@contextlib.contextmanager
def record_drops():
    """Log the dispatches of the ``gshard_ep`` calls made inside: a list of
    ``(seq_len, copies, dropped)`` per call, ``dropped`` a 0-dim int64
    tensor on the layer's device (no read-back during the run). For
    eager runs: a graph replay logs nothing."""
    global _DROP_LOG
    prev, _DROP_LOG = _DROP_LOG, []
    try:
        yield _DROP_LOG
    finally:
        _DROP_LOG = prev


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, dtype=torch.bfloat16, device=None):
    """The router (a float32 linear) and the stacked expert weights
    ``gate`` / ``up`` ``(E, d, f)`` and ``down`` ``(E, f, d)``, normal with
    the reference's scales."""

    def w(shape, s):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * s).to(dtype)

    scale = (1.0 / d_model) ** 0.5
    return {
        "router": linear_init(gen, d_model, n_experts, torch.float32, device),
        "gate": w((n_experts, d_model, d_ff), scale),
        "up": w((n_experts, d_model, d_ff), scale),
        "down": w((n_experts, d_ff, d_model), (1.0 / d_ff) ** 0.5),
    }


def _maybe_quant(w, x, prec):
    """The expert product's operands under ``prec``: fake-quantized (weights
    over axis 1, activations over the last axis, each back in its dtype),
    or as given when the layer is inactive."""
    if not prec.active:
        return w, x
    wq = fake_quant(w.to(torch.float32), prec.w_bits, axis=1).to(w.dtype)
    xq = fake_quant(x.to(torch.float32), prec.a_bits, axis=-1).to(x.dtype)
    return wq, xq


def _route(xf, router_w, n_experts: int, top_k: int):
    """Top-k routing. xf: (T, d) -> (probs (T, E), top_p (T, k), top_ids
    (T, k) int64). The float32 product runs without TF32; the top k come
    in descending order with ties to the lower expert id, as
    ``lax.top_k`` orders them (a stable sort)."""
    logits = xf.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_ids = top_p[:, :top_k], top_ids[:, :top_k]
    total = top_p[:, :1]
    for j in range(1, top_k):  # in k order, as the reference's reduction adds
        total = total + top_p[:, j:j + 1]
    top_p = top_p / torch.clamp_min(total, 1e-9)
    return probs, top_p, top_ids


def _aux_loss(probs, top_ids, n_experts: int):
    """The Switch load-balancing loss: ``E * sum(importance * load)``."""
    importance = probs.mean(dim=0)
    experts = torch.arange(n_experts, device=top_ids.device)
    load = (top_ids[..., None] == experts).to(torch.float32).sum(dim=1).mean(dim=0)
    return n_experts * torch.sum(importance * load)


def _capacity_for(t_row: int, top_k: int, n_experts: int, e_loc: int,
                  capacity_factor: float) -> int:
    """Copies per expert: ``T * k`` when dropless (``capacity_factor`` <=
    0), else ``int(cf * T * k / E)`` clamped to [1, T * k]."""
    n = t_row * top_k
    if capacity_factor <= 0:
        return n
    return max(min(int(capacity_factor * n / n_experts), n), 1)


def _dispatch(top_ids, n_experts: int, capacity: int, e0: int = 0):
    """Capacity-bounded slots of the flat (token, k) copies bound for
    experts ``e0 .. e0 + n_experts - 1`` (a rank's own experts; all of
    them by default): ``keep`` (N,) and ``dst`` (N,), the copy's row of
    the ``(n_experts * capacity + 1)`` buffer (the last row takes the
    dropped copies and those of other experts). A copy's place is the
    number of earlier copies of its expert."""
    flat = top_ids.reshape(-1)
    local = (flat >= e0) & (flat < e0 + n_experts)
    lid = torch.where(local, flat - e0, torch.full_like(flat, n_experts))
    onehot = (lid[:, None] == torch.arange(n_experts, device=flat.device)).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot) * onehot
    pos = pos.sum(dim=1, dtype=torch.int32)
    keep = local & (pos < capacity)
    dst = torch.where(keep, lid.to(torch.int32) * capacity + pos,
                      torch.full_like(pos, n_experts * capacity))
    return keep, dst.to(torch.int64)


def _expert_ffn(buf3, gate, up, down, prec, out_dtype):
    """SwiGLU experts over the ``(E, C, d)`` buffer: float32 products of
    bf16 operands; ``h`` rounds to ``out_dtype`` before the down
    projection's quantizer, as the reference casts it."""
    with record_function("moe.expert_quant"):
        wg, xb = _maybe_quant(gate, buf3, prec)
        wu, _ = _maybe_quant(up, buf3, prec)
    with record_function("moe.expert_mm"):
        xf = xb.to(torch.float32)
        g = torch.bmm(xf, wg.to(xb.dtype).to(torch.float32))
        u = torch.bmm(xf, wu.to(xb.dtype).to(torch.float32))
        h = (_silu(g) * u).to(out_dtype)
    with record_function("moe.expert_quant"):
        wd, hq = _maybe_quant(down, h, prec)
    with record_function("moe.expert_mm"):
        return torch.bmm(hq.to(torch.float32), wd.to(hq.dtype).to(torch.float32))


def _gshard_block(x, router_w, gate, up, down, *, n_experts, top_k, capacity, prec, e0=0):
    """The reference's ``_ep_block`` body on the rank's experts ``e0 ..
    e0 + E_loc - 1`` (``gate.shape[0]`` of them; all on one device): route,
    dispatch into the capacity buffer, the expert products, the weighted
    combine. Returns (the float32 combine (B, S, d), probs, top_ids)."""
    b, s, d = x.shape
    t = b * s
    e_loc = gate.shape[0]
    xf = x.reshape(t, d)
    with record_function("moe.route"):
        probs, top_p, top_ids = _route(xf, router_w, n_experts, top_k)
    with record_function("moe.dispatch"):
        keep, dst = _dispatch(top_ids, e_loc, capacity, e0)
        n = keep.shape[0]
        if _DROP_LOG is not None:
            flat = top_ids.reshape(-1)
            local = (flat >= e0) & (flat < e0 + e_loc)
            _DROP_LOG.append((s, n, (local & ~keep).sum()))
        token_of = torch.arange(n, device=x.device) // top_k
        buf = torch.zeros((e_loc * capacity + 1, d), dtype=x.dtype, device=x.device)
        buf.index_copy_(0, dst, xf[token_of])
        buf3 = buf[:-1].reshape(e_loc, capacity, d)
    o = _expert_ffn(buf3, gate, up, down, prec, x.dtype)
    with record_function("moe.combine"):
        of = o.reshape(e_loc * capacity, d)
        gathered = of[torch.clamp(dst, max=e_loc * capacity - 1)]
        gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
        contrib = (top_p.reshape(-1)[:, None] * gathered).reshape(t, top_k, d)
        out = contrib[:, 0]
        for j in range(1, top_k):  # k order: the reference's scatter-add order
            out = out + contrib[:, j]
    return out.reshape(b, s, d), probs, top_ids


def _ep_block(x, params, *, mesh, n_experts, top_k, capacity_factor, prec, seq_sharded):
    """The reference's per-device ``_ep_block`` (``src/repro/layers/moe.py:
    106-204``) on this rank's blocks: x (B_loc, S_loc, d), the router and
    expert blocks as the rules shard them."""
    gm, gd = mesh.group("model"), mesh.group("data")
    msize = mesh.shape.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    # 1. the token row this rank's experts serve; the rest of the block
    #    is a region whose gradients are partial sums over the row
    if seq_sharded:
        xg = col.all_gather(x, 1, gm, name="moe.ep_gather")
    else:
        xg = col.enter(x, gm)
    # 2. FSDP: the d-sharded weights of this layer, whole on d
    d = x.shape[-1]
    router, gate, up, down = params["router"]["w"], params["gate"], params["up"], params["down"]
    if gd is not None and d % mesh.shape["data"] == 0:
        router = col.all_gather(router, 0, gd)
        gate, up = col.all_gather(gate, 1, gd), col.all_gather(up, 1, gd)
        down = col.all_gather(down, 2, gd)
    else:
        router, gate, up, down = (col.enter(t, gd) for t in (router, gate, up, down))
    router = col.enter(router, gm)
    e_loc = gate.shape[0]
    e0 = mesh.coord("model") * e_loc if "model" in mesh.axis_names else 0
    # 3-6. route (the same on every rank of the row), dispatch to the
    #    local experts within capacity, their products, the combine
    cap = _capacity_for(xg.shape[0] * xg.shape[1], top_k, n_experts, e_loc, capacity_factor)
    contrib, probs, top_ids = _gshard_block(xg, router, gate, up, down, n_experts=n_experts,
                                            top_k=top_k, capacity=cap, prec=prec, e0=e0)
    if seq_sharded:
        out = col.reduce_scatter(contrib, 1, gm, name="moe.ep_combine")
    else:
        out = col.reduce(contrib, gm, name="moe.ep_combine")
    # 7. the aux loss: every rank of the row computes it alike (each adds
    #    1/model of its gradient), its mean over the batch axes
    aux = col.scale_grad(_aux_loss(probs, top_ids, n_experts), 1.0 / msize)
    aux = col.mean(aux, mesh.group(batch_axes) if batch_axes else None)
    return out.to(x.dtype), aux


def moe_apply_gshard(params, x, *, n_experts: int, top_k: int, policy, training: bool = False,
                     name: str = "moe", capacity_factor: float = 0.0, mesh=None,
                     seq_sharded: bool = False):
    """Capacity-bounded dispatch. x: (B, S, d). Returns (out, aux_loss).

    ``mesh`` (``launch/mesh.Mesh``): the expert-parallel branch (module
    docstring). ``x`` is then this rank's block (B_loc, S_loc, d): its
    batch rows, and with ``seq_sharded`` its block of the sequence over
    the model row (else the whole sequence, the same on every rank of the
    row); ``params`` are its blocks as ``sharding/rules.py`` cuts them
    (experts over model, d over data). The output is x's block; the aux
    loss the mean over the batch axes. The trainer keeps the residual
    stream whole over the row (no sequence parallelism), so it never sets
    ``seq_sharded``: the branch keeps the reference's token gather and
    reduce-scatter combine for its sequence-parallel callers (ROADMAP item
    14b's dryrun lowers the reference's layout), and the tests hold it to
    the oracle."""
    if "w" not in params["router"]:
        raise ValueError(f"{name}/router is quantized: the router must stay dense "
                         "(reference defect G; keep_dense=('router',))")
    prec = policy.lookup(f"{name}/expert")
    if mesh is not None:
        msize = mesh.shape.get("model", 1)
        if n_experts % msize != 0:
            raise ValueError(
                f"n_experts={n_experts} must divide over model axis ({msize})"
            )
        return _ep_block(x, params, mesh=mesh, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor, prec=prec,
                         seq_sharded=seq_sharded and msize > 1)
    b, s, _ = x.shape
    cap = _capacity_for(b * s, top_k, n_experts, n_experts, capacity_factor)
    out, probs, top_ids = _gshard_block(x, params["router"]["w"], params["gate"], params["up"],
                                        params["down"], n_experts=n_experts, top_k=top_k,
                                        capacity=cap, prec=prec)
    return out.to(x.dtype), _aux_loss(probs, top_ids, n_experts)


def moe_apply_global_sort(params, x, *, n_experts: int, top_k: int, policy,
                          training: bool = False, name: str = "moe"):
    """Dropless sorted dispatch, the oracle. x: (B, S, d). Copies sorted
    by expert (stable); each expert's group multiplies its weights, the
    group sizes read back to the host; products rounded to x's dtype, as
    ``lax.ragged_dot`` returns them; a token's contributions summed in
    sorted order, the order of the reference's scatter-add."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    prec = policy.lookup(f"{name}/expert")
    probs, top_p, top_ids = _route(xf, params["router"]["w"], n_experts, top_k)
    flat_ids = top_ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    token_idx = order // top_k
    xs = xf[token_idx]
    sizes = torch.bincount(flat_ids, minlength=n_experts).tolist()
    wg, xs_q = _maybe_quant(params["gate"], xs, prec)
    wu, _ = _maybe_quant(params["up"], xs, prec)

    def ragged(a, w):
        parts, lo = [], 0
        for e, n in enumerate(sizes):
            parts.append(a[lo:lo + n].to(torch.float32) @ w[e].to(a.dtype).to(torch.float32))
            lo += n
        return torch.cat(parts).to(a.dtype)

    g = ragged(xs_q, wg)
    u = ragged(xs_q, wu)
    h = (_silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    wd, h_q = _maybe_quant(params["down"], h, prec)
    out_sorted = ragged(h_q, wd).to(torch.float32) * top_p.reshape(-1)[order][:, None]
    # each token's copies in sorted order, summed in that order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=x.device)
    by_token = torch.sort(rank.reshape(t, top_k), dim=1).values
    contrib = out_sorted[by_token]  # (T, k, d)
    out = contrib[:, 0]
    for j in range(1, top_k):
        out = out + contrib[:, j]
    return out.reshape(b, s, d).to(x.dtype), _aux_loss(probs, top_ids, n_experts)


def moe_apply(params, x, *, n_experts: int, top_k: int, policy, training: bool = False,
              name: str = "moe", impl: str = "gshard_ep", capacity_factor: float = 0.0,
              mesh=None):
    """x: (B, S, d). Returns (out, aux_loss), the layer inside the
    ``moe.*`` ranges. ``mesh``: the expert-parallel dispatch of a sharded
    train step (``moe_apply_gshard``; the global-sort oracle has no mesh
    branch, as in the reference)."""
    if impl == "global_sort" and mesh is not None:
        raise ValueError("the global_sort dispatch has no expert-parallel branch; "
                         "train on a mesh with moe_impl='gshard_ep'")
    if impl == "global_sort":
        return moe_apply_global_sort(params, x, n_experts=n_experts, top_k=top_k,
                                     policy=policy, training=training, name=name)
    return moe_apply_gshard(params, x, n_experts=n_experts, top_k=top_k, policy=policy,
                            training=training, name=name, capacity_factor=capacity_factor,
                            mesh=mesh)
