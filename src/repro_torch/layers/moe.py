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

The expert-parallel mesh branch of the reference (``shard_map`` with
all-gathers and a ``psum_scatter``) is tensor-parallel work, ROADMAP
item 11b.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core.quantize import fake_quant
from repro_torch.kernels.ops import ACTIVATIONS
from repro_torch.layers.linear import linear_init

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


def _dispatch(top_ids, n_experts: int, capacity: int):
    """Capacity-bounded slots of the flat (token, k) copies: ``keep`` (N,)
    and ``dst`` (N,), the copy's row of the ``(E * capacity + 1)`` buffer
    (the last row takes the dropped ones). A copy's place is the number of
    earlier copies of its expert."""
    flat = top_ids.reshape(-1)
    onehot = (flat[:, None] == torch.arange(n_experts, device=flat.device)).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot) * onehot
    pos = pos.sum(dim=1, dtype=torch.int32)
    keep = pos < capacity
    dst = torch.where(keep, flat.to(torch.int32) * capacity + pos,
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


def _gshard_block(x, router_w, gate, up, down, *, n_experts, top_k, capacity, prec):
    """The reference's single-device ``_ep_block``: route, dispatch into
    the capacity buffer, the expert products, the weighted combine."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    with record_function("moe.route"):
        probs, top_p, top_ids = _route(xf, router_w, n_experts, top_k)
    with record_function("moe.dispatch"):
        keep, dst = _dispatch(top_ids, n_experts, capacity)
        n = keep.shape[0]
        if _DROP_LOG is not None:
            _DROP_LOG.append((s, n, n - keep.sum()))
        token_of = torch.arange(n, device=x.device) // top_k
        buf = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype, device=x.device)
        buf.index_copy_(0, dst, xf[token_of])
        buf3 = buf[:-1].reshape(n_experts, capacity, d)
    o = _expert_ffn(buf3, gate, up, down, prec, x.dtype)
    with record_function("moe.combine"):
        of = o.reshape(n_experts * capacity, d)
        gathered = of[torch.clamp(dst, max=n_experts * capacity - 1)]
        gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
        contrib = (top_p.reshape(-1)[:, None] * gathered).reshape(t, top_k, d)
        out = contrib[:, 0]
        for j in range(1, top_k):  # k order: the reference's scatter-add order
            out = out + contrib[:, j]
    return out.reshape(b, s, d).to(x.dtype), _aux_loss(probs, top_ids, n_experts)


def moe_apply_gshard(params, x, *, n_experts: int, top_k: int, policy, training: bool = False,
                     name: str = "moe", capacity_factor: float = 0.0, mesh=None):
    """Capacity-bounded dispatch. x: (B, S, d). Returns (out, aux_loss).
    ``mesh``: the expert-parallel branch, which is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE dispatch over a mesh is tensor-parallel work "
            "(ROADMAP item 11b); the single-device dispatch takes mesh=None"
        )
    if "w" not in params["router"]:
        raise ValueError(f"{name}/router is quantized: the router must stay dense "
                         "(reference defect G; keep_dense=('router',))")
    b, s, _ = x.shape
    prec = policy.lookup(f"{name}/expert")
    cap = _capacity_for(b * s, top_k, n_experts, n_experts, capacity_factor)
    return _gshard_block(x, params["router"]["w"], params["gate"], params["up"], params["down"],
                         n_experts=n_experts, top_k=top_k, capacity=cap, prec=prec)


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
              name: str = "moe", impl: str = "gshard_ep", capacity_factor: float = 0.0):
    """x: (B, S, d). Returns (out, aux_loss), the layer inside the
    ``moe.*`` ranges."""
    if impl == "global_sort":
        return moe_apply_global_sort(params, x, n_experts=n_experts, top_k=top_k,
                                     policy=policy, training=training, name=name)
    return moe_apply_gshard(params, x, n_experts=n_experts, top_k=top_k, policy=policy,
                            training=training, name=name, capacity_factor=capacity_factor)
