"""Optimizers (AdamW, Adafactor), LR schedules, gradient clipping.

Init/update pairs over parameter trees (:mod:`repro_torch.core.tree`),
repeating the reference's arithmetic as its compiled train step runs it:
state in float32, each update ``(-lr * delta)`` cast to the parameter's
dtype, then ``apply_updates`` adds in that dtype. ``torch.optim`` is not
used: it rounds differently.

The step's scalars (learning rate, bias corrections) are float32 values
computed on the host from the integer step and passed to the device as
Python floats. Where XLA's CPU code rounds differently from a single
float32 operation, the port repeats it: a product plus a sum becomes one
fused multiply-add (``torch.addcmul`` with a 0-dim factor), a division
by a constant a product with its float32 reciprocal (or, after a
product with a constant, one folded constant), and ``(a / b) / c`` the
single division ``a / (b * c)``. XLA's float32 ``cos`` is not correctly
rounded; the port's is (float64, rounded once), so the cosine schedule
may differ from the reference's in the last place. Adafactor's means
sum in XLA's order, which the port does not repeat
(``tests/test_torch_optim.py`` bounds both).

On a mesh the optimizer state is sharded like the parameters
(:func:`state_specs`) and every leaf is updated on its block; a
``layout`` (``sharding/collectives.LeafLayout``) makes each reduction
over a sharded dim global: the clip's sum of squares (a replicated leaf
counted once), Adafactor's row and column means and its update RMS
(divided by the global size).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import tree as tr

_F32 = np.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


def _fma32(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once (the product is exact in float64)."""
    return _F32(np.float64(_F32(a)) * np.float64(_F32(b)) + np.float64(_F32(c)))


def _recip32(n) -> np.float32:
    return _F32(1.0) / _F32(n)


# --------------------------------------------------------------------------
# Schedules: step (int) -> float32 learning rate (a Python float)
# --------------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def schedule(step) -> float:
        s = _F32(step)
        # (step+1)/warmup so step 0 takes a real (non-zero) update
        if s < _F32(warmup_steps):  # XLA folds peak / warmup into one constant
            return float((s + _F32(1.0)) * (_F32(peak_lr) / _F32(max(warmup_steps, 1))))
        t = (s - _F32(warmup_steps)) * _recip32(max(total_steps - warmup_steps, 1))
        t = min(max(t, _F32(0.0)), _F32(1.0))
        cos = _F32(math.cos(float(_F32(math.pi) * t)))
        inner = _fma32((1 - final_frac) * 0.5, _F32(1.0) + cos, final_frac)
        return float(_F32(peak_lr) * inner)

    return schedule


def constant_lr(lr: float):
    return lambda step: float(_F32(lr))


# --------------------------------------------------------------------------
# Clipping
# --------------------------------------------------------------------------


def _grouped(values: list, layout, leaves, op=None) -> list:
    """Each 0-dim ``values[i]`` reduced over the ranks holding leaf ``i``'s
    blocks (one all-reduce per group)."""
    if layout is None:
        return values
    from repro_torch.sharding.collectives import all_reduce_

    by_group: dict = {}
    for i, leaf in enumerate(leaves):
        g = layout.group(i, leaf.dim())
        if g is not None:
            by_group.setdefault(id(g), (g, []))[1].append(i)
    out = list(values)
    for g, idx in by_group.values():
        stacked = all_reduce_(torch.stack([values[i] for i in idx]), g, op)
        for j, i in enumerate(idx):
            out[i] = stacked[j]
    return out


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum over leaves (pytree order) of each leaf's sum of
    squares, in float32; a 0-dim tensor on the leaves' device. With a
    ``layout`` each leaf's sum runs over all its blocks (once per
    block: a replicated leaf counts once)."""
    leaves = tr.leaves(tree)
    sqs = []
    for leaf in leaves:
        lf = leaf.to(torch.float32)
        sqs.append(torch.sum(lf * lf))
    total = None
    for sq in _grouped(sqs, layout, leaves):
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, layout=None):
    """(tree scaled by min(1, max_norm / norm), norm); each leaf multiplied
    in float32 and cast back to its dtype, as the reference promotes.
    ``layout``: the norm over every rank's blocks (:func:`global_norm`)."""
    norm = global_norm(tree, layout)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tr.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def adam_scalars(step: int, b1: float, b2: float) -> tuple[float, float]:
    """The bias corrections ``1 - b ** (step + 1)`` in float32."""
    e = float(_F32(step) + _F32(1.0))
    c1 = _F32(1.0) - _F32(float(_F32(b1)) ** e)
    c2 = _F32(1.0) - _F32(float(_F32(b2)) ** e)
    return float(c1), float(c2)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. The CPU's vectorized
    ``torch.sqrt`` is not (it misses in the last place in about 0.5% of
    elements), XLA's is: on the host the root is taken in float64 and
    rounded once, which is exact; CUDA's ``sqrtf`` is correctly rounded."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw_leaf(g, m, v, p, *, lr: float, c1: float, c2: float, b1: float, b2: float,
               eps: float, weight_decay: float, state_dtype=torch.float32):
    """One leaf's AdamW step: (update in p's dtype, m, v). The reference's
    compiled form: ``m = fma(b1, m, (1-b1) g)``, ``v = fma(b2, v,
    ((1-b2) g) g)``, ``delta = m / (c1 * (sqrt(v / c2) + eps))`` and, on
    matrices, ``fma(wd, p, delta)``."""
    gf = g.to(torch.float32)
    m_new = torch.addcmul(gf * (1 - b1), m.to(torch.float32), _scalar(b1, gf))
    v_new = torch.addcmul((gf * (1 - b2)) * gf, v.to(torch.float32), _scalar(b2, gf))
    delta = m_new / ((_sqrt(v_new / c2) + eps) * c1)
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        delta = torch.addcmul(delta, p.to(torch.float32), _scalar(weight_decay, gf))
    return (delta * -lr).to(p.dtype), m_new.to(state_dtype), v_new.to(state_dtype)


def adamw(
    schedule: Callable,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype=torch.float32,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tr.tree_map(zeros, params), "v": tr.tree_map(zeros, params)}

    def update(grads, state, params, step):
        lr = schedule(step)
        c1, c2 = adam_scalars(step, b1, b2)
        out = [
            adamw_leaf(g, m, v, p, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, state_dtype=state_dtype)
            for g, m, v, p in zip(tr.leaves(grads), tr.leaves(state["m"]),
                                  tr.leaves(state["v"]), tr.leaves(params))
        ]
        return (tr.unflatten_like(grads, [o[0] for o in out]),
                {"m": tr.unflatten_like(state["m"], [o[1] for o in out]),
                 "v": tr.unflatten_like(state["v"], [o[2] for o in out])})

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment, optional bf16 momentum)
# --------------------------------------------------------------------------


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The sum times float32(1 / n): XLA's form of ``jnp.mean``."""
    n = x.numel() if dim is None else x.shape[dim]
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim, keepdim=keepdim)
    return s * float(_recip32(n))


def adafactor(
    schedule: Callable,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    momentum: bool = False,
    weight_decay: float = 0.0,
    layout=None,
) -> Optimizer:
    """``layout``: the parameters are blocks of a sharded tree; each mean
    sums over every block of the dims it reduces and divides by their
    whole size."""
    def _factored(p):
        return p.dim() >= 2

    def _per_leaf_init(p):
        dev = p.device
        st = {}
        if _factored(p):
            st["vr"] = torch.zeros(p.shape[:-1], dtype=torch.float32, device=dev)  # row stats
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=dev)
        else:
            st["v"] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        if momentum:
            st["m"] = torch.zeros(p.shape, dtype=torch.bfloat16, device=dev)
        return st

    def init(params):
        # factored stats have different shapes per leaf, so the state is a
        # flat list aligned with the parameters' leaves in pytree order
        return {"leaves": [_per_leaf_init(p) for p in tr.leaves(params)]}

    def update(grads, state, params, step):
        lr = schedule(step)

        def upd(g, st, p, i):
            nd = p.dim()

            def mean(x, dim=None, pdim=None, keepdim=False):
                # x's mean over ``dim`` (all: None), param dim ``pdim`` of
                # the leaf, over every block of it
                if layout is None:
                    return _mean(x, dim, keepdim)
                dims = None if pdim is None else [pdim]
                n = (x.numel() if dim is None else x.shape[dim]) * layout.extent(i, nd, dims)
                sm = torch.sum(x) if dim is None else torch.sum(x, dim=dim, keepdim=keepdim)
                return layout.sum_(sm, i, nd, dims) * float(_recip32(n))

            gf = g.to(torch.float32)
            g2 = torch.addcmul(_scalar(eps, gf).expand_as(gf), gf, gf)
            new_st = dict(st)
            if _factored(p):
                dec = _scalar(decay, gf)
                vr = torch.addcmul(mean(g2, -1, nd - 1) * (1 - decay), st["vr"], dec)
                vc = torch.addcmul(mean(g2, -2, nd - 2) * (1 - decay), st["vc"], dec)
                new_st["vr"], new_st["vc"] = vr, vc
                rfac = torch.clamp_min(vr / mean(vr, -1, nd - 2, keepdim=True), eps)
                upd_ = gf / (_sqrt(rfac)[..., None] * _sqrt(torch.clamp_min(vc, eps))[..., None, :])
            else:
                v = torch.addcmul(g2 * (1 - decay), st["v"], _scalar(decay, gf))
                new_st["v"] = v
                upd_ = gf / _sqrt(torch.clamp_min(v, eps))
            # update clipping (Adafactor's RMS rule)
            rms = _sqrt(mean(upd_ * upd_) + 1e-30)
            upd_ = upd_ / torch.clamp_min(rms / clip_threshold, 1.0)
            if momentum:
                m = torch.addcmul(upd_, st["m"].to(torch.float32), _scalar(0.9, gf))
                new_st["m"] = m.to(torch.bfloat16)
                upd_ = m
            if p.dim() >= 2 and weight_decay:
                upd_ = torch.addcmul(upd_, p.to(torch.float32), _scalar(weight_decay, gf))
            return (upd_ * -lr).to(p.dtype), new_st

        outs = [upd(g, st, p, i) for i, (g, st, p) in
                enumerate(zip(tr.leaves(grads), state["leaves"], tr.leaves(params)))]
        return (tr.unflatten_like(grads, [o[0] for o in outs]),
                {"leaves": [o[1] for o in outs]})

    return Optimizer(init, update)


def state_specs(kind: str, params, params_specs):
    """The specs of the optimizer state, from the parameters' (the
    reference's ``state_specs``): AdamW's ``m`` / ``v`` are sharded like
    their parameter; Adafactor's row statistic ``vr`` drops the last dim's
    entry, its column statistic ``vc`` the second to last."""
    from repro_torch.sharding.rules import P

    if kind == "adamw":
        return {"m": params_specs, "v": params_specs}
    if kind == "adafactor":
        out = []
        for p, spec in zip(tr.leaves(params), tr.leaves(params_specs)):
            entries = list(spec) + [None] * (p.dim() - len(spec))
            if p.dim() >= 2:
                out.append({"vr": P(*entries[:-1]), "vc": P(*(entries[:-2] + entries[-1:]))})
            else:
                out.append({"v": P(*entries)})
        return {"leaves": out}
    raise ValueError(kind)


def apply_updates(params, updates):
    """``(p + u)`` in the parameter's dtype, leaf by leaf."""
    return tr.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer selection (the reference's defaults)."""

    kind: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def build(self, layout=None) -> Optimizer:
        """The optimizer; ``layout``: its reductions over sharded leaves
        run over every block (Adafactor's; AdamW's update is per element)."""
        sched = warmup_cosine(self.peak_lr, self.warmup_steps, self.total_steps)
        if self.kind == "adamw":
            return adamw(sched, weight_decay=self.weight_decay)
        if self.kind == "adafactor":
            return adafactor(sched, weight_decay=self.weight_decay, layout=layout)
        raise ValueError(self.kind)
