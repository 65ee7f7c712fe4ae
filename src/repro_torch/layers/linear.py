"""QuantizedLinear: every dense projection goes through here.

Regimes, selected by the :class:`~repro_torch.core.precision.PrecisionPolicy`
and the parameter contents:

* dense bf16 (``{'w'}``) with an inactive policy — the reference path;
* QAT (``{'w'}`` with an active policy and ``training=True``) — both
  operands fake-quantized at the layer's (w_bits, a_bits) with
  straight-through gradients, then a product in the layer dtype (bf16),
  so training sees the values the bit-serial inference path computes with;
* bit-serial inference — stored-quantized ``{'w_q','w_scale'[, 'w_planes']}``
  from :func:`repro_torch.models.quant.quantize_params`, or ``{'w'}`` with an
  active policy (quantized on the fly). Activations are quantized per
  token and the product runs through a :class:`~repro_torch.core.plan.MatmulPlan`
  fetched from the plan registry; dequant, bias and activation ride into
  the plan call as an :class:`~repro_torch.kernels.ops.Epilogue` (inside the
  fused kernel on CUDA).

Inside a tensor-parallel step (:meth:`~repro_torch.sharding.tp.TPContext.scope`)
the stored-quantized path follows the projection's role
(:func:`~repro_torch.sharding.tp.tp_role`): a column-parallel projection
runs unchanged on its column slice; a row-parallel one quantizes its K
slice with the whole row's scale, runs its plan without an epilogue, sums
the ranks' int32 accumulators and applies the epilogue once; the
vocab-parallel head gathers the ranks' logits. Every plan carries the
shard triple on its key. A dense projection is replicated whole (a dense
vocab head computes the whole vocabulary on every rank, with no gather).
QAT and on-the-fly quantization in tensor-parallel *serving* are ROADMAP
item 17.

In a sharded train step (``sharding/fsdp.py``) the dense and QAT branches
run on the rank's column or row block as they are given; a row-parallel
block carries ``params["amax_reduce"]``, which QAT applies to both
operands' amax (the maximum over the model row).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.quantize import fake_quant, quantize
from repro_torch.kernels import ops
from repro_torch.sharding.tp import check_exact_bits, current_tp


def _accum_dtype(w_bits: int, a_bits: int):
    return torch.int32 if max(w_bits, a_bits) <= 8 else torch.float32


def linear_init(gen, d_in: int, d_out: int, dtype=torch.bfloat16, device=None,
                scale: float | None = None):
    """Normal(0, 1/d_in) weights drawn in float32, stored in ``dtype``."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device) * scale
    return {"w": w.to(dtype)}


def _finish_dense(y, bias, activation: str, out_dtype):
    if bias is None and activation == "none":
        return y
    out = y.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    out = ops.ACTIVATIONS[activation](out)
    return out.to(out_dtype)


def _row_parallel(params, x, xsrc, tp, eff, prec, *, name, policy, backend, shard, bias,
                  activation):
    """A row-parallel (K-sharded) projection: the activation quantized
    with the whole row's scale (the maximum over every rank's slice: a
    rank-local scale would make partial sums that do not compose), the plan
    without an epilogue (its raw int32 accumulator), the sum over the ranks
    (exact at <= 8 bits), then the epilogue once, with the plan's truncation
    correction folded into ``w_scale`` as the plan itself would fold it."""
    check_exact_bits(eff.a_bits, eff.w_bits)
    xq = quantize(xsrc, eff.a_bits, axis=-1, reciprocal_scale=True, amax=tp.global_amax(xsrc))
    plan = plan_mod.make_plan(
        policy, name, (tuple(x.shape), tuple(params["w_q"].shape)), backend,
        device=x.device,
        w_planes=params.get("w_planes"),
        w_stored_bits=prec.w_bits,
        has_epilogue=False,
        accum_dtype=torch.int32,
        shard=shard,
    )
    acc = tp.sum_partials(plan(xq.values, params["w_q"], w_planes=params.get("w_planes")))
    w_scale = params["w_scale"]
    if plan.scale_mult != 1.0:
        w_scale = w_scale * plan.scale_mult
    return ops.apply_epilogue(acc, ops.Epilogue(
        a_scale=xq.scale, w_scale=w_scale, bias=bias, activation=activation,
        out_dtype=x.dtype,
    ))


def projection(*, policy: PrecisionPolicy, training: bool = False, backend: str = "auto"):
    """Bind the per-model-call context once; layer code then applies
    projections by (params, x, name) alone."""
    return functools.partial(linear_apply, policy=policy, training=training, backend=backend)


def linear_apply(
    params: dict,
    x: torch.Tensor,
    *,
    name: str,
    policy: PrecisionPolicy,
    training: bool = False,
    backend: str = "auto",
    bias: torch.Tensor | None = None,
    activation: str = "none",
    x_f32: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a (possibly bit-serial) linear layer. x: (..., d_in).

    ``x_f32``: x's value before its rounding to x's dtype, when known
    (the gate*up product); the activation quantizer reads it, as the
    reference's compiled graph does (XLA keeps the fused product's excess
    precision into the quantizer)."""
    prec = policy.lookup(name)

    if "w_q" in params:  # stored-quantized weights (serving path)
        if not prec.active:
            raise ValueError(f"layer {name}: quantized params but inactive policy")
        eff = policy.effective(prec)
        tp = current_tp()
        role = tp.role(name) if tp is not None else None
        shard = None if role is None else (tp.axis, tp.size, role)
        xsrc = x.to(torch.float32) if x_f32 is None else x_f32
        if role == "row":
            return _row_parallel(params, x, xsrc, tp, eff, prec, name=name, policy=policy,
                                 backend=backend, shard=shard, bias=bias,
                                 activation=activation)
        xq = quantize(xsrc, eff.a_bits, axis=-1, reciprocal_scale=True)
        plan = plan_mod.make_plan(
            policy, name, (tuple(x.shape), tuple(params["w_q"].shape)), backend,
            device=x.device,
            w_planes=params.get("w_planes"),
            w_stored_bits=prec.w_bits,
            has_epilogue=True,
            accum_dtype=_accum_dtype(eff.w_bits, eff.a_bits),
            shard=shard,
        )
        out = plan(
            xq.values,
            params["w_q"],
            w_planes=params.get("w_planes"),
            epilogue=ops.Epilogue(
                a_scale=xq.scale,
                w_scale=params["w_scale"],
                bias=bias,
                activation=activation,
                out_dtype=x.dtype,
            ),
        )
        # the vocab-parallel head: the sampler reads the whole vocab
        return tp.gather_columns(out) if role == "vocab" else out

    w = params["w"]
    if not prec.active:
        return _finish_dense(x @ w.to(x.dtype), bias, activation, x.dtype)

    if training:
        # QAT; the activation quantizer reads the unrounded gate*up product,
        # as in the reference's compiled train step. A row-parallel block
        # of a sharded train step takes both amax over the model row
        red = params.get("amax_reduce")
        wq = fake_quant(w.to(torch.float32), prec.w_bits, axis=0, amax_reduce=red).to(w.dtype)
        xsrc = x.to(torch.float32) if x_f32 is None else x_f32
        xq = fake_quant(xsrc, prec.a_bits, axis=-1, amax_reduce=red).to(x.dtype)
        y = (xq @ wq.to(x.dtype)).to(x.dtype)
        return _finish_dense(y, bias, activation, x.dtype)

    # on-the-fly quantized inference from dense weights: both operands
    # quantize at the effective width (no stored decomposition to truncate)
    eff = policy.effective(prec)
    wq = quantize(w.to(torch.float32), eff.w_bits, axis=0, reciprocal_scale=True)
    xsrc = x.to(torch.float32) if x_f32 is None else x_f32
    xq = quantize(xsrc, eff.a_bits, axis=-1, reciprocal_scale=True)
    plan = plan_mod.make_plan(
        policy, name, (tuple(x.shape), tuple(w.shape)), backend,
        device=x.device,
        w_stored_bits=eff.w_bits,
        has_epilogue=True,
        accum_dtype=_accum_dtype(eff.w_bits, eff.a_bits),
    )
    return plan(
        xq.values,
        wq.values,
        epilogue=ops.Epilogue(
            a_scale=xq.scale, w_scale=wq.scale, bias=bias,
            activation=activation, out_dtype=x.dtype,
        ),
    )
