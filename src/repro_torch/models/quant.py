"""Parameter-tree quantization for the serving path.

Converts dense linear weights to stored-quantized form
(``{'w_q','w_scale'}``) per the :class:`PrecisionPolicy`; with
``plane_cache=True`` each quantized weight is also decomposed once into
its bit/digit planes (packed int32 words at bit-plane level, blocked
layout) and rides in the tree as ``'w_planes'``. Weights are quantized
and decomposed at the configured (storage) width, so one tree serves
every runtime precision at or below it.

Policy lookups use the reference's parameter-tree paths: the port keeps
its layers in a list, and layer ``i`` is looked up at its path in the
reference's tree (``ModelConfig.param_path``: ``/periods/b<j>_<kind>/...``
in a scanned period, ``/tail/<t>/...`` in the tail, ``/layers/<i>/...``
unrolled) — so a policy regex selects the same weights in both packages.
Only linears (a ``{'w'}`` of two or more axes) are quantized, as in the
reference: the conv taps, ``A_log``, ``D``, ``dt_bias`` and ``lam`` stay
float32, and the MoE experts' stacked ``(E, d, f)`` arrays stay bf16 (the
layer fake-quantizes them per call). A policy that would quantize an MoE
router is refused (reference defect G: the reference quantizes it and its
layer then cannot read it).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core.plan import plan_cacheable
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.quantize import quantize


def _is_linear(node) -> bool:
    return isinstance(node, dict) and isinstance(node.get("w"), torch.Tensor) and node["w"].dim() >= 2


def decompose_linear_weight(
    w_q: torch.Tensor,
    *,
    w_bits: int,
    variant: str,
    level: str,
    block: int | None = bp.DEFAULT_BLOCK,
    checksum: bool = False,
) -> bp.WeightPlanes:
    """Decompose one stored-quantized ``(K, N)`` weight into cached planes."""
    return bp.make_weight_planes(
        w_q, w_bits=w_bits, variant=variant, level=level, block=block, checksum=checksum,
    )


def weight_precision(path: str, policy: PrecisionPolicy, value_bits: int | None = None):
    """The precision of the linear at ``path``, or None where the policy
    leaves it dense; raises where the policy quantizes an MoE router or
    ``value_bits`` is outside the storage width."""
    prec = policy.lookup(path)
    if not prec.active:
        return None
    if path.endswith("/moe/router"):
        raise ValueError(
            f"layer {path}: the policy quantizes an MoE router, which the "
            "layer reads dense (the reference quantizes it and its moe_apply "
            "then fails on router['w']: reference defect G); keep it dense "
            "with keep_dense=('router',) — the reference's serving policy "
            "keeps ('frontend', 'router')"
        )
    if value_bits is not None and not 1 <= value_bits <= prec.w_bits:
        raise ValueError(
            f"layer {path}: value_bits must be in [1, {prec.w_bits}] "
            f"(the configured storage width), got {value_bits}"
        )
    return prec


def weight_plane_cache(w_q: torch.Tensor, prec, policy: PrecisionPolicy,
                       compact: bool = True) -> bp.WeightPlanes:
    """The plane cache of ``w_q`` (checksummed under integrity), compacted
    under ``sparsity="compact"`` unless ``compact`` is False."""
    wp = decompose_linear_weight(
        w_q, w_bits=prec.w_bits, variant=policy.variant, level=policy.level,
        checksum=policy.integrity != "off",
    )
    if compact and policy.sparsity == "compact" and policy.level == "bitplane":
        wp = bp.compact_weight_planes(wp)
    return wp


def map_linears(params, cfg, fn, *, path: str = "", leaf=None):
    """The tree with every linear (a ``{'w'}`` of two or more axes) replaced
    by ``fn(node, path)``, ``path`` its path in the reference's tree, and
    every other leaf by ``leaf(leaf)`` (default: kept). ``path``: the
    tree's own path when it is one part of the whole (a layer's is
    ``cfg.param_path(i)``)."""

    def rec(node, path):
        if _is_linear(node):
            return fn(node, path)
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "layers" and path == "" and isinstance(v, list):
                    out[k] = [rec(blk, cfg.param_path(i)) for i, blk in enumerate(v)]
                else:
                    out[k] = rec(v, f"{path}/{k}")
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, f"{path}/{i}") for i, v in enumerate(node))
        return node if leaf is None else leaf(node)

    return rec(params, path)


def quantize_params(
    params,
    policy: PrecisionPolicy,
    *,
    cfg,
    plane_cache: bool = False,
    value_bits: int | None = None,
):
    """Walk the parameter tree, converting policy-active linears.

    ``cfg`` (a :class:`~repro_torch.models.config.ModelConfig`) names each
    layer's path as the reference's tree does (``cfg.param_path``), which
    the policy's lookups key on; a tree without a ``layers`` list (one
    layer, a head) never reads it and may pass None. ``value_bits`` quantizes the weight values
    narrower than the storage width (a narrow checkpoint served from the
    wide cache). With ``policy.sparsity == "compact"`` each bit-plane cache
    drops its all-zero planes at load
    (:func:`~repro_torch.core.bitplanes.compact_weight_planes`)."""

    def one(node, path):
        prec = weight_precision(path, policy, value_bits)
        if prec is None:
            return node
        q = quantize(node["w"].to(torch.float32), value_bits or prec.w_bits, axis=-2)
        out = {"w_q": q.values, "w_scale": q.scale}
        if plane_cache and plan_cacheable(policy, prec):
            out["w_planes"] = weight_plane_cache(q.values, prec, policy)
        return out

    return map_linears(params, cfg, one)
