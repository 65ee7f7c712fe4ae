"""Error-feedback int8 gradient compression.

Gradients are quantized to int8 with one per-tensor scale (the symmetric
quantizer of the bit-serial path) and the quantization residual is kept
in an error buffer and sent again with the next step's gradients, so
information lost in one step is not lost for good. ``compress_tree(grads,
err)`` before the reduce, ``decompress_tree`` after. The arithmetic is the
reference's compiled form, bit for bit on the host.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core import tree as tr


def compress_leaf(g: torch.Tensor, bits: int = 8, amax=None):
    """(int8 values, float32 scale) with scale = max|g| / qmax (``amax``:
    max|g| given, the maximum over every block of a sharded leaf)."""
    qmax = (1 << (bits - 1)) - 1
    amax = g.abs().amax() if amax is None else amax
    scale = torch.clamp_min(amax, 1e-12) / qmax
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error(grads):
    return tr.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_tree(grads, error, bits: int = 8, layout=None):
    """Returns (quantized tree, scales tree, new error tree): each leaf
    compresses ``g + e`` and keeps what the int8 values miss. ``layout``
    (a sharded tree's ``LeafLayout``): each leaf's amax is the maximum over
    every rank holding a block of it."""
    from repro_torch.optim.adamw import _grouped

    g_leaves = tr.leaves(grads)
    targets = [g.to(torch.float32) + e for g, e in zip(g_leaves, tr.leaves(error))]
    amaxes = [t.abs().amax() for t in targets]
    amaxes = _grouped(amaxes, layout, g_leaves, dist.ReduceOp.MAX)

    def one(target, amax):
        q, scale = compress_leaf(target, bits, amax)
        # target - q * scale in one rounding: XLA's contraction into an FMA
        return q, scale, torch.addcmul(target, q.to(torch.float32), -scale)

    outs = [one(t, a) for t, a in zip(targets, amaxes)]
    return tuple(tr.unflatten_like(grads, [o[i] for o in outs]) for i in range(3))


def decompress_tree(qs, scales, dtype=torch.float32):
    return tr.tree_map(lambda q, s: decompress_leaf(q, s).to(dtype), qs, scales)


def compressed_bytes(grads, bits: int = 8) -> int:
    """Wire bytes of the compressed gradients."""
    return sum(math.prod(leaf.shape) for leaf in tr.leaves(grads)) * bits // 8
