"""Collectives with their gradients, for training on a ``(data, model)``
mesh (``launch/mesh.Mesh``): the explicit counterparts of what GSPMD
inserts for the reference's sharded train step.

Each is a ``torch.autograd.Function`` over one process group of the mesh
(a row or a column, or None: a group of one, where the collective is the
identity):

* :func:`all_gather` — the whole of a leaf from its blocks; the backward
  reduce-scatters (FSDP over ``data``, and a weight gathered over
  ``model`` inside a region whose gradients are partial sums), or takes
  this rank's block (``bwd="slice"``: every rank of the group computed the
  same gradient);
* :func:`enter` — identity forward, all-reduce backward (a replicated
  activation or weight entering a tensor-parallel region: a
  column-parallel input);
* :func:`reduce` — all-reduce forward, identity backward (a row-parallel
  output leaving the region);
* :func:`reduce_scatter` — the sum scattered over the group (the MoE
  combine over a sharded sequence), all-gather backward;
* :func:`mean` — the mean over the group forward, the gradient divided by
  its size backward (the MoE aux loss over the batch axes);
* :func:`scale_grad` — identity forward, the gradient scaled backward.

Sums run in float32 and are cast back to the tensor's dtype once. Each
runs inside a ``torch.profiler`` range named by its caller
(``train.allgather``, ``train.reduce_scatter``, ``train.allreduce``,
``moe.ep_gather``, ``moe.ep_combine``), so a trace gives their share of
a step. A collective that fails raises: nothing falls back to one rank.

Every collective of the port — these and ``sharding/tp.py``'s — goes
through :func:`note`: under :func:`recording` (``launch/cost.py``'s
report) each call is handed to the recorder with its kind (the
reference's name: ``all-gather``, ``reduce-scatter``, ``all-reduce``),
operand bytes, group size and range name, as the function
it computes (gloo's reduce-scatter, an all-reduce and a slice, is
recorded as a reduce-scatter). A :class:`DryGroup` stands in for a
process group in a dry run: it knows its size and this rank's index, and
a collective over it is recorded and returns an output of the right
shape without communicating.

:class:`LeafLayout` gives the optimizer's per-leaf reductions their
groups: a reduction over a sharded dim (Adafactor's means, the clip's
sum of squares, the compressor's amax) runs over the ranks that hold the
leaf's blocks, and a replicated leaf counts once.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import tree as tr


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A process group's stand-in for a dry run (no process group): ``size``
    ranks, this one at ``rank`` within it."""

    size: int
    rank: int = 0


_RECORDER: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "collective_recorder", default=None)


@contextlib.contextmanager
def recording(fn: Callable):
    """Hand every collective of the block to ``fn(kind, operand_bytes,
    group_size, name)``."""
    token = _RECORDER.set(fn)
    try:
        yield fn
    finally:
        _RECORDER.reset(token)


def note(kind: str, t: torch.Tensor, size: int, name: str) -> None:
    """Record one collective over ``size`` ranks whose operand is ``t``."""
    fn = _RECORDER.get()
    if fn is not None:
        fn(kind, t.numel() * t.element_size(), size, name)


def _dry(group) -> bool:
    return isinstance(group, DryGroup)


def _size(group) -> int:
    if group is None:
        return 1
    return group.size if _dry(group) else dist.get_world_size(group)


def _rank(group) -> int:
    return group.rank if _dry(group) else dist.get_rank(group)


def _nccl(group) -> bool:
    return not _dry(group) and dist.get_backend(group) == "nccl"


def _gather(t: torch.Tensor, dim: int, group, name: str = "train.allgather") -> torch.Tensor:
    n = _size(group)
    t = t.contiguous()
    note("all-gather", t, n, name)
    if _dry(group):
        return torch.cat([t] * n, dim=dim)
    if _nccl(group) and dim == 0:
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _scatter_sum(t: torch.Tensor, dim: int, group,
                 name: str = "train.reduce_scatter") -> torch.Tensor:
    """This rank's block of the float32 sum of ``t`` over the group."""
    n, me = _size(group), _rank(group)
    tf = t.to(torch.float32)
    note("reduce-scatter", tf, n, name)
    if _dry(group):
        size = tf.shape[dim] // n
        return tf.narrow(dim, me * size, size).clone()
    if _nccl(group):
        moved = tf.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                          dtype=torch.float32, device=t.device)
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out.movedim(0, dim)
    # gloo: an all-reduce, then this rank's block
    tf = tf.clone() if tf is t else tf
    dist.all_reduce(tf, group=group)
    size = tf.shape[dim] // n
    return tf.narrow(dim, me * size, size)


def _sum(t: torch.Tensor, group, name: str = "train.allreduce") -> torch.Tensor:
    out = t.to(torch.float32)
    out = out.clone() if out is t else out
    note("all-reduce", out, _size(group), name)
    if not _dry(group):
        dist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, bwd, name):
        ctx.dim, ctx.group, ctx.bwd, ctx.name = dim, group, bwd, name
        ctx.block = t.shape[dim]
        with record_function(name):
            return _gather(t, dim, group, name)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "slice":
            me = _rank(ctx.group)
            return g.narrow(ctx.dim, me * ctx.block, ctx.block).contiguous(), None, None, None, None
        with record_function("train.reduce_scatter"):
            return _scatter_sum(g, ctx.dim, ctx.group).to(g.dtype), None, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with record_function("train.allreduce"):
            return _sum(g, ctx.group).to(g.dtype), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, name):
        with record_function(name):
            return _sum(t, group, name).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, name):
        ctx.dim, ctx.group = dim, group
        with record_function(name):
            return _scatter_sum(t, dim, group, name).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        with record_function("train.allgather"):
            return _gather(g, ctx.dim, ctx.group), None, None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.n = _size(group)
        with record_function("train.allreduce"):
            return (_sum(t, group) / ctx.n).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, factor):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def all_gather(t: torch.Tensor, dim: int, group, *, bwd: str = "sum",
               name: str = "train.allgather") -> torch.Tensor:
    """The group's blocks of ``t`` concatenated on ``dim`` in group-rank
    order. Backward: ``"sum"`` reduce-scatters the gradient, ``"slice"``
    takes this rank's block of it."""
    if _size(group) == 1:
        return t
    return _AllGather.apply(t, dim, group, bwd, name)


def enter(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over the group backward."""
    if _size(group) == 1:
        return t
    return _Enter.apply(t, group)


def reduce(t: torch.Tensor, group, *, name: str = "train.allreduce") -> torch.Tensor:
    """The sum over the group (float32, cast back once); identity backward."""
    if _size(group) == 1:
        return t
    return _Reduce.apply(t, group, name)


def reduce_scatter(t: torch.Tensor, dim: int, group, *,
                   name: str = "train.reduce_scatter") -> torch.Tensor:
    """This rank's block on ``dim`` of the sum over the group; all-gather
    backward."""
    if _size(group) == 1:
        return t
    return _ReduceScatter.apply(t, dim, group, name)


def mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group; backward divides the gradient by the
    group's size (each rank adds its own term once)."""
    if _size(group) == 1:
        return t
    return _Mean.apply(t, group)


def scale_grad(t: torch.Tensor, factor: float) -> torch.Tensor:
    """Identity forward; the gradient times ``factor`` backward."""
    if factor == 1.0:
        return t
    return _ScaleGrad.apply(t, factor)


@torch.no_grad()
def all_reduce_(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """In-place all-reduce without a gradient (``op``: SUM by default)."""
    if _size(group) > 1:
        note("all-reduce", t, _size(group), "train.allreduce")
        if not _dry(group):
            with record_function("train.allreduce"):
                dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


# --------------------------------------------------------------------------
# Per-leaf reductions for the optimizer
# --------------------------------------------------------------------------


def spec_axes(spec, dims=None) -> tuple:
    """The mesh axes a spec shards ``dims`` over (every dim: None)."""
    out = []
    for i, entry in enumerate(spec):
        if dims is not None and i not in dims:
            continue
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """The mesh and the specs of a tree's leaves, in pytree order: the
    optimizer's reductions over a leaf or over some of its dims run over
    the ranks that hold its blocks (an unsharded reduction is local)."""

    mesh: object
    specs: list

    def _dims(self, i: int, dims, ndim: int):
        spec = list(self.specs[i]) + [None] * (ndim - len(self.specs[i]))
        if dims is None:
            return spec, None
        return spec, {d % ndim for d in dims}

    def group(self, i: int, ndim: int, dims=None):
        spec, ds = self._dims(i, dims, ndim)
        axes = spec_axes(spec, ds)
        return self.mesh.group(axes) if axes else None

    def extent(self, i: int, ndim: int, dims=None) -> int:
        spec, ds = self._dims(i, dims, ndim)
        return self.mesh.extent(spec_axes(spec, ds))

    def sum_(self, t: torch.Tensor, i: int, ndim: int, dims=None) -> torch.Tensor:
        """``t`` (a partial sum over ``dims`` of leaf ``i``) summed over
        the ranks holding those dims' blocks, in place."""
        return all_reduce_(t, self.group(i, ndim, dims))


def layout_of(mesh, specs) -> Optional[LeafLayout]:
    """A :class:`LeafLayout` of a spec tree, or None without a mesh."""
    return None if mesh is None else LeafLayout(mesh, tr.leaves(specs))
