"""Logical-axis sharding rules (the port of ``src/repro/sharding/rules.py``):
parameter specs by path, activation and batch specs by logical name, for
any mesh built by ``launch/mesh.py``.

Axis roles, the reference's:

* ``data``: data parallel and FSDP (parameters and optimizer state are
  sharded over it and gathered layer by layer);
* ``model``: tensor parallel (heads, ffn, vocab), expert parallel (the
  MoE expert dim) and sequence parallel;
* ``pod``: pure data parallel across pods (parameters are not sharded
  over it).

A spec is a :class:`P`: one entry per dim, each an axis name, a tuple of
names or None (replicated). An axis whose extent does not divide the dim
is dropped, never an error. Where the reference hands specs to GSPMD,
the port cuts each leaf itself: :func:`shard_leaf` takes a rank's block,
:func:`gather_leaf` puts the blocks back together, and
``sharding/fsdp.py`` runs the training step on the blocks with explicit
collectives.
"""

from __future__ import annotations

import contextvars
import dataclasses
import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as tr


class P:
    """A partition spec: one entry per dim (an axis name, a tuple of
    names, or None; a tuple of one name is that name, as JAX's
    ``PartitionSpec`` canonicalizes it). A leaf of a tree (not a sequence
    of it), so trees of specs walk like trees of tensors."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                           for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.parts == other.parts
        if isinstance(other, tuple):
            return self.parts == other
        return NotImplemented

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"

    def __reduce__(self):
        return (P, self.parts)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Resolved logical -> mesh-axis mapping for one mesh (built by
    :func:`rules_for_mesh`, installed with :class:`use_rules`)."""

    mesh: object
    batch_axes: Tuple[str, ...]
    fsdp_axis: Optional[str]
    model_axis: Optional[str]
    seq_shard: bool = True


_RULES: contextvars.ContextVar[Optional[MeshRules]] = contextvars.ContextVar(
    "mesh_rules", default=None
)


def rules_for_mesh(mesh, *, seq_shard: bool = True) -> MeshRules:
    """:class:`MeshRules` from a mesh's axis names: ``pod`` / ``data`` /
    ``model``; an absent axis resolves to replicated."""
    names = mesh.axis_names
    return MeshRules(
        mesh=mesh,
        batch_axes=tuple(a for a in ("pod", "data") if a in names),
        fsdp_axis="data" if "data" in names else None,
        model_axis="model" if "model" in names else None,
        seq_shard=seq_shard,
    )


class use_rules:
    """Context manager installing the mesh rules (``use_rules(None)``
    turns every resolver into replication)."""

    def __init__(self, rules: Optional[MeshRules]):
        self.rules = rules

    def __enter__(self):
        self._token = _RULES.set(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _RULES.reset(self._token)


def current_rules() -> Optional[MeshRules]:
    """The installed :class:`MeshRules`, or None."""
    return _RULES.get()


def _axis_size(mesh, axes) -> int:
    return mesh.extent(axes)


def _resolve(logical, rules: MeshRules):
    if logical == "batch":
        return rules.batch_axes or None
    if logical == "seq":
        return rules.model_axis if rules.seq_shard else None
    if logical == "vocab" or logical == "model":
        return rules.model_axis
    if logical == "fsdp":
        return rules.fsdp_axis
    return None


# --------------------------------------------------------------------------
# Parameter sharding by path
# --------------------------------------------------------------------------

# (regex on the param path, logical spec for the trailing dims)
_PARAM_RULES = [
    (r"embed/embedding$", ("vocab", "fsdp")),
    (r"lm_head/head/w$", ("fsdp", "vocab")),
    (r"frontend/proj/w$", (None, "fsdp")),
    (r"(attn/q_proj|attn/k_proj|attn/v_proj)/w$", ("fsdp", "model")),
    (r"attn/o_proj/w$", ("model", "fsdp")),
    (r"(mlp/gate_proj|mlp/up_proj)/w$", ("fsdp", "model")),
    (r"mlp/down_proj/w$", ("model", "fsdp")),
    (r"moe/router/w$", ("fsdp", None)),
    (r"moe/(gate|up)$", ("model", "fsdp", None)),
    (r"moe/down$", ("model", None, "fsdp")),
    (r"ssm/in_proj/w$", ("fsdp", None)),
    (r"ssm/out_proj/w$", ("model", "fsdp")),
    (r"rglru/(in_x|in_y)/w$", ("fsdp", "model")),
    (r"rglru/out/w$", ("model", "fsdp")),
    (r"rglru/(gate_a|gate_x)/w$", (None, "model")),
    (r"rglru/(conv_w|conv_b|lam)$", (None,)),
    # quantized-weight variants mirror their dense counterparts
    (r"(attn/q_proj|attn/k_proj|attn/v_proj)/w_q$", ("fsdp", "model")),
    (r"attn/o_proj/w_q$", ("model", "fsdp")),
    (r"(mlp/gate_proj|mlp/up_proj)/w_q$", ("fsdp", "model")),
    (r"mlp/down_proj/w_q$", ("model", "fsdp")),
    (r"lm_head/head/w_q$", ("fsdp", "vocab")),
    (r"w_scale$", (None, "model")),
]


def param_spec(path: str, arr) -> P:
    """The spec of one parameter leaf (anything with ``shape``), padded
    with leading Nones for stacked (scanned) leaves; an axis that does not
    divide its dim is dropped."""
    rules = _RULES.get()
    if rules is None:
        return P()
    shape = tuple(getattr(arr, "shape", ()))
    for pattern, logical in _PARAM_RULES:
        if re.search(pattern, path):
            base = [_resolve(x, rules) for x in logical]
            break
    else:
        base = [None] * len(shape)
    lead = [None] * (len(shape) - len(base))
    final = []
    for i, axes in enumerate(lead + base):
        if axes is None:
            final.append(None)
            continue
        size = _axis_size(rules.mesh, axes)
        if i < len(shape) and shape[i] % size == 0 and shape[i] >= size:
            final.append(axes)
        else:
            final.append(None)
    return P(*final)


def tree_param_specs(params):
    """The tree of :class:`P` matching a parameter tree (paths joined by
    ``/`` as the reference's ``_path_str``)."""
    pairs = tr.flatten_with_path(params)
    return tr.unflatten_like(params, [param_spec(tr.path_key(p), leaf) for p, leaf in pairs])


# --------------------------------------------------------------------------
# Batch / cache specs
# --------------------------------------------------------------------------

_BATCH_LOGICAL = {
    "tokens": ("batch", None),
    "targets": ("batch", None),
    "loss_mask": ("batch", None),
    "features": ("batch", None, None),
    "patches": ("batch", None, None),
}


def batch_specs(batch_tree):
    """The specs of an input batch: data parallel over the leading dim
    where it divides, every other dim replicated."""
    rules = _RULES.get()

    def leaf_spec(path, leaf):
        name = tr.path_key(path).split("/")[-1]
        logical = _BATCH_LOGICAL.get(name, ("batch",) + (None,) * (leaf.ndim - 1))
        spec = []
        for dim, lg in zip(leaf.shape, logical):
            axes = _resolve(lg, rules) if rules else None
            if axes is not None and dim % _axis_size(rules.mesh, axes) == 0:
                spec.append(axes)
            else:
                spec.append(None)
        return P(*spec)

    pairs = tr.flatten_with_path(batch_tree)
    return tr.unflatten_like(batch_tree, [leaf_spec(p, leaf) for p, leaf in pairs])


def cache_spec(path: str, leaf) -> P:
    """KV caches ``(B, S, Hkv, D)`` with S over model (the flash-decode
    layout); SSM / LRU states with heads or width over model; scalars
    replicated."""
    rules = _RULES.get()
    ndim = len(getattr(leaf, "shape", ()))
    if rules is None or ndim == 0:
        return P()
    name = path.split("/")[-1]
    if name in ("k", "v", "k_q", "v_q"):
        base = ["batch", "seq_kv", None, None]
    elif name in ("k_scale", "v_scale"):
        base = ["batch", "seq_kv", None]
    elif name == "state":
        base = ["batch", "model", None, None]
    elif name == "conv":
        base = ["batch", None, "model"]
    elif name == "h":
        base = ["batch", "model"]
    else:
        return P(*([None] * ndim))
    spec = [None] * (ndim - len(base)) + base
    final = []
    for i, lg in enumerate(spec):
        if lg is None:
            final.append(None)
            continue
        axes = rules.model_axis if lg in ("seq_kv", "model") else _resolve(lg, rules)
        size = _axis_size(rules.mesh, axes) if axes else 1
        if axes is not None and leaf.shape[i] % size == 0 and leaf.shape[i] >= size:
            final.append(axes)
        else:
            final.append(None)
    return P(*final)


def tree_cache_specs(cache_tree):
    """The specs of a decode cache, leaf by leaf (:func:`cache_spec`)."""
    pairs = tr.flatten_with_path(cache_tree)
    return tr.unflatten_like(cache_tree,
                             [cache_spec(tr.path_key(p), leaf) for p, leaf in pairs])


# --------------------------------------------------------------------------
# Cutting a tree into a rank's blocks and putting it back
# --------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_leaf(full, spec: P, mesh):
    """This rank's block of ``full`` (a tensor or numpy array): each dim
    cut into equal blocks over its axes, taking the block at this rank's
    index on them. A view where the cut allows it."""
    out = full
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        n = mesh.extent(axes)
        size = out.shape[dim] // n
        lo = mesh.index(axes) * size
        idx = [slice(None)] * len(out.shape)
        idx[dim] = slice(lo, lo + size)
        out = out[tuple(idx)]
    return out


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def gather_leaf(block: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``block`` (all-gathers over the
    axes of each sharded dim; every rank of the mesh calls it)."""
    out = block
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes or mesh.extent(axes) == 1:
            continue
        # the axes of one dim, innermost last: gather the last axis first
        for a in reversed(axes):
            if mesh.shape[a] > 1:
                out = _all_gather(out, dim, mesh.group(a), mesh.shape[a])
    return out


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` cut to this rank's block (:func:`shard_leaf`)."""
    return tr.tree_map(lambda leaf, spec: shard_leaf(leaf, spec, mesh), tree, specs)


def gather_tree(tree, specs, mesh, to=None, root=None):
    """The whole tree from every rank's blocks, leaf by leaf; ``to``: the
    device each whole leaf is moved to as soon as it is gathered. With
    ``root`` (a rank) only that rank keeps the whole leaves: the others
    take part in each leaf's gathers, drop the result at once and return
    None."""
    keep = root is None or mesh.rank == root

    def one(leaf, spec):
        full = gather_leaf(leaf, spec, mesh)
        if not keep:
            return None
        return full if to is None else full.to(to)

    out = tr.tree_map(one, tree, specs)
    return out if keep else None
