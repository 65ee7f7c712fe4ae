"""Tensor-parallel serving of the packed bit-plane stack on
``torch.distributed`` (the port of ``src/repro/sharding/tp.py``).

One process per rank, every rank running the same engine loop on its own
shard (SPMD). The quantized parameter tree is laid out per rank on load
and the serving steps run under :meth:`TPContext.scope`, where
:func:`~repro_torch.layers.linear.linear_apply` finds the context and puts
the collectives where the reference puts ``psum``, ``pmax`` and
``all_gather``. The split is Megatron's, specialised to the plane cache:

* **column-parallel** (``q/k/v/gate/up``): the output dim N is sharded —
  each rank holds ``w_q[:, n0:n1]``, its own plane decomposition of that
  slice and the matching ``w_scale`` columns. No collective: outputs stay
  sharded (heads for attention, ffn columns for the MLP).
* **row-parallel** (``o/down``): the input dim K is sharded — each rank
  holds ``w_q[k0:k1, :]`` and its decomposition; ``w_scale`` replicates.
  The activation is quantized with the scale of the whole row (an
  all-reduce MAX of the per-rank |x| maxima), the plan runs without an
  epilogue, the raw int32 accumulators are all-reduced (SUM; exact: at
  <= 8 bits ``|sum| <= 128 * 128 * K < 2^31`` for K up to 12800, so
  nothing wraps), and the dequant epilogue runs once, after the sum.
* **vocab-parallel** (``lm_head/head``): column-sharded like the
  column-parallel set; the sharded logits are gathered (all-gather, the
  ranks' columns concatenated in rank order) so the replicated sampler
  sees the whole vocab.
* **KV head-parallel**: each rank's cache holds ``n_kv_heads / P`` heads
  (:meth:`TPContext.local_config`); attention is head-local.

The quantized values are the reference's, which quantizes **globally
first** (per-output-channel scales over the full K), then slices, then
decomposes per rank, with checksums under integrity. Here the dense
weight is sliced first, on the device it was handed on (the host, for a
model larger than one card), and only the rank's slice reaches the rank's
device: a column slice holds whole columns, so its own scales are the
global ones; a row slice's column maxima are maximized over the ranks (an
all-reduce) before it is quantized. The integers and scales are the same
bits. Under
``sparsity="compact"`` the kept-plane set of a weight is the global one:
a plane is kept where it is non-zero in any rank's slice (an all-reduce
of the ranks' occupancy), never from one slice alone.

Where the reference stacks every shard on a leading axis of one tree and
``shard_map`` hands each device its slice, each rank here holds only its
own shard tree (:func:`shard_quantized`); :func:`shard_quantized_all`
builds every rank's in one process, the form the tests hold against the
reference's stacked leaves. As the port's ``quantize_params`` does, a
layer's plane cache is compacted on its own (the reference's scanned stack
keeps the planes alive in any of its layers).

Every other linear replicates whole, as in the reference, which shards
only the names above: the SSM's and the RG-LRU's projections, the MoE
router and experts, the VLM's front end. A dense (unquantized) vocab head
replicates too and computes the whole vocabulary on every rank; a dense
column- or row-parallel projection is refused (:func:`dense_sharded_error`,
reference defect I). :func:`load_shard` draws a model one part at a time
and keeps only the rank's shard of each, so no rank ever holds the whole
dense tree; with ``with_source`` a rank also keeps its scrub source (its
dense slices, each row slice with its column maxima, and the replicated
leaves), from which :func:`shard_source` rebuilds the shard bit for bit.
:class:`RankTuner` makes rank 0's tile autotuner the picks of every rank.

A context whose ``group`` is a ``sharding/collectives.DryGroup`` is a dry
run's (``launch/dryrun.py``): its collectives are recorded
(``collectives.note``, as a live context's are) and return outputs of the
right shape without communicating, and it lays out heads the ranks do not
divide (:func:`head_layout`), which serving refuses.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, ClassVar, Optional

import torch
import torch.distributed as dist

from repro_torch.core import bitplanes as bp
from repro_torch.sharding.collectives import DryGroup, note

#: parameter-path suffixes whose output dim is sharded
COL_PARALLEL = frozenset({"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"})
#: parameter-path suffixes whose input dim is sharded (deferred epilogue)
ROW_PARALLEL = frozenset({"o_proj", "down_proj"})
#: vocab-parallel heads: column-sharded, the logits gathered after the
#: product. "head" is the parameter-tree component (``lm_head/head/w_q``),
#: "lm_head" the layer name ``lm_head_apply`` passes to ``linear_apply``.
VOCAB_PARALLEL = frozenset({"head", "lm_head"})

#: KV-cache leaf names sharded on their head axis
_KV_VALUE_LEAVES = frozenset({"k", "v", "k_q", "v_q"})
_KV_SCALE_LEAVES = frozenset({"k_scale", "v_scale"})


#: the attention projections, replicated whole where the query heads do
#: not divide the ranks (a dry run's layout, :func:`head_layout`)
ATTENTION = frozenset({"q_proj", "k_proj", "v_proj", "o_proj"})

#: the widest operands the row-parallel int32 partial sums hold exactly
MAX_TP_BITS = 8


def check_exact_bits(a_bits: int, w_bits: int) -> None:
    """Refuse operands wider than :data:`MAX_TP_BITS` (the reference's
    message): their row-parallel partial sums would not be exact in int32."""
    if max(a_bits, w_bits) > MAX_TP_BITS:
        raise ValueError(
            "model_parallel > 1 requires <= 8-bit operands: the row-parallel "
            "partial sums must accumulate exactly in int32 for the psum to be "
            "bit-identical"
        )


def tp_role(name: str) -> Optional[str]:
    """Classify a layer or parameter path: "col", "row", "vocab" or None
    (replicated), by its last component."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf in COL_PARALLEL:
        return "col"
    if leaf in ROW_PARALLEL:
        return "row"
    if leaf in VOCAB_PARALLEL:
        return "vocab"
    return None


def head_layout(cfg, size: int) -> tuple[str, frozenset, int, int]:
    """The attention layout of ``size`` ranks: (description, the projections
    replicated whole, a rank's query heads, its KV heads). Heads that
    divide the ranks are sharded (serving's only layout); KV heads that do
    not, where each rank's query heads read one KV head, are each kept by
    the ranks that read it (the Megatron GQA rule); query heads that do not
    divide run whole on every rank (q/k/v/o replicated, the cache holding
    every head)."""
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    if nh % size == 0 and nkv % size == 0:
        return "heads sharded", frozenset(), nh // size, nkv // size
    if nh % size == 0 and (nh // nkv) % (nh // size) == 0:
        return "query heads sharded, one KV head a rank", frozenset(), nh // size, 1
    return "attention replicated", ATTENTION, nh, nkv


@dataclasses.dataclass(frozen=True)
class TPContext:
    """One tensor-parallel serving configuration: ``size`` ranks of the
    process group ``group`` (None: the default group; a ``DryGroup``: a dry
    run), this process being ``rank``. The collectives run in an
    initialised process group (a world of one included: a CUDA graph then
    captures them as it would for more ranks); with no process group a
    context of size 1 makes them the identity. ``replicated``: projection
    names that run whole on every rank (:func:`head_layout`; a dry run's)."""

    size: int
    rank: int = 0
    group: Any = None
    replicated: frozenset = frozenset()
    #: the axis name a plan's shard triple carries, the reference's
    axis: ClassVar[str] = "model"

    def role(self, name: str) -> Optional[str]:
        """The projection's role under this context (:func:`tp_role`)."""
        if name.rsplit("/", 1)[-1] in self.replicated:
            return None
        return tp_role(name)

    @property
    def dry(self) -> bool:
        return isinstance(self.group, DryGroup)

    # -- ambient scope -----------------------------------------------------

    @contextlib.contextmanager
    def scope(self):
        """Install this context while a step body runs."""
        token = _TP.set(self)
        try:
            yield self
        finally:
            _TP.reset(token)

    # -- model-side helpers ------------------------------------------------

    def local_config(self, cfg):
        """Per-rank model config: the head counts divide over the ranks;
        every other dimension follows from the sliced parameter shapes. A
        dry context takes :func:`head_layout`'s other layouts too."""
        if self.dry:
            _, _, nh, nkv = head_layout(cfg, self.size)
            return dataclasses.replace(cfg, n_heads=nh, n_kv_heads=nkv)
        if cfg.n_heads % self.size or cfg.n_kv_heads % self.size:
            raise ValueError(
                f"model_parallel={self.size} must divide n_heads="
                f"{cfg.n_heads} and n_kv_heads={cfg.n_kv_heads} "
                "(head-parallel attention + head-parallel KV cache)"
            )
        return dataclasses.replace(
            cfg, n_heads=cfg.n_heads // self.size, n_kv_heads=cfg.n_kv_heads // self.size,
        )

    # -- collectives ---------------------------------------------------------

    def _live(self) -> bool:
        if self.dry:
            return False
        if dist.is_available() and dist.is_initialized():
            return True
        if self.size > 1:
            raise RuntimeError(
                f"tensor-parallel size {self.size} needs an initialised process group "
                "(launch/mesh.init_tp_group or spawn_ranks)"
            )
        return False

    def _recorded(self, kind: str, t: torch.Tensor, name: str) -> bool:
        """Record a collective the step issues (a dry context's too);
        True where it must run."""
        live = self._live()
        if live or self.dry:
            note(kind, t, self.size, name)
        return live

    def _all_reduce(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        if self._recorded("all-reduce", t, name):
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def reduce_max(self, t: torch.Tensor, name: str = "tp.reduce_max") -> torch.Tensor:
        """Element-wise maximum of ``t`` over the ranks, in place (exact)."""
        return self._all_reduce(t, dist.ReduceOp.MAX, name)

    def reduce_alarms(self, alarms: torch.Tensor) -> torch.Tensor:
        """OR of a per-rank ABFT alarm vector over the ranks (all-reduce
        MAX), so every rank sees an alarm raised on any rank's planes."""
        if alarms.numel() == 0:
            return alarms
        return self.reduce_max(alarms.to(torch.int32), "tp.alarms").to(torch.bool)

    def global_amax(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row |x| maximum of a K-sharded activation over every rank's
        slice (keepdim; float32, whose maximum is exact): the row-parallel
        quantizer's scale is then the unsharded one."""
        return self.reduce_max(x.abs().amax(dim=-1, keepdim=True).to(torch.float32),
                               "tp.amax")

    def sum_partials(self, acc: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' raw int32 accumulators, in place (exact at
        <= 8 bits: no partial or total reaches 2^31)."""
        return self._all_reduce(acc, dist.ReduceOp.SUM, "tp.sum_partials")

    def gather_columns(self, out: torch.Tensor) -> torch.Tensor:
        """The ranks' column blocks of ``out`` concatenated in rank order on
        the last axis (list-form all-gather, which gloo takes on CUDA
        tensors too)."""
        if not (self.dry or self._live()):
            return out
        out = out.contiguous()
        if not self._recorded("all-gather", out, "tp.gather_columns"):
            return torch.cat([out] * self.size, dim=-1)  # a dry context's stand-in
        parts = [torch.empty_like(out) for _ in range(self.size)]
        dist.all_gather(parts, out, group=self.group)
        return torch.cat(parts, dim=-1)

    def reduce_max_host(self, values: list, device) -> list:
        """Element-wise maximum over the ranks of a list of host ints (one
        small all-reduce on ``device``, the group's)."""
        if not values or not self._live():
            return list(values)
        t = torch.tensor(values, dtype=torch.int64, device=device)
        return [int(v) for v in self.reduce_max(t).tolist()]

    def broadcast_host(self, values: list, device) -> list:
        """Rank 0's list of host floats on every rank (one small broadcast
        on ``device``, the group's; float64 carries a float exactly)."""
        if not values or not self._live():
            return list(values)
        t = torch.tensor(values, dtype=torch.float64, device=device)
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(t, src=src, group=self.group)
        return [float(v) for v in t.tolist()]

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (pickled)."""
        if not self._live():
            return obj
        box = [obj]
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    # -- layout descriptions ---------------------------------------------------

    def cache_specs(self, cache):
        """The tree of ``cache`` with each leaf replaced by the axis it is
        head-sharded on, or None where it replicates: KV value leaves
        ``(..., S, Hkv, D)`` on ``Hkv``, scale leaves ``(..., S, Hkv)`` on
        their last axis (dense slots and paged pools alike); lengths, step
        counters and block tables replicate. Raises where a head axis does
        not divide ``size``. The reference feeds these specs to
        ``shard_map``; the port has none (each rank allocates its own
        heads' cache from :meth:`local_config`), so only the tests call
        it, to hold the layout against the reference's."""

        def rec(node, name):
            if isinstance(node, dict):
                return {k: rec(v, k) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(rec(v, name) for v in node)
            if name in _KV_VALUE_LEAVES:
                axis = node.dim() - 2
            elif name in _KV_SCALE_LEAVES:
                axis = node.dim() - 1
            else:
                return None
            if node.shape[axis] % self.size:
                raise ValueError(
                    f"KV leaf {name!r} head axis {node.shape[axis]} does not "
                    f"divide model_parallel={self.size}"
                )
            return axis

        return rec(cache, None)


class RankTuner:
    """The tile tuner of a tensor-parallel rank (the ``PlanRegistry`` hook
    of ``core/autotune.PlanAutotuner``): rank 0's ``tuner`` alone times
    candidates and reads and writes the plan store; every other rank holds
    None. Each pick is broadcast to every rank as its plan resolves: the
    ranks resolve the same plans (their local shapes and shard triples) in
    the same order, in a step's eager warm-up, before any capture. So every
    rank plans the same tiles, and no rank reads the store while rank 0
    writes it. ``stats()`` is rank 0's counters, carried with each pick."""

    def __init__(self, tp: TPContext, tuner=None, store_path=None) -> None:
        self.tp = tp
        self.tuner = tuner
        self.store_path = store_path
        self._stats = tp.broadcast_object(None if tuner is None else tuner.stats())

    def tiles_for(self, key, kernel: str):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"plan {kernel} {key.m}x{key.k}x{key.n} resolved inside a CUDA-graph "
                "capture: its tiles are broadcast from rank 0, which a capture forbids; "
                "resolve every plan of a captured step in its eager warm-up"
            )
        msg = None
        if self.tuner is not None:
            msg = (self.tuner.tiles_for(key, kernel), self.tuner.stats())
        tiles, self._stats = self.tp.broadcast_object(msg)
        return tiles

    def stats(self) -> dict:
        return dict(self._stats)


_TP: contextvars.ContextVar[Optional[TPContext]] = contextvars.ContextVar(
    "tp_context", default=None
)


def current_tp() -> Optional[TPContext]:
    """The ambient :class:`TPContext` inside a tensor-parallel step, else
    None (single-device execution)."""
    return _TP.get()


# ---------------------------------------------------------------------------
# Quantized-tree relayout
# ---------------------------------------------------------------------------


class _PerRank(list):
    """A linear's (shard node, source node) pairs, one per rank asked for
    (split off by :func:`_pick`)."""


def _slice(t: torch.Tensor, axis: int, n: int, r: int) -> torch.Tensor:
    axis = axis % t.dim()
    if t.shape[axis] % n:
        raise ValueError(f"axis {axis} extent {t.shape[axis]} not divisible by {n} shards")
    step = t.shape[axis] // n
    return t.narrow(axis, r * step, step).contiguous()


def _pick(node, i: int, j: int):
    if isinstance(node, _PerRank):
        return node[i][j]
    if isinstance(node, dict):
        return {k: _pick(v, i, j) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_pick(v, i, j) for v in node)
    return node


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def dense_sharded_error(path: str) -> ValueError:
    """The refusal of a dense (unquantized) column- or row-parallel
    projection: the reference replicates such a weight whole while its
    local config divides the heads, and then fails on a shape (reference
    defect I)."""
    return ValueError(
        f"layer {path}: a dense (unquantized) column- or row-parallel projection "
        "cannot be served tensor-parallel: the reference replicates it whole while "
        "the local config divides the heads, and then fails on a shape (reference "
        "defect I); quantize it, or keep only the vocab head, the router or the "
        "front end dense"
    )


def _relayout(params, policy, size, ranks, *, cfg, plane_cache, value_bits, device, col_max,
              union, path="", sliced=False, keep_source=True):
    """``params`` with each linear replaced by a :class:`_PerRank` of the
    ranks' (shard node, source node) pairs and every other tensor moved to
    ``device`` (shared by both trees). A source node is the rank's dense
    slice on ``device`` (a row slice with its whole K's column maxima under
    ``"w_amax"``), the whole weight of a replicated one; ``sliced``: the
    tree is already one rank's source tree (a scrub's rebuild).
    ``col_max(list of (1, N) column maxima of the ranks' row slices) -> the
    whole K's``; ``union(alive lists) -> alive`` gives a weight's global
    kept-plane set under compaction. ``path``: the tree's own path in the
    whole tree (one part of it). Without ``keep_source`` a source node is
    None: each dense slice is dropped as soon as it is quantized."""
    from repro_torch.core.plan import plan_cacheable
    from repro_torch.core.quantize import quantize
    from repro_torch.models.quant import map_linears, weight_plane_cache, weight_precision

    compact = policy.sparsity == "compact" and policy.level == "bitplane"

    def sources(node, role):
        if sliced:
            return [node]
        ws = [_slice(node["w"], -2 if role == "row" else -1, size, r).to(device) for r in ranks]
        if role != "row":
            return [{"w": w} for w in ws]
        # a row slice's per-output-channel scale is over the whole K; a
        # column slice's own columns are whole, and so is its scale
        amax = col_max([w.to(torch.float32).abs().amax(dim=-2, keepdim=True) for w in ws])
        return [{"w": w, "w_amax": amax} for w in ws]

    def one(node, path):
        role = tp_role(path)
        prec = weight_precision(path, policy, value_bits)
        if prec is None:
            # a dense vocab head computes the whole vocabulary on every rank
            if role in ("col", "row"):
                raise dense_sharded_error(path)
            node = _to(node, device)
            return _PerRank([(node, node)] * len(ranks))
        bits = value_bits or prec.w_bits
        cached = plane_cache and plan_cacheable(policy, prec)
        if role is None:
            src = _to(node, device)
            q = quantize(src["w"].to(torch.float32), bits, axis=-2)
            out = {"w_q": q.values, "w_scale": q.scale}
            if cached:
                out["w_planes"] = weight_plane_cache(q.values, prec, policy)
            return _PerRank([(out, src if keep_source else None)] * len(ranks))
        srcs = sources(node, role)
        parts = []
        for s in srcs:
            q = quantize(s["w"].to(torch.float32), bits, axis=-2, amax=s.get("w_amax"))
            parts.append({"w_q": q.values, "w_scale": q.scale})
        if cached:
            caches = [weight_plane_cache(p["w_q"], prec, policy, compact=False) for p in parts]
            if compact:
                alive = union([bp.plane_alive(c.packed) for c in caches])
                caches = [bp.compact_weight_planes(c, alive) for c in caches]
            for p, c in zip(parts, caches):
                p["w_planes"] = c
        return _PerRank(zip(parts, srcs if keep_source else [None] * len(parts)))

    return map_linears(params, cfg, one, path=path, leaf=lambda t: _to(t, device))


def _or(alive_lists) -> list:
    return [any(col) for col in zip(*alive_lists)]


def _max(tensors) -> torch.Tensor:
    out = tensors[0]
    for t in tensors[1:]:
        out = torch.maximum(out, t)
    return out


def _rank_reducers(tp: TPContext, device):
    """The ``col_max`` and ``union`` of one rank: all-reduces over the
    group (one per row weight, one per compacted weight)."""

    def union(alive_lists):
        local = [int(a) for a in _or(alive_lists)]
        return [bool(v) for v in tp.reduce_max_host(local, device)]

    return dict(col_max=lambda maxima: tp.reduce_max(maxima[0]), union=union)


def shard_quantized(params, policy, tp: TPContext, *, cfg, plane_cache: bool = True,
                    value_bits=None, device=None, with_source: bool = False):
    """This rank's shard tree of the dense tree ``params``, on ``device``
    (default: where ``params`` lie): each linear's weight sliced where it
    lies (rows for "row", columns for "col" / "vocab"), the slice moved to
    ``device`` and quantized there to the reference's integers and scales
    (a row slice with the column maxima of the whole K: one all-reduce per
    weight; ``w_scale`` then replicates), then decomposed from the slice's
    own integers. Under compaction the kept planes are those alive in any
    rank's slice (one all-reduce per weight). Every rank must pass the same
    ``params``; a tree on the host never reaches the card whole. ``cfg``
    names the layers' paths (``models.quant.quantize_params``).

    A dense (policy-inactive) vocab head and every replicated leaf are
    moved whole; a dense column- or row-parallel projection raises
    (:func:`dense_sharded_error`). ``with_source``: also return the rank's
    source tree (:func:`shard_source`), the scrub's."""
    device = _device_of(params) if device is None else torch.device(device)
    tree = _relayout(params, policy, tp.size, [tp.rank], cfg=cfg, plane_cache=plane_cache,
                     value_bits=value_bits, device=device, keep_source=with_source,
                     **_rank_reducers(tp, device))
    shard = _pick(tree, 0, 0)
    return (shard, _pick(tree, 0, 1)) if with_source else shard


def shard_source(source, policy, tp: TPContext, *, cfg, plane_cache: bool = True,
                 value_bits=None):
    """The shard tree rebuilt from this rank's source tree (what
    :func:`shard_quantized` and :func:`load_shard` return ``with_source``:
    the dense slices, each row slice with its whole K's column maxima, and
    the replicated leaves, on the rank's device), bit-equal to the shard
    they were returned with. Under compaction the kept planes are
    all-reduced again, so every rank rebuilds at the same step; nothing
    else is a collective."""
    device = _device_of(source)
    tree = _relayout(source, policy, tp.size, [tp.rank], cfg=cfg, plane_cache=plane_cache,
                     value_bits=value_bits, device=device, sliced=True,
                     **_rank_reducers(tp, device))
    return _pick(tree, 0, 0)


def load_shard(cfg, gen: torch.Generator, policy, tp: TPContext, *, device=None,
               plane_cache: bool = True, value_bits=None, with_source: bool = False,
               on_part=None):
    """This rank's shard tree of ``init_params(cfg, gen, device=device)``,
    never holding the whole dense tree: each part (the embedding, the front
    end, the final norm, the head, then one layer at a time) is drawn in
    ``init_params``' order from ``gen`` on ``device``, sliced, quantized and
    decomposed there at once (the row maxima and the kept planes
    all-reduced as in :func:`shard_quantized`), and the rest of the part is
    dropped. The result is bit-equal to ``shard_quantized(init_params(cfg,
    gen, device=device), ...)``; the peak is the shard tree and one part.
    ``with_source``: also return the rank's source tree (the scrub's).
    ``on_part(path)``: called as each part is done (a progress hook)."""
    from repro_torch.models.transformer import init_params

    device = gen.device if device is None else torch.device(device)
    reducers = _rank_reducers(tp, device)

    def part(tree, path):
        out = _relayout(tree, policy, tp.size, [tp.rank], cfg=cfg, plane_cache=plane_cache,
                        value_bits=value_bits, device=device, path=path,
                        keep_source=with_source, **reducers)
        if on_part is not None:
            on_part(path)
        return out

    tree = init_params(cfg, gen, device=device, each=part)
    shard = _pick(tree, 0, 0)
    return (shard, _pick(tree, 0, 1)) if with_source else shard


def _device_of(tree) -> torch.device:
    """The device of a parameter tree's first tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    for v in tree.values() if isinstance(tree, dict) else tree:
        if isinstance(v, (torch.Tensor, dict, list, tuple)):
            return _device_of(v)
    raise ValueError("the tree holds no tensor")


def shard_quantized_all(params, policy, size: int, *, cfg, plane_cache: bool = True,
                        value_bits=None) -> list:
    """Every rank's shard tree (:func:`shard_quantized`), built in one
    process on the device of ``params``: rank ``r``'s is element ``r``."""
    tree = _relayout(params, policy, size, list(range(size)), cfg=cfg, plane_cache=plane_cache,
                     value_bits=value_bits, device=_device_of(params), col_max=_max, union=_or,
                     keep_source=False)
    return [_pick(tree, r, 0) for r in range(size)]


def plane_cache_device_bytes(tree) -> int:
    """Bytes of the weight-plane caches (every tensor under a ``w_planes``)
    that ``tree`` holds: for a rank's shard tree, what its device holds,
    which shrinks ~1/P with the ranks (K-padding of the packed words and
    replicated leaves give the "~")."""

    def nbytes(node) -> int:
        if isinstance(node, torch.Tensor):
            return node.numel() * node.element_size()
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return sum(nbytes(getattr(node, f.name)) for f in dataclasses.fields(node))
        return 0

    def rec(node) -> int:
        if isinstance(node, dict):
            return sum(nbytes(v) if k == "w_planes" else rec(v) for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return sum(rec(v) for v in node)
        return 0

    return rec(tree)
