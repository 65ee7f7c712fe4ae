"""Cost and memory report over one step of the port: the counterpart of the
reference's ``launch/hlo_cost.py`` and ``launch/hlo_buffers.py``.

The reference parses XLA's optimized HLO of a compiled step; the port runs
eagerly and has no such program, so this is a report over one step as it
runs (on real tensors, or on meta tensors for a dry run: ``launch/
dryrun.py``), not a line-for-line parser. Inside :func:`report`:

* **Compute and bytes.** A ``TorchDispatchMode`` sees every aten operation
  of the step: FLOPs from ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention), bytes as each operation's tensor
  operands read once and its outputs written once (views, aliases and
  allocations move nothing). Bit-serial plan calls (``core/plan.py``) and
  the attention calls of ``kernels/`` are charged once each by the function
  they compute (``launch/roofline.plan_call`` / ``attention_call``, through
  ``core/plan.charged``): nothing their kernels or plain versions do
  inside is counted, since that step-by-step arithmetic is not the work
  the function needs. On meta operands their bodies are not run at all.
* **Collectives.** Every collective of ``sharding/collectives.py`` and
  ``sharding/tp.py`` is recorded as it is called (``collectives.note``):
  kind, operand bytes, group size and range name; wire bytes follow the
  reference's ring factors (``roofline._wire_bytes``).
* **Memory.** The bytes of live tensor storage through the step: each
  storage an operation allocates is counted from its dispatch until its
  release (a finalizer on the storage). The resident bytes are those of
  the trees passed in (parameters, optimizer blocks, cache), counted once
  per storage; the peak is the resident, the inputs and the most the step
  held at once beyond them; the largest live buffers at that peak are
  listed with the operation that made each (in place of
  ``hlo_buffers.report``). Temporaries inside a charged call are not
  counted (the plain versions' intermediates are not what a kernel
  allocates); its output is.

``hlo_buffers.cpu_f32_carry_bytes`` has no counterpart: it corrects an
XLA:CPU artifact (bf16 loop carries promoted to float32) that an eager
step does not have.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import plan as plan_mod
from repro_torch.launch import roofline
from repro_torch.sharding import collectives

_aten = torch.ops.aten
#: operations that move no data (beyond views: ``OpOverload.is_view``)
_FREE = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.lift_fresh, _aten.alias,
    _aten._local_scalar_dense, _aten.set_, _aten.resize_,
}


def _tensors(obj) -> list:
    """The tensors of an operation's arguments or outputs (nested lists,
    tuples and dicts)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    return []


def _walk(tree):
    """Every tensor of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name))


def _storage_bytes(trees) -> tuple[int, set]:
    seen, total = set(), 0
    for t in _walk(trees):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total, seen


@dataclasses.dataclass
class Report:
    """One step's counts (this rank's): ``flops`` (non-int8 operations),
    ``int8_ops`` (plan calls), ``hbm_bytes``; ``calls`` charged by
    function; ``collectives`` by kind (count, operand bytes, wire bytes)
    and each call in order (``collective_calls``: kind, bytes, group size,
    range name); memory: ``resident_bytes`` (and by the resident dict's
    keys, ``resident_by``), ``input_bytes``, ``peak_bytes`` and the
    ``top`` live buffers at the peak."""

    flops: float = 0.0
    int8_ops: float = 0.0
    hbm_bytes: float = 0.0
    calls: dict = dataclasses.field(default_factory=lambda: {"plan": 0, "attention": 0})
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_calls: list = dataclasses.field(default_factory=list)
    resident_bytes: int = 0
    resident_by: dict = dataclasses.field(default_factory=dict)
    input_bytes: int = 0
    peak_bytes: int = 0
    top: list = dataclasses.field(default_factory=list)

    @property
    def wire_bytes(self) -> float:
        return sum(v["wire"] for v in self.collectives.values())

    def bound(self, hw=roofline.H100) -> tuple[float, str]:
        """(ms, bottleneck): the least time of this rank's step on ``hw`` —
        the largest of its compute, memory and collective terms."""
        rl = self.roofline("", "", "1", 1, 0.0, hw=hw)
        return rl.step_time_s * 1e3, rl.bottleneck

    def roofline(self, arch, shape, mesh, chips, model_flops, hw=None) -> roofline.Roofline:
        """The step's roofline over ``chips`` ranks each doing this rank's
        work (the counts scaled to the whole mesh, as the reference's)."""
        return roofline.Roofline(
            arch=arch, shape=shape, mesh=mesh, chips=chips, flops=self.flops * chips,
            int8_ops=self.int8_ops * chips, hbm_bytes=self.hbm_bytes * chips,
            collective_bytes=self.wire_bytes * chips, model_flops=model_flops, hw=hw,
        )


class _Counter(TorchDispatchMode):
    """The report's dispatch mode: counts and tracks outside charged calls."""

    def __init__(self, state: "_State"):
        super().__init__()
        self.state = state

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        st = self.state
        if st.depth == 0:
            st.count(func, args, kwargs, out)
            for t in _tensors(out):
                st.track(t, func.__name__)
        return out


class _State:
    def __init__(self, rep: Report, resident: set, top: int):
        self.rep, self.resident, self.top_n = rep, resident, top
        self.depth = 0
        self.live: dict = {}
        self.current = 0
        self.peak = 0
        self.snap_at = 0
        self.finalizers: list = []

    # -- counts ----------------------------------------------------------------

    def count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.rep.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or packet in _FREE:
            return
        seen, n = set(), 0
        for t in _tensors((args, kwargs)) + _tensors(out):
            if id(t) not in seen:
                seen.add(id(t))
                n += t.numel() * t.element_size()
        self.rep.hbm_bytes += n

    def charge(self, cost, run, empty, meta: bool):
        if self.depth:  # inside a charged call: the outer call pays
            return run()
        c = cost()
        self.rep.calls["plan" if c.int8 else "attention"] += 1
        if c.int8:
            self.rep.int8_ops += c.ops
        else:
            self.rep.flops += c.ops
        self.rep.hbm_bytes += c.n_bytes
        self.depth += 1
        try:
            out = empty() if meta else run()
        finally:
            self.depth -= 1
        self.track(out, "plan" if c.int8 else "attention")
        return out

    def collective(self, kind: str, n_bytes: int, size: int, name: str) -> None:
        slot = self.rep.collectives.setdefault(kind, {"count": 0, "bytes": 0, "wire": 0.0})
        slot["count"] += 1
        slot["bytes"] += n_bytes
        slot["wire"] += roofline._wire_bytes(kind, n_bytes, size)
        self.rep.collective_calls.append((kind, n_bytes, size, name))

    # -- memory ------------------------------------------------------------------

    def track(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live or key in self.resident:
            return
        n = st.nbytes()
        self.live[key] = (n, op, tuple(t.shape), str(t.dtype).replace("torch.", ""))
        self.current += n
        self.finalizers.append(weakref.finalize(st, self.release, key))
        if self.current > self.peak:
            self.peak = self.current
            # the largest live buffers near the peak (re-listed as it grows 1%)
            if self.peak > self.snap_at:
                self.snap_at = self.peak * 1.01
                self.rep.top = [
                    {"bytes": b, "op": o, "shape": list(s), "dtype": d}
                    for b, o, s, d in heapq.nlargest(self.top_n, self.live.values(),
                                                     key=lambda v: v[0])
                ]

    def release(self, key) -> None:
        n = self.live.pop(key, (0,))[0]
        self.current -= n


@contextlib.contextmanager
def report(resident=None, inputs=None, top: int = 15):
    """Count one step run inside the block: ``with report(resident=state,
    inputs=batch) as rep: step(...)``. ``resident``: a dict of the trees
    the step keeps across steps (parameters, optimizer state, cache);
    ``inputs``: the batch. Yields the :class:`Report`, complete when the
    block ends."""
    rep = Report()
    rep.resident_bytes, res_keys = _storage_bytes(resident)
    rep.resident_by = {k: _storage_bytes(v)[0] for k, v in (resident or {}).items()}
    rep.input_bytes, in_keys = _storage_bytes(inputs)
    state = _State(rep, res_keys | in_keys, top)
    token = plan_mod.CHARGE.set(state.charge)
    try:
        with collectives.recording(state.collective), _Counter(state):
            yield rep
    finally:
        plan_mod.CHARGE.reset(token)
        for f in state.finalizers:
            f.detach()
        rep.peak_bytes = rep.resident_bytes + rep.input_bytes + state.peak

