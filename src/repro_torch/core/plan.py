"""Compile-once execution plans for the bit-serial matmul.

A :class:`MatmulPlan` resolves *once* per :class:`PlanKey` — kernel route
(fused / staged / cached / plain), tiles, pack layout, epilogue fusion —
and ``plan(x, w)`` executes with no per-call dispatch logic. Plans are
interned in a :class:`PlanRegistry`. :meth:`MatmulPlan.with_precision`
re-plans to consume only the top planes of the stored decomposition:
the runtime precision dial.

Route names and their resolution are the reference's
(``src/repro/core/plan.py``), with the backends renamed: ``"pallas"`` is
``"cuda"`` (the Hopper kernels) and ``"jnp"`` is ``"torch"`` (the plain
versions). On CUDA, ``fused_cached``/``fused_repack`` run the fused
kernel and ``cached_planes``/``staged`` the plane-pair kernel;
``cached_planes``/``staged`` the plane-pair kernel and
``cached_packed``/``staged_packed`` the packed kernel; ``cached_scan`` and
``oracle`` are plain PyTorch on any device, as they are jnp on any device
in the reference. An attached tuner (:meth:`PlanRegistry.attach_tuner`,
``core/autotune``) picks each Hopper route's row tile and K split before
the :func:`~repro_torch.kernels.ops.hopper_tiles` default; explicit tiles
always win. Integrity-checked plans (``integrity != "off"``) verify
the ABFT row-sum identity on the raw int32 accumulator of every route that
has one and report the flag to :mod:`~repro_torch.core.integrity`.
A tensor-parallel plan (``shard=(axis, size, role)``, from
``layers/linear.py`` inside a TP step) resolves from the rank's local
shapes and never aliases an unsharded key; a row-parallel one has no
epilogue (the sum over the ranks comes first), so on cached planes it
takes the packed route and returns its raw int32 accumulator.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import warnings
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import bitserial as bs
from repro_torch.core import integrity
from repro_torch.core.precision import LayerPrecision, PrecisionPolicy

__all__ = [
    "MatmulPlan",
    "PlanKey",
    "PlanRegistry",
    "DEFAULT_REGISTRY",
    "make_plan",
    "plan_for_operands",
    "plan_cacheable",
    "truncation_audit",
]


#: a cost report's hook (``launch/cost.py``), set only inside the report:
#: ``hook(cost, run, empty, meta)`` charges one call by its function
CHARGE: contextvars.ContextVar = contextvars.ContextVar("plan_charge", default=None)


def charged(cost: Callable, run: Callable, empty: Callable, meta: bool):
    """``run()`` — or, inside a cost report, what the report's hook makes of
    it: the call charged once by ``cost()`` (a ``launch/roofline.CallCost``)
    and nothing it runs inside counted; on meta operands (a dry run) the
    body is not run and ``empty()``, an output of its shape, stands in."""
    hook = CHARGE.get()
    return run() if hook is None else hook(cost, run, empty, meta)


def _ops():
    # kernels.ops imports core modules; the lazy import keeps the layering
    # acyclic at import time
    from repro_torch.kernels import ops

    return ops


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else str(dt)


def _cache_spec(wp: Optional[bp.WeightPlanes]) -> Optional[tuple]:
    """Static descriptor of a weight-plane cache (layout only)."""
    if wp is None:
        return None
    packed = wp.packed
    return (
        wp.level,
        wp.variant,
        int(wp.w_bits),
        packed is not None,
        None if packed is None else packed.block,
        wp.planes is not None,
        len(wp.weights),
        packed is not None and packed.checksum is not None,
    )


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Everything plan resolution depends on — static, hashable values."""

    m: int
    k: int
    n: int
    a_bits: int  # executed activation width
    w_bits: int  # executed weight width
    a_in_bits: int  # width activations are provided at (>= a_bits)
    w_in_bits: int  # width weights are stored at (>= w_bits)
    variant: str
    level: str
    mode: str
    backend: str  # resolved: "cuda" | "torch"
    accum: str  # accumulator dtype name
    has_epilogue: bool
    cache: Optional[tuple]  # _cache_spec of the weight-plane cache
    fused: Optional[bool]  # requested flag (None = auto)
    packed: Optional[bool]  # requested flag (None = auto)
    bm: Optional[int]  # requested tiles (None = auto)
    bn: Optional[int]
    bk: Optional[int]
    sparsity: str = "off"
    integrity: str = "off"
    #: tensor-parallel placement ``(axis_name, axis_size, role)`` or None
    shard: Optional[tuple] = None


class PlanRegistry:
    """Interning cache ``PlanKey -> MatmulPlan``: a repeated key returns
    the identical plan. ``hits``/``misses`` count lookups, ``calls`` counts
    executions per route (the engine's route report).

    An attached tuner (:meth:`attach_tuner`; see ``core/autotune``) is
    asked for a plan's tiles before the ``hopper_tiles`` default; with a
    persistent store behind it, plans are tuned once per host. ``clear``
    drops plans but keeps the tuner, so a re-resolved plan still finds its
    stored tiles."""

    def __init__(self) -> None:
        self._plans: dict[PlanKey, "MatmulPlan"] = {}
        self.hits = 0
        self.misses = 0
        self.calls: collections.Counter = collections.Counter()
        self.tuner = None

    def get(self, key: PlanKey) -> "MatmulPlan":
        plan = self._plans.get(key)
        if plan is None:
            self.misses += 1
            plan = _build_plan(key, self)
            self._plans[key] = plan
        else:
            self.hits += 1
        return plan

    def attach_tuner(self, tuner) -> None:
        """Attach (or, with None, detach) a ``PlanAutotuner``-shaped object:
        ``tiles_for(key, kernel) -> (bm, bn, bk, k_split) | None`` and
        ``stats()``. The serving layer injects it; core imports no runtime
        module. A change of tuner drops the plans the old one tuned, so
        every plan's tiles come from the attached tuner or the default."""
        if tuner is not self.tuner:
            self._plans = {k: p for k, p in self._plans.items() if not p.tuned}
        self.tuner = tuner

    def store_stats(self) -> dict:
        """The tuner's and its store's counters for engine ``stats()``;
        zeros with no tuner attached."""
        if self.tuner is None:
            return {"store_hits": 0, "store_misses": 0, "tunes": 0}
        return self.tuner.stats()

    def clear(self) -> None:
        self._plans.clear()
        self.hits = 0
        self.misses = 0
        self.calls.clear()

    def plans(self) -> tuple["MatmulPlan", ...]:
        return tuple(self._plans.values())

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._plans


#: Process-wide default registry.
DEFAULT_REGISTRY = PlanRegistry()


def truncation_audit(registry: Optional[PlanRegistry] = None) -> dict:
    """Audit the no-requantization invariant over every *dialed* plan in
    ``registry`` (default: the process registry): a plan resolved with
    ``w_shift > 0`` — executing below its stored width — must consume the
    stored decomposition by MSB-prefix truncation (``trunc_cache``), never
    re-decompose the weight (``requant_w``).

    Returns ``{"dialed_plans", "routes", "truncated_ok"}``; ``truncated_ok``
    is False when no dialed plan exists (a vacuous audit must not pass) or
    any dialed plan requantizes."""
    reg = DEFAULT_REGISTRY if registry is None else registry
    dialed = [p for p in reg.plans() if p.w_shift > 0]
    return {
        "dialed_plans": len(dialed),
        "routes": sorted({p.kernel for p in dialed}),
        "truncated_ok": bool(dialed)
        and all(p.trunc_cache and not p.requant_w for p in dialed),
    }


# ---------------------------------------------------------------------------
# Plan resolution (the one-time dispatch logic)
# ---------------------------------------------------------------------------


def _resolve_packed(packed: Optional[bool], backend: str, level: str) -> bool:
    if level != "bitplane":
        return False
    if packed is None:
        return backend == "cuda"
    return bool(packed)


def _build_plan(key: PlanKey, registry: "PlanRegistry") -> "MatmulPlan":
    """The reference's route-resolution tree, run once per key."""
    serial = key.mode == "fully_serial"
    int32_acc = key.accum == "int32"
    kernel_ok = (
        key.level == "bitplane" or (key.level == "digit" and key.variant == "booth")
    ) and int32_acc
    use_packed = serial and int32_acc and _resolve_packed(key.packed, key.backend, key.level)
    if key.packed and not use_packed:
        raise ValueError(
            "packed=True requires level='bitplane', mode='fully_serial' and "
            f"int32 accumulation; got level={key.level!r}, mode={key.mode!r}, "
            f"accum_dtype={key.accum}"
        )

    fused_ok = (
        key.has_epilogue
        and serial
        and int32_acc
        and key.level == "bitplane"
        and key.variant in ("sbmwc", "booth")
        and key.a_bits <= 8
        and key.w_bits <= 8
    )
    if key.fused and not fused_ok:
        raise ValueError(
            "fused=True requires an epilogue, level='bitplane', "
            "mode='fully_serial', int32 accumulation and <=8-bit operands; "
            f"got epilogue={'set' if key.has_epilogue else None}, "
            f"level={key.level!r}, mode={key.mode!r}, "
            f"a_bits={key.a_bits}, w_bits={key.w_bits}"
        )
    use_fused = fused_ok and key.backend != "torch" and key.fused is not False

    check = key.integrity != "off"
    if check:
        if not (serial and int32_acc and key.level == "bitplane"):
            raise ValueError(
                "integrity-checked execution requires level='bitplane', "
                "mode='fully_serial' and int32 accumulation; got "
                f"level={key.level!r}, mode={key.mode!r}, accum={key.accum}"
            )
        if key.fused:
            raise ValueError(
                "fused=True cannot be integrity-checked: the fused epilogue "
                "hides the int32 accumulator the row-sum identity compares"
            )
        use_fused = False

    cache = key.cache
    w_shift = key.w_in_bits - key.w_bits
    cache_ok = (
        cache is not None
        and serial
        and int32_acc
        and cache[0] == key.level
        and cache[1] == key.variant
        and cache[2] == key.w_in_bits
        and (w_shift == 0 or key.level == "bitplane")
    )
    fused_cache_ok = cache_ok and cache[3] and cache[4] is not None
    if check and cache_ok and not cache[7]:
        raise ValueError(
            "integrity-checked cached execution needs a checksummed plane cache"
        )
    if use_fused and cache_ok and not fused_cache_ok and key.fused is None:
        # a global-planar cache can't feed the fused kernel: keep the
        # decompose-once staged path instead of re-packing every call
        use_fused = False

    if use_fused:
        kernel = "fused_cached" if fused_cache_ok else "fused_repack"
    elif cache_ok:
        if key.backend == "torch" or (key.level == "digit" and key.variant != "booth"):
            kernel = "cached_scan"
        elif key.level == "bitplane" and use_packed and cache[3]:
            kernel = "cached_packed"
        else:
            kernel = "cached_planes"
    elif (key.backend == "torch" and not use_packed) or not kernel_ok or not serial:
        kernel = "oracle"
    elif use_packed:
        kernel = "staged_packed"
    else:
        kernel = "staged"

    pack_block = None
    if kernel == "fused_cached":
        pack_block = cache[4]
    # Tiles, once: explicit tiles win; else an attached tuner (a store hit
    # or a fresh measurement on the card, core/autotune) gives the row tile
    # and the K split; else the hopper_tiles default, whose K split the
    # wrappers pick at launch (k_split None).
    tiles = None
    if registry.tuner is not None and key.bm is None and key.bn is None and key.bk is None:
        tiles = registry.tuner.tiles_for(key, kernel)
    tuned = tiles is not None
    if tuned:
        bm, bn, bk, k_split = tiles
    else:
        k_split = None
        bm, bn, bk = _ops().hopper_tiles(
            key.m, key.k, key.n, kernel=kernel, bm=key.bm, bn=key.bn, bk=key.bk,
            pack_block=pack_block,
        )
    if kernel == "fused_repack":
        pack_block = bk  # the weight is packed with the K tile as block

    gate = key.sparsity in ("gate", "compact") and kernel in (
        "fused_cached", "fused_repack", "cached_packed", "staged_packed"
    ) and key.backend != "torch"

    a_shift = key.a_in_bits - key.a_bits
    requant_w = w_shift > 0 and kernel in (
        "fused_repack", "staged", "staged_packed", "oracle"
    )
    trunc_cache = w_shift > 0 and kernel.startswith(("cached", "fused_cached"))
    return MatmulPlan(
        key=key,
        registry=registry,
        kernel=kernel,
        bm=bm,
        bn=bn,
        bk=bk,
        pack_block=pack_block or bk,
        a_shift=a_shift,
        w_shift=w_shift,
        scale_mult=float(1 << (a_shift + w_shift)),
        requant_w=requant_w,
        trunc_cache=trunc_cache,
        gate=gate,
        check=check,
        tuned=tuned,
        k_split=k_split,
    )


# ---------------------------------------------------------------------------
# Executors — one per resolved route
# ---------------------------------------------------------------------------


def _shift_activations(x, from_bits: int, to_bits: int, variant: str):
    """Runtime activation-width reduction; Booth's round half up saturates
    at the two's-complement max so kernel and plain version agree."""
    q = bp.shift_requantize(x, from_bits, to_bits, variant)
    if variant == "booth":
        q = torch.clamp_max(q, (1 << (to_bits - 1)) - 1)
    return q.to(torch.int8 if to_bits <= 8 else torch.int32)


def _finish(out2, lead, ep):
    out = out2.reshape(lead + (out2.shape[-1],))
    return out if ep is None else _ops().apply_epilogue(out, ep)


def _trunc(plan: "MatmulPlan", wp: bp.WeightPlanes) -> bp.WeightPlanes:
    return bp.truncate_weight_planes(wp, plan.key.w_bits) if plan.trunc_cache else wp


def _flat(x):
    return x.shape[:-1], x.reshape((-1, x.shape[-1]))


def _a_scale_rows(ep):
    return ep._replace(a_scale=ep.a_scale.reshape(-1, 1))


_MASK32 = 0xFFFFFFFF


def _row_dot_mod32(x2: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x2 @ v`` modulo 2^32 (as int64), exact: an int64 multiply and sum
    (the card has no integer matmul; |x| <= 128, |v| <= 128 * 49408 and
    K <= 12800 keep every partial sum far below 2^63)."""
    return (x2.to(torch.int64) * v.to(torch.int64)).sum(dim=-1) & _MASK32


def _abft_check(plan: "MatmulPlan", x2, out2, check_vec) -> None:
    """ABFT row-sum identity on the pre-epilogue int32 accumulator:
    ``sum_n out2[m, n] == x2 @ check_vec`` modulo 2^32 on both sides (the
    reference's int32 wraparound), where ``check_vec`` is the row-sum
    vector of the integer weight the kernel consumed. The mismatch flag
    stays on the device and goes to the active integrity collector."""
    expected = _row_dot_mod32(x2, check_vec)
    got = out2.to(torch.int64).sum(dim=-1) & _MASK32
    integrity.report(plan.key, torch.any(expected != got))


def _exec_fused_cached(plan, x, w, wp, ep):
    key = plan.key
    lead, x2 = _flat(x)
    packed_w = _trunc(plan, wp).packed
    out2 = _ops().fused_linear(
        x2.contiguous(), packed_w, _a_scale_rows(ep), a_bits=key.a_bits,
        variant=key.variant, backend=key.backend, bm=plan.bm, gate=plan.gate,
        k_split=plan.k_split,
    )
    return out2.reshape(lead + (packed_w.mag.shape[-1],))


def _exec_fused_repack(plan, x, w, wp, ep):
    key = plan.key
    lead, x2 = _flat(x)
    dec_w = bp.to_bitplanes(w, key.w_bits, key.variant)
    packed_w = bp.pack_decomposition(
        dec_w, axis=-2, variant=key.variant, block=plan.pack_block
    )
    out2 = _ops().fused_linear(
        x2.contiguous(), packed_w, _a_scale_rows(ep), a_bits=key.a_bits,
        variant=key.variant, backend=key.backend, bm=plan.bm, gate=plan.gate,
        k_split=plan.k_split,
    )
    return out2.reshape(lead + (packed_w.mag.shape[-1],))


def _exec_cached_packed(plan, x, w, wp, ep):
    ops = _ops()
    key = plan.key
    lead, x2 = _flat(x)
    wp_eff = _trunc(plan, wp)
    dec_a = bp.to_bitplanes(x2, key.a_bits, key.variant)
    pw = ops._pair_weights(dec_a.weights, wp_eff.weights, x.device)
    pa = bp.pack_decomposition(
        dec_a, axis=-1, variant=key.variant, block=wp_eff.packed.block,
    )
    out2 = ops.plane_matmul_packed(
        pa, wp_eff.packed, pw, backend=key.backend, bm=plan.bm, gate=plan.gate,
        k_split=plan.k_split,
    )
    if plan.check:
        _abft_check(plan, x2, out2, bp.checksum_vector(wp_eff.packed))
    return _finish(out2, lead, ep)


def _exec_cached_planes(plan, x, w, wp, ep):
    ops = _ops()
    key = plan.key
    lead, x2 = _flat(x)
    wp_eff = _trunc(plan, wp)
    if key.level == "bitplane":
        dec_a = bp.to_bitplanes(x2, key.a_bits, key.variant)
        wpl = (
            wp_eff.planes
            if wp_eff.planes is not None
            else bp.unpack_planes(wp_eff.packed)
        )
    else:
        dec_a = bp.to_digits(x2, key.a_bits, key.variant)
        wpl = wp_eff.planes
    pw = ops._pair_weights(dec_a.weights, wp_eff.weights, x.device)
    out2 = ops.plane_matmul(
        dec_a.planes.to(torch.int8).contiguous(), wpl.to(torch.int8).contiguous(), pw,
        backend=key.backend, bm=plan.bm, k_split=plan.k_split,
    )
    if plan.check:
        _abft_check(plan, x2, out2, bp.checksum_vector(wp_eff.packed))
    return _finish(out2, lead, ep)


def _exec_cached_scan(plan, x, w, wp, ep):
    key = plan.key
    lead, x2 = _flat(x)
    wp_eff = _trunc(plan, wp)
    out2 = _ops()._matmul_cached(
        x2, wp_eff, a_bits=key.a_bits, variant=key.variant, level=key.level
    )
    if plan.check:
        _abft_check(plan, x2, out2, bp.checksum_vector(wp_eff.packed))
    return _finish(out2, lead, ep)


def _exec_staged(plan, x, w, wp, ep):
    ops = _ops()
    key = plan.key
    lead, x2 = _flat(x)
    if key.level == "bitplane":
        dec_a = bp.to_bitplanes(x2, key.a_bits, key.variant)
        dec_w = bp.to_bitplanes(w, key.w_bits, key.variant)
    else:
        dec_a = bp.to_digits(x2, key.a_bits, key.variant)
        dec_w = bp.to_digits(w, key.w_bits, key.variant)
    pw = ops._pair_weights(dec_a.weights, dec_w.weights, x.device)
    if plan.kernel == "staged_packed":
        pa = bp.pack_decomposition(dec_a, axis=-1, variant=key.variant)
        pwk = bp.pack_decomposition(dec_w, axis=-2, variant=key.variant)
        out2 = ops.plane_matmul_packed(
            pa, pwk, pw, backend=key.backend, bm=plan.bm, gate=plan.gate,
            k_split=plan.k_split,
        )
    else:
        out2 = ops.plane_matmul(
            dec_a.planes.to(torch.int8).contiguous(),
            dec_w.planes.to(torch.int8).contiguous(), pw,
            backend=key.backend, bm=plan.bm, k_split=plan.k_split,
        )
    if plan.check:
        # uncached route: the row sums come from the in-hand integer weight
        # (already requantized to the executed width)
        _abft_check(plan, x2, out2, w.to(torch.int32).sum(dim=-1, dtype=torch.int32))
    return _finish(out2, lead, ep)


def _exec_oracle(plan, x, w, wp, ep):
    """The plain bit-serial product: int32 up to 8 bits, float32 beyond
    (the weight is decomposed on every call: the plane cache holds only
    int32-exact widths)."""
    key = plan.key
    acc = bs.bitserial_matmul(
        x, w, a_bits=key.a_bits, w_bits=key.w_bits, variant=key.variant,
        level=key.level, mode=key.mode, accum_dtype=getattr(torch, key.accum),
    )
    if plan.check:
        _abft_check(
            plan, x.reshape((-1, x.shape[-1])), acc.reshape((-1, acc.shape[-1])),
            w.to(torch.int32).sum(dim=-1, dtype=torch.int32),
        )
    return acc if ep is None else _ops().apply_epilogue(acc, ep)


_EXECUTORS: dict[str, Callable] = {
    "fused_cached": _exec_fused_cached,
    "fused_repack": _exec_fused_repack,
    "cached_packed": _exec_cached_packed,
    "cached_planes": _exec_cached_planes,
    "cached_scan": _exec_cached_scan,
    "staged_packed": _exec_staged,
    "staged": _exec_staged,
    "oracle": _exec_oracle,
}


# ---------------------------------------------------------------------------
# MatmulPlan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A fully-resolved bit-serial matmul: ``plan(x_q, w_q, w_planes=…,
    epilogue=…)`` runs its route with its tiles. A cached-route plan never
    reads ``w_q``; an uncached one never reads ``w_planes``.

    ``with_precision(a_bits, w_bits)`` returns the sibling plan executing
    at a lower width against the same stored operands; the dequant
    correction ``2^(a_shift + w_shift)`` folds into the epilogue's
    ``w_scale`` (exact in float32).
    """

    key: PlanKey
    registry: "PlanRegistry" = dataclasses.field(compare=False, repr=False)
    kernel: str
    bm: int
    bn: int
    bk: int
    pack_block: int
    a_shift: int
    w_shift: int
    scale_mult: float
    requant_w: bool
    trunc_cache: bool
    gate: bool = False
    check: bool = False
    #: provenance: the tiles came from an attached autotuner (a store hit or
    #: a fresh measurement) rather than the ``hopper_tiles`` default. A tuned
    #: plan is bit-equal to the default's: tiles and K splits change the
    #: launch geometry, and split partial sums meet modulo 2^32 in any order
    tuned: bool = False
    #: K splits the Hopper kernel's launch takes (None: its default at launch)
    k_split: Optional[int] = None

    def __call__(self, x, w=None, *, w_planes=None, epilogue=None):
        key = self.key
        if key.has_epilogue != (epilogue is not None):
            raise ValueError(
                f"plan was resolved {'with' if key.has_epilogue else 'without'} "
                f"an epilogue but called {'without' if epilogue is None else 'with'} "
                "one; build a matching plan (has_epilogue=)"
            )
        if x.shape[-1] != key.k:
            raise ValueError(f"plan expects K={key.k}, got x K={x.shape[-1]}")
        if self.a_shift:
            x = _shift_activations(x, key.a_in_bits, key.a_bits, key.variant)
        if epilogue is not None and self.scale_mult != 1.0:
            epilogue = epilogue._replace(w_scale=epilogue.w_scale * self.scale_mult)
        if self.requant_w:
            w = bp.shift_requantize(w, key.w_in_bits, key.w_bits, key.variant)
        self.registry.calls[self.kernel] += 1
        return charged(
            lambda: self._cost(x, w, w_planes, epilogue),
            lambda: _EXECUTORS[self.kernel](self, x, w, w_planes, epilogue),
            lambda: x.new_empty(
                tuple(x.shape[:-1]) + (key.n,),
                dtype=getattr(torch, key.accum) if epilogue is None else epilogue.out_dtype),
            x.is_meta,
        )

    def _cost(self, x, w, w_planes, epilogue):
        """What this call's function needs (``launch/roofline.plan_call``):
        its int8 products at the executed widths, and the bytes of the
        activation, the stored weight it reads at the executed width (the
        packed planes or the digits of a cache, the integer weight
        otherwise), the epilogue's tensors and the output."""
        from repro_torch.launch import roofline

        key = self.key

        def nbytes(t):
            return 0 if t is None else t.numel() * t.element_size()

        packed = None if w_planes is None else w_planes.packed
        if packed is not None:
            w_bytes = (nbytes(packed.mag) + nbytes(packed.sign)) * key.w_bits / key.w_in_bits
        elif w_planes is not None:
            w_bytes = nbytes(w_planes.planes) * key.w_bits / key.w_in_bits
        else:
            w_bytes = nbytes(w)
        m = x.numel() // max(key.k, 1)
        if epilogue is None:
            tail = m * key.n * getattr(torch, key.accum).itemsize
        else:
            tail = (nbytes(epilogue.a_scale) + nbytes(epilogue.w_scale) + nbytes(epilogue.bias)
                    + m * key.n * epilogue.out_dtype.itemsize)
        return roofline.plan_call(m, key.k, key.n, key.a_bits, key.w_bits,
                                  n_bytes=nbytes(x) + w_bytes + tail,
                                  a_signed=key.variant != "unsigned")

    def with_precision(
        self, a_bits: Optional[int] = None, w_bits: Optional[int] = None
    ) -> "MatmulPlan":
        """Sibling plan at a lower runtime precision (same stored operands);
        the ceiling is the provided/stored width."""
        a = self.key.a_bits if a_bits is None else a_bits
        w = self.key.w_bits if w_bits is None else w_bits
        if not 1 <= a <= self.key.a_in_bits:
            raise ValueError(
                f"a_bits must be in [1, {self.key.a_in_bits}] "
                f"(the provided operand width), got {a}"
            )
        if not 1 <= w <= self.key.w_in_bits:
            raise ValueError(
                f"w_bits must be in [1, {self.key.w_in_bits}] "
                f"(the stored decomposition width), got {w}"
            )
        if (a, w) == (self.key.a_bits, self.key.w_bits):
            return self
        return self.registry.get(dataclasses.replace(self.key, a_bits=a, w_bits=w))

    def sparsity_stats(self, w_planes: Optional[bp.WeightPlanes] = None) -> dict:
        """Plane-pair passes skipped against executed under this plan.

        Static, weight-side accounting from the cache's occupancy bitmap
        (read back to the host): ``pair_passes_dense`` is what
        sparsity="off" issues at the executed width,
        ``pair_passes_after_compaction`` what survives the cache's plane
        compaction, ``pair_passes_executed`` what the weight-occupancy gate
        leaves. Without a packed bit-plane cache only the mode and route
        fields are reported."""
        key = self.key
        out = {
            "mode": key.sparsity,
            "kernel": self.kernel,
            "gated": self.gate,
            "planes_dense": key.w_bits,
            "a_planes": key.a_bits,
        }
        if w_planes is None or w_planes.packed is None or w_planes.packed.occupancy is None:
            return out
        packed = _trunc(self, w_planes).packed
        wpt = (packed.block or self.bk) // bp.WORD_BITS
        occ = packed.occupancy.cpu()
        if occ.dim() > 2:  # stacked caches: a K tile is live if any is
            occ = occ.reshape((-1,) + tuple(occ.shape[-2:])).any(dim=0)
        n_kept = occ.shape[0]
        # the tile reduction the gated kernels consume
        tiles = bp.occupancy_per_tile(occ.to(torch.int32), wpt)
        nk = tiles.shape[1]
        occupied = int(tiles.sum())
        dense = key.a_bits * key.w_bits * nk
        executed = key.a_bits * occupied
        out.update(
            planes_kept=n_kept,
            k_tiles=nk,
            pair_passes_dense=dense,
            pair_passes_after_compaction=key.a_bits * n_kept * nk,
            pair_passes_executed=executed,
            pair_passes_skipped=dense - executed,
            skipped_fraction=round(1.0 - executed / max(dense, 1), 4),
        )
        return out

    def describe(self) -> str:
        k = self.key
        s = (
            f"MatmulPlan[{k.m}x{k.k}x{k.n}] w{k.w_bits}a{k.a_bits} "
            f"{k.level}/{k.variant} -> {self.kernel} backend={k.backend} "
            f"tiles=(bm={self.bm}, bn={self.bn}, bk={self.bk})"
        )
        if self.k_split is not None:
            s += f" k_split={self.k_split}"
        if self.tuned:
            s += " tuned"
        if self.a_shift or self.w_shift:
            s += f" trunc(w {k.w_in_bits}->{k.w_bits}, a {k.a_in_bits}->{k.a_bits})"
        if k.sparsity != "off":
            s += f" sparsity={k.sparsity}{' (gated)' if self.gate else ''}"
        if k.integrity != "off":
            s += f" integrity={k.integrity}{' (checked)' if self.check else ''}"
        return s


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _norm_shapes(shapes) -> Tuple[int, int, int]:
    """(m, k, n) ints, or ((…, k), (k, n)) shape pair."""
    if len(shapes) == 3 and all(isinstance(s, int) for s in shapes):
        return tuple(shapes)  # type: ignore[return-value]
    if len(shapes) == 2:
        x_shape, w_shape = shapes
        m = 1
        for d in x_shape[:-1]:
            m *= int(d)
        return m, int(x_shape[-1]), int(w_shape[-1])
    raise ValueError(f"shapes must be (m, k, n) or (x_shape, w_shape), got {shapes!r}")


def plan_for_operands(
    shapes,
    *,
    a_bits: int,
    w_bits: int,
    variant: str = "booth",
    level: str = "digit",
    mode: str = "fully_serial",
    backend: str = "auto",
    device=None,
    accum_dtype: Any = torch.int32,
    has_epilogue: bool = False,
    w_planes: Optional[bp.WeightPlanes] = None,
    a_in_bits: Optional[int] = None,
    w_in_bits: Optional[int] = None,
    fused: Optional[bool] = None,
    packed: Optional[bool] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    bk: Optional[int] = None,
    sparsity: str = "off",
    integrity: str = "off",
    shard: Optional[tuple] = None,
    registry: Optional[PlanRegistry] = None,
) -> MatmulPlan:
    """Policy-free plan construction from explicit operand metadata.
    ``backend="auto"`` resolves against ``device`` (the operands')."""
    if sparsity not in ("off", "gate", "compact"):
        raise ValueError(
            f"sparsity must be 'off', 'gate' or 'compact', got {sparsity!r}"
        )
    if integrity not in ("off", "detect", "scrub"):
        raise ValueError(
            f"integrity must be 'off', 'detect' or 'scrub', got {integrity!r}"
        )
    m, k, n = _norm_shapes(shapes)
    key = PlanKey(
        m=m, k=k, n=n,
        a_bits=a_bits, w_bits=w_bits,
        a_in_bits=a_bits if a_in_bits is None else a_in_bits,
        w_in_bits=w_bits if w_in_bits is None else w_in_bits,
        variant=variant, level=level, mode=mode,
        backend=_ops().resolve_backend(backend, device),
        accum=_dtype_name(accum_dtype),
        has_epilogue=has_epilogue,
        cache=_cache_spec(w_planes),
        fused=fused, packed=packed,
        bm=bm, bn=bn, bk=bk,
        sparsity=sparsity,
        integrity=integrity,
        shard=shard,
    )
    return (DEFAULT_REGISTRY if registry is None else registry).get(key)


def make_plan(
    policy: PrecisionPolicy,
    layer_name: str,
    shapes,
    backend: str = "auto",
    *,
    device=None,
    w_planes: Optional[bp.WeightPlanes] = None,
    w_stored_bits: Optional[int] = None,
    has_epilogue: bool = True,
    accum_dtype: Any = None,
    registry: Optional[PlanRegistry] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    bk: Optional[int] = None,
    shard: Optional[tuple] = None,
) -> MatmulPlan:
    """Resolve the execution plan for one layer of a policy. When the
    policy's runtime dial lowers the executed width below
    ``w_stored_bits``, the plan consumes the stored decomposition's plane
    prefix."""
    configured = policy.lookup(layer_name)
    if not configured.active:
        raise ValueError(f"layer {layer_name!r}: policy is inactive — no plan to build")
    eff = policy.effective(configured)
    if accum_dtype is None:
        accum_dtype = torch.int32 if max(eff.w_bits, eff.a_bits) <= 8 else torch.float32
    return plan_for_operands(
        shapes,
        a_bits=eff.a_bits,
        w_bits=eff.w_bits,
        a_in_bits=eff.a_bits,
        w_in_bits=configured.w_bits if w_stored_bits is None else w_stored_bits,
        variant=policy.variant,
        level=policy.level,
        mode=policy.mode,
        backend=backend,
        device=device,
        accum_dtype=accum_dtype,
        has_epilogue=has_epilogue,
        w_planes=w_planes,
        fused=policy.fuse_epilogue,
        bm=bm, bn=bn, bk=bk,
        sparsity=policy.sparsity,
        integrity=policy.integrity,
        shard=shard,
        registry=registry,
    )


def plan_cacheable(policy: PrecisionPolicy, prec: LayerPrecision) -> bool:
    """Whether a layer at ``prec`` uses the decompose-once weight-plane
    cache: the int32-exact fully-serial configs."""
    return (
        policy.mode == "fully_serial"
        and policy.level in ("bitplane", "digit")
        and prec.active
        and max(prec.w_bits, prec.a_bits) <= 8
    )


# ---------------------------------------------------------------------------
# Deprecation plumbing for the legacy flag API (ops.bitserial_matmul)
# ---------------------------------------------------------------------------

_DEPRECATION_WARNED: set[str] = set()

_DEPRECATION_TEXT = {
    "packed": "bitserial_matmul(packed=…) is deprecated; packing is resolved "
    "once at plan time — use repro_torch.core.plan.make_plan / plan_for_operands",
    "fused": "bitserial_matmul(fused=…) is deprecated; epilogue fusion is "
    "resolved once at plan time — use repro_torch.core.plan.make_plan / "
    "plan_for_operands",
    "epilogue": "bitserial_matmul(epilogue=…) is deprecated; build a plan "
    "with has_epilogue=True and pass the epilogue to the plan call",
}


def _warn_deprecated(kw: str) -> None:
    """One DeprecationWarning per legacy keyword per process."""
    if kw in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(kw)
    warnings.warn(_DEPRECATION_TEXT[kw], DeprecationWarning, stacklevel=3)


def _reset_deprecation_warnings() -> None:
    _DEPRECATION_WARNED.clear()
