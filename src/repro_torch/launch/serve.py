"""Serving driver: quantized weights, the continuous-batching engine and
the lockstep engine.

Weights live in memory at their configured bit-width with a
decompose-once plane cache (:func:`~repro_torch.models.quant.quantize_params`),
activations are quantized per token, every projection runs through the
bit-serial matmul at the policy's level/variant — on CUDA the fused
Hopper kernel at ``--level bitplane`` and the plane-pair kernel at
``--level digit`` — and the KV cache is int8 (quantize-on-append). Beyond
8 bits (up to the paper's 16) the plans take the float32-accumulated plain
route, as the reference's do: the weight is decomposed on every call.

Both engines serve the dense, MoE, SSM, hybrid and VLM decoders (the VLM
text only, as the reference's engines do; its image prefix goes through
``steps.make_prefill_step``) and refuse the encoder. An MoE model serves
bit-serially under a policy that keeps its router dense,
``PrecisionPolicy.uniform(..., keep_dense=("frontend", "router"))`` (the
reference's serving policy); the CLI's uniform ``--bits`` would quantize
the router and dies naming reference defect G. In a continuous-batching
step every slot of the array, free ones included, competes for the MoE
experts' capacity, as in the reference.

:class:`ContinuousBatchingEngine` admits requests with different prompt
lengths and arrival steps into free decode slots mid-flight (a
per-request prefill inserted into its slot while the other slots keep
decoding), runs one decode pass over the whole slot array per step, and
evicts each request the step it finishes. :meth:`set_precision` dials
the steps to a lower width against the same weight tree (plane-prefix
truncation); ``run(precision_schedule={step: bits})`` automates it.
:class:`Engine` is the lockstep baseline: one fixed batch prefills and
decodes in unison (the parity yardstick of continuous batching).

With ``autopilot`` (an :class:`~repro_torch.runtime.autopilot.AutopilotPolicy`)
the continuous-batching engine closes the loop on that dial: a controller
watches queue depth, per-token decode latency, the scrub count and a
shadow-KL quality probe, moves the *admission* tier along the precision
ladder, and sheds the queue tail past the lowest tier. A request keeps the
tier it was admitted at, so a step whose active slots hold several tiers
runs one decode pass per tier (**mixed-tier decode**), every pass from the
same pre-step state: the first pass copies the state it writes into a
static backup, each pass but the last leaves its slots' rows (paged: the
pages its slots own) in a static merge buffer and the next pass restores
the state first, and after the last pass the earlier passes' rows are put
back. The masks of those merges are built on the host and copied in
through pinned memory; on the card every pass is one replay of its tier's
graph, the merges are in-place selects, and the step still reads back only
its token vector (under scrub, each pass reads its alarms back before the
next, as a retry must replay from its own pass's pre-step state). The
shadow probe runs two logits-returning decode steps (the storage width
and the admission tier) on a copy of the backup, computes the KL on the
device and is read back with the tokens.

With ``policy.integrity != "off"`` the engine layers three detectors and
counts their alarms in ``stats()["integrity"]``: the per-matmul ABFT
row-sum check of every projection, an at-rest fingerprint of the whole
quantized weight tree audited every ``audit_interval`` iterations against
the load-time one, and KV checksums (per slot, or per page and per slot
on the paged cache) compared with their post-step baselines. On the card
every fold is one launch of the fold kernel (``kernels/fold.py``).

``"detect"`` reads the alarm vector, the audit's fingerprint and the KV
comparisons back once per decode step, with the tokens. ``"scrub"`` also
recovers, in the reference's order: at the top of each iteration it reads
the at-rest results back (one small sync) and acts on them before
admission and the step — a parameter alarm rebuilds the quantized tree
from the retained source parameters and writes it **into the serving
leaves in place** (a captured graph and the fold table hold their
addresses), after checking its fingerprint against the load-time one; a KV
alarm requeues the requests whose slot (or page) it hit and quarantines a
slot or page that faults again. An ABFT alarm in a prefill chunk or a
decode step scrubs and re-runs it from its pre-step inputs, at most
``max_retries`` times: a prefill chunk from its kept scratch, a decode
step from a static backup of the state it writes (the first thing its
graph does), replaying the same graph with the same seed. Tokens are
bit-identical to a clean run; what cannot be recovered raises
:class:`~repro_torch.core.integrity.IntegrityError`. ``run(...,
injector=)`` takes the seeded SEU injector (``runtime/faults.py``).

On the card every decode step replays from a CUDA graph
(``launch/graphs.py``), one per precision, captured at its first step on
the engine's decode state, which the engine allocates once and resets in
place at the start of each :meth:`~ContinuousBatchingEngine.run`: the
slot cache (or the page pools), the resident tokens and the
temperatures. A step copies the temperatures in when they change, seeds
the graph's generator, replays, and reads the tokens back (with the
alarms under integrity) in one copy. ``compile_steps=False`` runs the same
step eagerly, the counterpart of ``jax.disable_jit``; prefill stays eager
on every device, and on the host every step does.

Every prefill is staged: each admission runs against a raw scratch
cache, in ``prefill_chunk``-token chunks (one per engine iteration) or at
once, and commits by quantizing the scratch into its slot (or its pages).
With ``page_size > 0`` the KV cache is **paged** (``models/paging.py``):
int8 page pools with a block table per slot, admission by free-page
capacity, and with ``share_prefixes`` copy-on-write reuse of the pages of
a declared shared prompt prefix. On the card every decode step's
attention reads the pools straight through the block tables in the paged
flash-attention kernel.

With ``autotune=True`` (``--autotune``) a tile autotuner
(``core/autotune``) is attached to the process plan registry before the
first plan resolves, optionally backed by a persistent per-host plan store
(``plan_store_path``, ``--plan-store``; ``runtime/plan_store``): on the
card each new plan's launch geometry (row tile, K split) is measured on
its route's kernel, and a warm store serves every plan with zero tuning.
Tokens are bit-identical to the untuned engine's. Plans resolve in a
step's eager warm-up, never inside a CUDA-graph capture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --reduced --bits 8 --level bitplane --prompt-lens 8,32,64 --gen 16 \
        --precision-switch 8:4

Runs on CUDA unless ``--device cpu`` (or ``device="cpu"``) is given; with
no GPU and no explicit CPU request it raises.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.core import integrity
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import fold
from repro_torch.launch import graphs, sampling
from repro_torch.launch.steps import (
    make_cb_decode_step,
    make_prefill_step,
    make_serve_step,
    make_tp_cb_decode_step,
    make_tp_prefill_step,
)
from repro_torch.models import paging
from repro_torch.models.cache import (
    cache_kv_bytes,
    init_cache,
    insert_slot,
    quantize_scratch,
    select_slots,
)
from repro_torch.models.quant import quantize_params
from repro_torch.models.transformer import SeededParams, check_prefill, init_params
from repro_torch.runtime.autopilot import Autopilot, AutopilotPolicy
from repro_torch.runtime.faults import FaultInjector, FaultSpec
from repro_torch.runtime.scheduler import HISTORY_LIMIT, Request, SlotScheduler
from repro_torch.sharding.tp import (
    MAX_TP_BITS,
    RankTuner,
    TPContext,
    check_exact_bits,
    load_shard,
    plane_cache_device_bytes,
    shard_quantized,
    shard_source,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that is an error, never a
    quiet fall back to the CPU (pass ``"cpu"`` to ask for it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' (--device cpu) to run on the host"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _norm_precision(precision) -> Tuple[int, int]:
    """``4`` or ``(a_bits, w_bits)`` -> (a_bits, w_bits)."""
    if isinstance(precision, int):
        return (precision, precision)
    a, w = precision
    return (int(a), int(w))


def _seed_of(seed: int, stream: int, n: int) -> int:
    """The seed of one sampling event: ``stream`` 0 is first-token sampling
    (``n`` = request id), 1 is decode (``n`` = engine step)."""
    return (seed * 1_000_003 + stream * 7_919 + n) % (2**63)


def _seeded(seed: int, stream: int, n: int, device) -> torch.Generator:
    """A generator seeded for one sampling event (:func:`_seed_of`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed, stream, n))
    return gen


def _copy_tree(dst, src, path: str = "") -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst``, in place; both trees (dicts, lists, tuples, dataclasses) must
    have the same structure, non-tensor values, shapes, dtypes and devices,
    or :class:`~repro_torch.core.integrity.IntegrityError` is raised
    before that leaf is written."""
    where = path or "/"
    if isinstance(dst, torch.Tensor):
        if (not isinstance(src, torch.Tensor) or src.shape != dst.shape
                or src.dtype != dst.dtype or src.device != dst.device):
            raise integrity.IntegrityError(f"tree copy: the trees differ at {where}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or list(src) != list(dst):
            raise integrity.IntegrityError(f"tree copy: the keys differ at {where}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{path}/{k}")
    elif isinstance(dst, (list, tuple)):
        if type(src) is not type(dst) or len(src) != len(dst):
            raise integrity.IntegrityError(f"tree copy: the sequences differ at {where}")
        for i, (a, b) in enumerate(zip(dst, src)):
            _copy_tree(a, b, f"{path}/{i}")
    elif dataclasses.is_dataclass(dst) and not isinstance(dst, type):
        if type(src) is not type(dst):
            raise integrity.IntegrityError(f"tree copy: the node types differ at {where}")
        for f in dataclasses.fields(dst):
            _copy_tree(getattr(dst, f.name), getattr(src, f.name), f"{path}.{f.name}")
    elif dst != src:
        raise integrity.IntegrityError(f"tree copy: {dst!r} against {src!r} at {where}")


def _decode_body(step, params, check: bool):
    """An engine's decode step on its state tree ``{"cache", "tokens"[,
    "temps"][, "backup"]}``: ``step`` (:func:`make_cb_decode_step`, given
    the temperatures; or the lockstep :func:`make_serve_step`), its next
    tokens written into the state's token buffer, and the read-back vector
    — the next tokens, then the alarm flags under integrity — as int64.
    With a ``backup`` (``{"cache", "tokens"}``) the step first copies the
    state it writes there: the pre-step state of a scrub retry and of the
    passes of a mixed-tier step."""

    def body(state, gen):
        if "backup" in state:
            _copy_tree(state["backup"], {"cache": state["cache"], "tokens": state["tokens"]})
        temps = (state["temps"],) if "temps" in state else ()
        out = step(params, state["cache"], state["tokens"], *temps, gen)
        state["tokens"].copy_(out[0])
        parts = [out[0][:, 0].to(torch.int64)]
        if check:
            parts.append(out[2].to(torch.int64))
        return torch.cat(parts)

    return body


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order the reference's compiled
    reduction takes on the host (XLA's CPU tree-reduction rewrite): windows
    of 32 summed left to right (the last one zero-padded), the window sums
    likewise until at most 32 remain, then those left to right. The float32
    result then rounds as the reference's does, which holds the probe's KL
    to it within a few ulps where a library sum (another order) differs by
    ~1e-6 relative."""
    while x.shape[-1] > 32:
        pad = -x.shape[-1] % 32
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        x = x.reshape(x.shape[:-1] + (-1, 32))
        acc = x[..., 0]
        for k in range(1, 32):
            acc = acc + x[..., k]
        x = acc
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``log_softmax`` over the last axis with :func:`_row_sum`."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(_row_sum(torch.exp(shifted)))[..., None]


def _shadow_body(ref_step, deg_step, params, vocab_size: int):
    """The autopilot's shadow quality probe on ``{"scratch", "backup",
    "temps", "active"}``: two logits-returning decode steps from the
    pre-step state in ``backup`` — the storage width and the admission
    tier — each on a copy of it in ``scratch`` (nothing the engine serves
    from is written), then the mean over the active slots of
    KL(storage || tier) of their next-token distributions, the vocab
    sliced before ``log_softmax`` (the padded tail would otherwise count).
    Returns the float32 KL's bits as a (1,) int64, to be read back with the
    tokens."""

    def body(state, gen):
        z, b = state["scratch"], state["backup"]
        logps = []
        for step in (ref_step, deg_step):
            _copy_tree(z, b)
            logits = step(params, z["cache"], z["tokens"], state["temps"], gen)[-1]
            logps.append(_log_softmax(logits[..., :vocab_size].to(torch.float32)))
        lp_ref, lp_deg = logps
        kl = _row_sum(torch.exp(lp_ref) * (lp_ref - lp_deg))
        act = state["active"]
        mean = torch.where(act, kl, torch.zeros_like(kl)).sum() / act.sum().to(torch.float32)
        return mean.reshape(1).view(torch.int32).to(torch.int64)

    return body


def _f32_of_bits(v) -> float:
    """The float32 whose bits an int64 read-back holds (:func:`_shadow_body`)."""
    return float(np.array([int(v)], dtype=np.int64).astype(np.int32).view(np.float32)[0])


class _PrecisionDial:
    """Shared ``set_precision`` plumbing: one set of steps per precision
    tier — the engines provide ``_make_steps(precision)``, returning
    ``(prefill, decode_body, prefill_collector, step_collector)`` — with
    the dial validated against the policy's storage width."""

    def _init_dial(self) -> None:
        self._precision: Optional[Tuple[int, int]] = None
        self._compiled: dict = {}
        self._bind_steps(self._steps_for(None))

    def _steps_for(self, precision):
        if precision not in self._compiled:
            self._compiled[precision] = self._make_steps(precision)
        return self._compiled[precision]

    def _bind_steps(self, steps) -> None:
        self._prefill, self._step, self._prefill_col, self._step_col = steps

    def set_precision(self, precision) -> None:
        """Dial subsequent prefills/decodes to ``precision`` (an int or an
        ``(a_bits, w_bits)`` pair; ``None`` restores the storage width).
        The weight tree is untouched — plans truncate the stored plane
        decomposition — and in-flight slots keep their KV state."""
        if precision is None:
            self._precision = None
        else:
            p = _norm_precision(precision)
            self._dial_check(p)
            self._precision = p
        self._bind_steps(self._steps_for(self._precision))

    def _dial_check(self, precision: Tuple[int, int]) -> None:
        pol = self.policy
        stored = pol.storage_width()
        if stored is None:
            raise ValueError("set_precision needs an active quantization policy")
        a, w = precision
        if min(a, w) < 1:
            raise ValueError(f"runtime precision must be >= 1 bit, got {precision}")
        if w > stored:
            raise ValueError(
                f"runtime weight precision {w} exceeds the stored width "
                f"{stored} — the dial can only truncate, never extend"
            )
        if pol.level != "bitplane":
            raise ValueError(
                "runtime precision reconfiguration needs level='bitplane' "
                f"(got {pol.level!r}): radix-256 digit caches are not "
                "prefix-truncatable"
            )

    @property
    def precision(self) -> Optional[Tuple[int, int]]:
        return self._precision


class _StepRunner:
    """Runs a decode-step body eagerly (on the host, or with
    ``compile_steps=False``) or, on the card, as a replay of its CUDA graph,
    captured at its first call and kept under a key (a precision)."""

    def _run_step(self, graphs_of: dict, key, body, state, step_i: int, col=None):
        """``body`` on ``state`` for decode step ``step_i`` (its seed):
        returns its outputs and, with ``col``, the plan keys of its alarm
        flags."""
        if self._runner is None:
            out = body(state, _seeded(self.seed, 1, step_i, self.device))
            return out, None if col is None else list(col.keys)
        captured = graphs_of.get(key)
        if captured is None:
            captured = graphs.CapturedStep(body, state, plan_mod.DEFAULT_REGISTRY,
                                           self._runner(self.device), col)
            graphs_of[key] = captured
            self.capture_s[key] = captured.capture_s
        return captured(_seed_of(self.seed, 1, step_i)), captured.keys


class _IntegrityRuntime:
    """Shared fault detection and recovery: the load-time fingerprint the
    at-rest audits compare against, the retained source (scrub mode) and
    the in-place scrub."""

    def _init_integrity(self, params) -> None:
        # the load-time fingerprint the at-rest audits (and a scrub's
        # rebuild) compare against
        self._params_ref = (
            int(fold.tree_fold(self.q_params)) if self.integrity != "off" else None
        )
        # scrub rebuilds from source: keep the dense tree (the price of
        # recoverability; detect does without)
        self._src_params = params if self.integrity == "scrub" else None
        self._scrubs = 0
        #: host seconds of each scrub (rebuild, fingerprint check, copy)
        self.scrub_s: list = []

    def _requantize(self, params):
        """Source -> serving tree. Load time and a scrub's rebuild share
        this one path, so a rebuild from intact source reproduces the
        load-time fingerprint (under tensor parallelism the source is the
        rank's own: its dense slices, each row slice with its whole K's
        column maxima, and the replicated leaves; see :meth:`_tp_load`).
        ``value_bits`` quantizes the weight values narrower than the
        storage width (a narrow checkpoint served from the uniform-width
        cache)."""
        tp = getattr(self, "tp", None)
        if tp is not None:  # this rank's shard tree, from its source tree
            return shard_source(params, self.policy, tp, cfg=self.cfg,
                                plane_cache=self.plane_cache, value_bits=self._value_bits)
        return quantize_params(params, self.policy, plane_cache=self.plane_cache,
                               value_bits=self._value_bits, cfg=self.cfg)

    def _scrub(self) -> None:
        """Rebuild the quantized tree from the retained source, check its
        fingerprint against the load-time one (a mismatch means the source
        itself is corrupt: :class:`~repro_torch.core.integrity.IntegrityError`
        is the only honest answer), and copy it into the serving leaves in
        place: every leaf keeps its address, which the captured graphs and
        the fold kernel's table hold."""
        if self._src_params is None:
            raise integrity.IntegrityError(
                "scrub requested but source parameters were not retained "
                "(integrity mode is not 'scrub')"
            )
        t0 = time.perf_counter()
        fresh = self._requantize(self._src_params)
        if int(fold.tree_fold(fresh)) != self._params_ref:
            raise integrity.IntegrityError(
                "scrub rebuild fingerprint mismatch: the retained source "
                "parameters are themselves corrupt — cannot recover"
            )
        _copy_tree(self.q_params, fresh)
        del fresh
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.scrub_s.append(time.perf_counter() - t0)
        self._scrubs += 1

    def _audit_params(self, fp: int) -> bool:
        """True if the at-rest parameter fingerprint ``fp`` (read back)
        drifted from the reference. In detect mode the reference is then
        re-baselined, so one upset alarms once, not at every audit; scrub
        keeps the load-time one (its rebuild restores it)."""
        if fp == self._params_ref:
            return False
        if self.integrity == "detect":
            self._params_ref = fp
        return True


class _PlanTuning:
    """Shared autotuner wiring for both engines (the reference's
    ``_PlanTuning``).

    ``autotune=True`` attaches a tile autotuner (``core/autotune``),
    optionally backed by a persistent per-host plan store
    (``runtime/plan_store``), to the process plan registry at construction,
    before any plan of the engine resolves: with a warm store the engine
    starts with zero tuning runs. Engines of one process on one store share
    the tuner and its memo. The tuner's model takes the hardware row of the
    engine's device, fitted to the kernel report that
    ``BENCH_TORCH_KERNEL_JSON`` names when it is set (never the reference's
    ``BENCH_kernel.json``). ``plan_stats`` gives the registry's counters and
    the tuner's store hits, misses and tunes.

    The registry is the process's, so the engine built last decides: an
    engine with ``autotune=False`` detaches any tuner an earlier engine
    attached (and the registry drops that tuner's plans), so it runs the
    default tiles and reports no tuner's counters."""

    def _init_autotune(self, autotune: bool, plan_store_path, device) -> None:
        self.autotuner = None
        if not autotune:
            if plan_store_path:
                raise ValueError(
                    "plan_store_path requires autotune=True (the store is "
                    "only read/written by the attached tuner)"
                )
            plan_mod.DEFAULT_REGISTRY.attach_tuner(None)
            return
        registry = plan_mod.DEFAULT_REGISTRY
        current = registry.tuner
        tp = getattr(self, "tp", None)
        if tp is not None:
            # rank 0 tunes and keeps the store; every rank takes its picks
            if (isinstance(current, RankTuner) and plan_store_path
                    and current.store_path == plan_store_path):
                self.autotuner = current
                return
            inner = self._make_tuner(None, plan_store_path, device) if tp.rank == 0 else None
            self.autotuner = RankTuner(tp, inner, plan_store_path)
        else:
            self.autotuner = self._make_tuner(current, plan_store_path, device)
            if self.autotuner is current:
                return
        registry.attach_tuner(self.autotuner)

    @staticmethod
    def _make_tuner(current, plan_store_path, device):
        """``current`` when it is a tuner on the same store path, else a new
        tuner (on the store at ``plan_store_path``, if given)."""
        from repro_torch.core.autotune import PlanAutotuner, calibrate_from_bench, hardware_model
        from repro_torch.runtime.plan_store import PlanStore

        store = PlanStore(plan_store_path) if plan_store_path else None
        if (
            current is not None
            and store is not None
            and getattr(getattr(current, "store", None), "path", None) == store.path
        ):
            return current
        backend = "cuda" if device.type == "cuda" else "cpu"
        bench_path = os.environ.get("BENCH_TORCH_KERNEL_JSON")
        hw = calibrate_from_bench(bench_path, backend) if bench_path else hardware_model(backend)
        return PlanAutotuner(store=store, hw=hw)

    def plan_stats(self) -> dict:
        reg = plan_mod.DEFAULT_REGISTRY
        out = {
            "registry_hits": reg.hits,
            "registry_misses": reg.misses,
            "resolved": len(reg),
        }
        out.update(reg.store_stats())
        return out


def _check_backend(device, compile_steps: bool, backend: str) -> None:
    if compile_steps and device.type == "cuda" and backend == "torch":
        raise ValueError(
            "backend='torch' runs the plain versions, which read values back "
            "to the host: a CUDA graph cannot capture them; pass "
            "compile_steps=False"
        )


class Engine(_PrecisionDial, _StepRunner, _IntegrityRuntime, _PlanTuning):
    """The lockstep batched generation engine: one fixed batch prefills
    together and decodes in unison (the reference's ``Engine``).

    ``sample_fn(logits, gen) -> (B,) int32`` picks each next token from
    the vocab-masked logits (default greedy). On CUDA each precision's
    decode step is captured as a CUDA graph on a static state of the
    batch's shape and replayed (``compile_steps=False`` runs it eagerly,
    as on the host); a new batch size allocates a new state and captures
    again. With integrity on, prefill and every decode step are checked
    (ABFT), the weight fingerprint is audited every ``audit_interval``
    steps, and scrub mode retries an alarmed step from its pre-step state
    after scrubbing, at most ``max_retries`` times; :attr:`last_alarms`
    counts the alarms of the last :meth:`generate`. ``value_bits`` serves
    weight values quantized narrower than the storage width
    (``quantize_params``); ``autotune`` / ``plan_store_path`` attach the
    tile autotuner (:class:`_PlanTuning`)."""

    def __init__(
        self,
        cfg,
        params,
        policy,
        max_len: int = 256,
        plane_cache: bool = True,
        sample_fn=None,
        seed: int = 0,
        value_bits: Optional[int] = None,
        audit_interval: int = 1,
        max_retries: int = 2,
        autotune: bool = False,
        plan_store_path: Optional[str] = None,
        device=None,
        backend: str = "auto",
        compile_steps: bool = True,
    ):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode path")
        if audit_interval < 0:
            raise ValueError(f"audit_interval must be >= 0, got {audit_interval}")
        self.integrity = integrity.check_integrity_mode(policy.integrity)
        self.device = resolve_device(device)
        self._init_autotune(autotune, plan_store_path, self.device)
        self._value_bits = value_bits
        self.compile_steps = bool(compile_steps)
        _check_backend(self.device, self.compile_steps, backend)
        self.cfg = cfg
        self.policy = policy
        self.plane_cache = plane_cache
        self.max_len = max_len
        self.seed = seed
        self.backend = backend
        self.audit_interval = audit_interval
        self.max_retries = int(max_retries)
        self.sample_fn = sample_fn or sampling.greedy
        params = _to_device(params, self.device)
        self.q_params = self._requantize(params) if policy.default.active else params
        self._init_integrity(params)
        self._state = None  # the static decode state of the last batch shape
        self._runner = (graphs.CudaGraphRunner
                        if self.compile_steps and self.device.type == "cuda" else None)
        #: host seconds of each precision's warm-up and capture
        self.capture_s: dict = {}
        self._compiled_graphs: dict = {}
        self.last_alarms = 0
        self._init_dial()

    def _make_steps(self, precision):
        check = self.integrity != "off"
        pcol = integrity.Collector() if check else None
        scol = integrity.Collector() if check else None
        step = make_serve_step(self.cfg, self.policy, sample_fn=self.sample_fn,
                               precision=precision, backend=self.backend, collector=scol)
        return (
            make_prefill_step(self.cfg, self.policy, max_len=self.max_len,
                              precision=precision, backend=self.backend, collector=pcol),
            _decode_body(step, self.q_params, check),
            pcol,
            scol,
        )

    def _load_state(self, cache, tok) -> None:
        """Copy the prefill's cache and first tokens into the static decode
        state (allocated, and the graphs dropped, when the batch shape
        changes)."""
        st = self._state
        if st is None or st["tokens"].shape != tok.shape:
            st = {"cache": graphs.clone_tree(cache), "tokens": tok.clone()}
            if self.integrity == "scrub":
                st["backup"] = graphs.clone_tree({"cache": cache, "tokens": tok})
            self._state = st
            self._compiled_graphs.clear()
        else:
            _copy_tree(st["cache"], cache)
            st["tokens"].copy_(tok)

    def _decode(self, i: int):
        """Decode step ``i`` on the static state: the read-back vector on
        the device and the alarm flags' keys (a graph replay on CUDA)."""
        return self._run_step(self._compiled_graphs, self._precision, self._step, self._state, i,
                              self._step_col)

    def _checked_step(self, i: int) -> bool:
        """One decode step with its ABFT alarms read back and bounded
        scrub-and-retry; returns whether it alarmed (detect keeps going)."""
        b = self._state["tokens"].shape[0]
        for attempt in range(self.max_retries + 1):
            out, keys = self._decode(i)
            res = self._step_col.harvest(out[b:].cpu(), keys)
            if not any(bad for _, bad in res):
                return False
            if self.integrity != "scrub":
                return True  # detect: record and keep serving
            if attempt < self.max_retries:
                _copy_tree({"cache": self._state["cache"], "tokens": self._state["tokens"]},
                           self._state["backup"])
                self._scrub()
        raise integrity.IntegrityError(
            f"ABFT alarm persisted through {self.max_retries} scrub-and-retry "
            "attempts — corruption is not in the scrubbable weight planes"
        )

    def _checked_prefill(self, prompts):
        prefill, pcol = self._prefill, self._prefill_col
        with record_function("serve.prefill"):
            if pcol is None:
                logits, cache = prefill(self.q_params, prompts)
                return logits, cache, 0
            logits, cache, alarms = prefill(self.q_params, prompts)
            if not any(bad for _, bad in pcol.harvest(alarms.cpu())):
                return logits, cache, 0
            if self.integrity == "scrub":
                self._scrub()
                logits, cache, alarms = prefill(self.q_params, prompts)
                if any(bad for _, bad in pcol.harvest(alarms.cpu())):
                    raise integrity.IntegrityError("prefill ABFT alarm persisted after scrub")
            return logits, cache, 1

    def generate(self, prompts, n_tokens: int):
        """``prompts``: (B, S) integer tokens (a tensor or host data).
        Decodes ``n_tokens`` through ``sample_fn``; returns (tokens (B,
        n_tokens) int32 on the engine's device, decode tok/s)."""
        prompts = torch.as_tensor(np.asarray(prompts) if not isinstance(prompts, torch.Tensor)
                                  else prompts).to(device=self.device, dtype=torch.int32)
        check = self.integrity != "off"
        last_logits, cache, alarm_count = self._checked_prefill(prompts)
        logits = sampling.mask_vocab(last_logits, self.cfg.vocab_size)
        tok = self.sample_fn(logits, _seeded(self.seed, 1, 0, self.device))[:, None]
        self._load_state(cache, tok.to(torch.int32))
        del cache
        b = prompts.shape[0]
        out = torch.empty((b, n_tokens), dtype=torch.int32, device=self.device)
        out[:, 0] = self._state["tokens"][:, 0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for i in range(n_tokens - 1):
            if check and self.audit_interval and i % self.audit_interval == 0:
                if self._audit_params(int(fold.tree_fold(self.q_params))):
                    alarm_count += 1
                    if self.integrity == "scrub":
                        self._scrub()
            with record_function("serve.decode_step"):
                if check:
                    alarm_count += int(self._checked_step(i + 1))
                else:
                    self._decode(i + 1)
                out[:, i + 1] = self._state["tokens"][:, 0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.last_alarms = alarm_count
        return out, b * max(n_tokens - 1, 1) / max(dt, 1e-9)


_DEGRADE_ALIAS_WARNED = False


def _degrade_alias_policy(degrade_after: Optional[int], degrade_to: int) -> AutopilotPolicy:
    """The engine's ``degrade_after``/``degrade_to`` arguments as the
    autopilot policy they always were: a pure scrub-rate rule (no SLA, so
    depth and latency pressure never fire) that drops to the
    ``degrade_to`` tier once the scrub counter crosses the threshold."""
    return AutopilotPolicy(
        scrub_degrade_after=degrade_after,
        scrub_degrade_to=degrade_to,
        shed=False,
    )


@dataclasses.dataclass
class _PrefillJob:
    """One staged prefill in flight: the request owns a reserved slot and a
    raw bf16 scratch cache that fills in chunks — one chunk per engine
    iteration under ``prefill_chunk``, or the whole prompt at admission
    (``prefill_chunk=0``). Commit quantizes the scratch once and installs
    it (paged scatter or dense ``insert_slot``), then the slot decodes."""

    slot: int
    req: Request
    steps: tuple  # (prefill_fn, collector) at the admission dial
    precision: object  # the admission-time dial (registry tag)
    scratch: object
    bounds: list  # [(a, b), ...] token ranges to prefill
    tier_index: int = 0  # the autopilot rung it was admitted at
    next_i: int = 0
    logits: object = None  # last chunk's (1, V) last-token logits
    table: object = None  # paged: (pages_per_slot,) block-table row
    mask: object = None  # paged: owned-page write mask
    snapshot_at: int = -1  # chunk index whose result is the prefix snapshot
    snapshot: object = None
    prefix_tokens: object = None  # register these at commit (miss path)
    prefix_pages: tuple = ()
    from_hit: bool = False  # resumed from a registry snapshot
    # detect: [(keys, alarm vector on the device)] per chunk, read back at
    # commit (scrub reads each chunk's alarms back before the next chunk)
    alarms: list = dataclasses.field(default_factory=list)


class ContinuousBatchingEngine(_PrecisionDial, _StepRunner, _IntegrityRuntime, _PlanTuning):
    """Slot-scheduled serving over a shared, optionally int8, KV cache.

    ``n_slots`` decode lanes share one slot cache of ``max_len`` positions
    per slot. :meth:`run` drives a :class:`SlotScheduler`: each iteration
    admits pending requests into free slots (a staged prefill into a raw
    scratch, committed by :func:`insert_slot` or the page scatter), then
    runs one decode pass over the whole slot array; each prefill and
    decode step is a
    ``torch.profiler`` range (``serve.prefill``, ``serve.decode_step``),
    free when no profiler runs. ``backend`` picks the matmul kernels:
    ``"auto"`` (the Hopper kernels on CUDA) or ``"torch"`` (the plain
    versions, on any device). ``audit_interval``: with integrity on, the
    at-rest parameter audit runs every N iterations (0 disables it and
    the KV checks, leaving the per-matmul ABFT checks). In scrub mode
    ``max_retries`` bounds the scrub-and-retry attempts of one step and a
    request's KV requeues, and a slot (or page) that faults
    ``quarantine_after`` times is retired; the engine keeps ``params``
    (the given tree, not a copy) as the scrub's source.

    ``page_size > 0`` pages the KV cache (``kv_quant`` required, ``max_len``
    a multiple of it): ``kv_pages`` physical pages (default: every slot's
    full extent plus the null page), admission by free pages.
    ``prefill_chunk > 0`` runs each prefill in chunks of that many tokens,
    one per iteration (paged or dense; 0: the whole prompt at admission);
    ``share_prefixes`` (paged) maps the
    pages of a request's declared shared prefix read-only from an earlier
    request's and resumes prefill from its snapshot.

    ``autopilot`` (an :class:`~repro_torch.runtime.autopilot.AutopilotPolicy`)
    closes the loop on the precision dial (module docstring): the ladder is
    clamped to the storage width, whose rung is the static engine's own
    steps; ``degrade_after``/``degrade_to`` are the deprecated spelling of
    a pure scrub-rate policy (they warn once per process).

    ``value_bits`` serves weight values quantized narrower than the
    storage width (``quantize_params``); ``autotune`` /
    ``plan_store_path`` attach the tile autotuner (:class:`_PlanTuning`),
    and ``stats()["plans"]`` reports its counters.

    ``compile_steps`` (default): on CUDA each precision's decode step is
    captured as a CUDA graph and replayed; a capture or replay error
    raises. ``False`` runs the step eagerly, as on the host (where it is
    the only mode); the plain versions (``backend="torch"``) read values
    back and need it on CUDA.

    ``params``: the dense tree, or :class:`SeededParams` (the tree
    ``init_params`` draws from a seed, drawn here on the engine's device).

    ``model_parallel=P > 1`` serves tensor-parallel (``sharding/tp.py``),
    one engine per rank of an initialised default process group of world
    size P (``launch/mesh.spawn_ranks``), every rank given the same
    arguments: each holds its shard of the plane caches (column-, row- and
    vocab-parallel; replicated projections whole: the SSM's and the
    RG-LRU's, the MoE router and experts, the VLM's front end, a dense vocab
    head) and a KV cache of ``n_kv_heads / P`` heads (dense or paged, the
    hybrid's ring too; recurrent state whole), runs the tensor-parallel
    steps, and returns the tokens the single-device engine returns, in
    every family the reference serves this way and with scrub, the
    autopilot and the tile autotuner. A rank never holds the whole dense
    tree: given a tree (it may lie on the host) it slices each weight where
    it lies and moves only its slice to its device; given
    :class:`SeededParams` it draws one part at a time and keeps its shard of
    each (``sharding.tp.load_shard``). In scrub mode it keeps as its source
    its own dense slices and the replicated leaves. A dense column- or
    row-parallel projection raises (reference defect I). Over NCCL the
    decode steps capture into CUDA graphs with their collectives; gloo's
    collectives cannot be captured, so on CUDA over gloo
    ``compile_steps=True`` raises.
    """

    def __init__(
        self,
        cfg,
        params,
        policy,
        n_slots: int = 4,
        max_len: int = 256,
        kv_quant: bool = True,
        plane_cache: bool = True,
        seed: int = 0,
        device=None,
        backend: str = "auto",
        audit_interval: int = 1,
        page_size: int = 0,
        kv_pages: Optional[int] = None,
        prefill_chunk: int = 0,
        share_prefixes: bool = False,
        compile_steps: bool = True,
        max_retries: int = 2,
        quarantine_after: int = 2,
        autopilot: Optional[AutopilotPolicy] = None,
        degrade_after: Optional[int] = None,
        degrade_to: int = 4,
        value_bits: Optional[int] = None,
        autotune: bool = False,
        plan_store_path: Optional[str] = None,
        model_parallel: int = 1,
    ):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode path")
        self.integrity = integrity.check_integrity_mode(policy.integrity)
        self.model_parallel = int(model_parallel)
        self.tp = self._tp_context(cfg, policy) if self.model_parallel > 1 else None
        #: the config the caches are built with: the rank's heads under TP
        self._kv_cfg = cfg if self.tp is None else self.tp.local_config(cfg)
        self.max_retries = int(max_retries)
        self.quarantine_after = int(quarantine_after)
        if audit_interval < 0:
            raise ValueError(f"audit_interval must be >= 0, got {audit_interval}")
        # paged KV + staged (chunked) prefill
        self.page_size = int(page_size)
        self.paged = self.page_size > 0
        self.prefill_chunk = int(prefill_chunk)
        self.share_prefixes = bool(share_prefixes)
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if self.share_prefixes and not self.paged:
            raise ValueError(
                "share_prefixes needs the paged KV cache (page_size > 0): "
                "physical pages are the sharing unit"
            )
        self._pages_per_slot = 0
        self._kv_pages = 0
        if self.paged:
            if not kv_quant:
                raise ValueError(
                    "paged KV requires kv_quant=True: pages hold int8 values "
                    "plus their per-(position, head) scale vectors — there is "
                    "no raw bf16 page layout"
                )
            if max_len % self.page_size:
                raise ValueError(
                    f"max_len={max_len} must be divisible by "
                    f"page_size={self.page_size} so a slot's pages span "
                    "the dense extent"
                )
            self._pages_per_slot = max_len // self.page_size
            self._kv_pages = (
                int(kv_pages) if kv_pages is not None
                else n_slots * self._pages_per_slot + 1
            )
            if self._kv_pages < self._pages_per_slot + 1:
                raise ValueError(
                    f"kv_pages={self._kv_pages} cannot hold one full slot "
                    f"({self._pages_per_slot} pages) plus the null page"
                )
            paging._check_kinds(cfg)  # fail at construction, not first run
        elif kv_pages is not None:
            raise ValueError("kv_pages needs page_size > 0 (paged KV)")
        self.audit_interval = audit_interval
        self.device = resolve_device(device)
        self._init_autotune(autotune, plan_store_path, self.device)
        self._value_bits = value_bits
        self.compile_steps = bool(compile_steps)
        _check_backend(self.device, self.compile_steps, backend)
        if (self.tp is not None and self.compile_steps and self.device.type == "cuda"
                and torch.distributed.get_backend() != "nccl"):
            raise ValueError(
                f"compile_steps=True under model_parallel={self.model_parallel} needs the "
                f"NCCL backend: {torch.distributed.get_backend()}'s collectives cannot be "
                "captured in a CUDA graph; pass compile_steps=False"
            )
        self.cfg = cfg
        self.policy = policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.plane_cache = plane_cache
        self.seed = seed
        self.backend = backend
        self.autopilot_policy = self._autopilot_policy(policy, autopilot, degrade_after,
                                                       degrade_to)
        if self.tp is None:
            if isinstance(params, SeededParams):
                params = init_params(cfg, params.generator(self.device), device=self.device)
            params = _to_device(params, self.device)
            self.q_params = self._requantize(params) if policy.default.active else params
        else:  # a rank holds only its slices
            self.q_params, params = self._tp_load(params)
        self._init_integrity(params)
        # the decode state: allocated once (a captured graph holds its
        # addresses), reset in place by every run
        if self.paged:
            self._cache = paging.paged_init_cache(
                self._kv_cfg, n_slots, max_len, self.page_size, self._kv_pages,
                device=self.device)
        else:
            self._cache = init_cache(self._kv_cfg, n_slots, max_len, cfg.dtype,
                                     kv_quant=kv_quant, device=self.device)
        self._tokens = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        ap = self.autopilot_policy
        written = {"cache": self._cache, "tokens": self._tokens}
        # the state a decode step writes, copied by the step itself before it
        # writes (a static copy: the graph holds its address): a scrub
        # retry's and every mixed-tier pass's pre-step state
        self._backup = (graphs.clone_tree(written)
                        if self.integrity == "scrub" or ap is not None else None)
        # mixed-tier decode: the rows earlier passes leave for the last
        # one, and the host-built masks of each merge (rows: the slots,
        # then the pages, each pass takes; the restore after the last pass;
        # the active slots the shadow probe averages over)
        self._merge = graphs.clone_tree(written) if ap is not None else None
        self._shadow_scratch = (graphs.clone_tree(written)
                                if ap is not None and ap.shadow_frac > 0 else None)
        if ap is not None:
            shape = (len(self._tiers) + 2, n_slots + self._kv_pages)
            self._mask_host = torch.zeros(shape, dtype=torch.bool,
                                          pin_memory=self.device.type == "cuda")
            self._mask_dev = torch.zeros(shape, dtype=torch.bool, device=self.device)
        self._temps = torch.zeros((n_slots,), dtype=torch.float32, device=self.device)
        self._temps_host = torch.zeros((n_slots,), dtype=torch.float32,
                                       pin_memory=self.device.type == "cuda")
        self._temps_set: Optional[tuple] = None
        #: the CUDA-graph runner (tests substitute one); None: eager steps
        self._runner = (graphs.CudaGraphRunner
                        if self.compile_steps and self.device.type == "cuda" else None)
        #: host seconds of each precision's warm-up and capture (the shadow
        #: probe's graphs under ("shadow", tier))
        self.capture_s: dict = {}
        self._compiled_graphs: dict = {}
        self._shadow_graphs: dict = {}
        self._shadow_bodies: dict = {}
        self._last_stats: dict = {}
        self._init_dial()

    def _tp_context(self, cfg, policy) -> TPContext:
        """Validate a tensor-parallel engine (the reference's checks and
        messages) and return its context over the default process group."""
        p = self.model_parallel
        if not policy.default.active:
            raise ValueError(
                "model_parallel > 1 requires an active quantization policy: TP "
                "relays out the quantized serving tree (shard_quantized), there is "
                "no dense TP path"
            )
        check_exact_bits(policy.default.a_bits, policy.default.w_bits)
        TPContext(size=p).local_config(cfg)  # fail fast on head divisibility
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != p:
            raise ValueError(
                f"model_parallel={p} needs an initialised default process group of "
                f"world size {p}, one engine per rank (launch/mesh.spawn_ranks)"
            )
        return TPContext(size=p, rank=dist.get_rank())

    def _tp_load(self, params):
        """This rank's shard tree and, in scrub mode, its source tree (else
        None): from a whole dense tree (sliced where it lies), or drawn one
        part at a time from :class:`SeededParams` (``sharding.tp.load_shard``),
        so the whole dense tree is never held."""
        scrub = self.integrity == "scrub"
        kw = dict(plane_cache=self.plane_cache, value_bits=self._value_bits, device=self.device,
                  with_source=scrub)
        if isinstance(params, SeededParams):
            out = load_shard(self.cfg, params.generator(self.device), self.policy, self.tp, **kw)
        else:
            out = shard_quantized(params, self.policy, self.tp, cfg=self.cfg, **kw)
        return out if scrub else (out, None)

    def _autopilot_policy(self, policy, autopilot, degrade_after, degrade_to):
        """The engine's autopilot policy, its ladder clamped to the storage
        width (rung 0 is the storage width itself), or None; sets
        ``_tiers``."""
        if degrade_after is not None:
            global _DEGRADE_ALIAS_WARNED
            if not _DEGRADE_ALIAS_WARNED:
                warnings.warn(
                    "degrade_after/degrade_to are deprecated: pass "
                    "autopilot=AutopilotPolicy(scrub_degrade_after=..., "
                    "scrub_degrade_to=...) instead (the arguments construct "
                    "exactly that policy)",
                    DeprecationWarning,
                    stacklevel=3,
                )
                _DEGRADE_ALIAS_WARNED = True
            if autopilot is not None:
                raise ValueError(
                    "pass either autopilot= or the deprecated degrade_after/"
                    "degrade_to aliases, not both — fold the scrub rule into "
                    "the policy via scrub_degrade_after/scrub_degrade_to"
                )
            autopilot = _degrade_alias_policy(degrade_after, degrade_to)
        self._tiers = ()
        if autopilot is None:
            return None
        stored = policy.storage_width()
        if stored is None:
            raise ValueError(
                "autopilot needs an active quantization policy (the tier "
                "ladder truncates the stored decomposition)"
            )
        # keep the servable rungs; the widest is pinned to the storage width
        # so tier 0 is the static engine (the same steps, the same tokens)
        tiers = tuple(
            (min(a, stored), min(w, stored)) for a, w in autopilot.tiers if min(a, w) <= stored
        )
        tiers = tuple(dict.fromkeys(tiers))  # dedupe, keep order
        if tiers[0] != (stored, stored):
            tiers = ((stored, stored),) + tiers
        self._tiers = tiers
        # the controller sees the clamped ladder: rung indices are shared
        # between its state and the engine's dispatch
        return dataclasses.replace(autopilot, tiers=tiers)

    # -- runtime precision dial ---------------------------------------------

    def _make_steps(self, precision):
        check = self.integrity != "off"
        pcol = integrity.Collector() if check else None
        scol = integrity.Collector() if check else None
        tp = () if self.tp is None else (self.tp,)
        step = (make_cb_decode_step if self.tp is None else make_tp_cb_decode_step)(
            self.cfg, *tp, policy=self.policy, precision=precision, backend=self.backend,
            collector=scol,
        )
        return (
            # staged: every prefill chunk is given the job's raw scratch
            (make_prefill_step if self.tp is None else make_tp_prefill_step)(
                self.cfg, *tp, policy=self.policy, precision=precision, backend=self.backend,
                collector=pcol,
            ),
            _decode_body(step, self.q_params, check),
            pcol,
            scol,
        )

    def plane_cache_bytes_per_device(self) -> int:
        """Bytes of the packed-plane caches this engine's device holds (its
        shard under tensor parallelism: ~1/P of the single-device engine's)."""
        return plane_cache_device_bytes(self.q_params)

    def _tier_precision(self, tier_index: int) -> Optional[Tuple[int, int]]:
        """Ladder rung -> the dial it runs at. Rung 0 (the storage width)
        maps to ``None``, so traffic that was never degraded runs the static
        engine's own steps and graph."""
        return None if tier_index == 0 else self._tiers[tier_index]

    def _decode(self, step_i: int, precision=Ellipsis):
        """One decode pass over the slot array at ``precision`` (default:
        the dial): returns the read-back vector on the device (the next
        tokens, then the alarm flags) and, under integrity, the plan keys of
        the flags. On CUDA the pass replays this precision's graph, captured
        at its first step."""
        if precision is Ellipsis:
            precision = self._precision
        _, body, _, scol = self._steps_for(precision)
        state = {"cache": self._cache, "tokens": self._tokens, "temps": self._temps}
        if self._backup is not None:
            state["backup"] = self._backup
        return self._run_step(self._compiled_graphs, precision, body, state, step_i, scol)

    def _shadow_bits(self, step_i: int, tier_index: int) -> torch.Tensor:
        """The shadow probe's KL(storage || tier ``tier_index``) from the
        pre-step state in the backup, as (1,) int64 bits (a graph replay per
        tier on CUDA)."""
        body = self._shadow_bodies.get(tier_index)
        if body is None:
            tp = () if self.tp is None else (self.tp,)
            make = make_cb_decode_step if self.tp is None else make_tp_cb_decode_step
            steps = [make(self.cfg, *tp, policy=self.policy, precision=p,
                          backend=self.backend, with_logits=True)
                     for p in (None, self._tier_precision(tier_index))]
            body = self._shadow_bodies[tier_index] = _shadow_body(
                *steps, self.q_params, self.cfg.vocab_size)
        state = {"scratch": self._shadow_scratch, "backup": self._backup,
                 "temps": self._temps, "active": self._mask_dev[-1, :self.n_slots]}
        return self._run_step(self._shadow_graphs, ("shadow", tier_index), body, state,
                              step_i)[0]

    def _set_temperatures(self, temps) -> None:
        """Copy the slots' temperatures into the static buffer when they
        changed (through pinned memory on the card: no host sync)."""
        key = tuple(float(t) for t in temps)
        if key == self._temps_set:
            return
        self._temps_host.copy_(torch.as_tensor(temps, dtype=torch.float32))
        self._temps.copy_(self._temps_host, non_blocking=True)
        self._temps_set = key

    def _set_masks(self, pass_of: np.ndarray, n_passes: int, active, pager) -> None:
        """Build a mixed-tier step's merge masks on the host and copy them
        in through pinned memory (no host sync; the step's read-back orders
        the next step's write after this copy). ``pass_of[s]``: the pass
        whose result slot ``s`` keeps."""
        n, last = self.n_slots, n_passes - 1
        rows = np.zeros(tuple(self._mask_host.shape), bool)
        page_pass = np.zeros((self._kv_pages,), np.int64)
        if self.paged:
            # pool leaves merge per physical page: a page takes the pass of
            # the slot that owns it (decode writes only owned pages)
            for s in active:
                for pid in pager.owned_pages(s):
                    page_pass[pid] = pass_of[s]
        for p in range(last):
            rows[p, :n] = pass_of == p
            rows[p, n:] = page_pass == p
        rows[-2, :n] = pass_of != last  # after the last pass: put back the rest
        rows[-2, n:] = page_pass != last
        rows[-1, list(active)] = True
        self._mask_host.copy_(torch.from_numpy(rows))
        self._mask_dev.copy_(self._mask_host, non_blocking=True)

    def _merge_rows(self, dst: dict, src: dict, row: int) -> None:
        """``dst = where(mask row, src, dst)`` over the decode state, in place."""
        m = self._mask_dev[row]
        slots = m[:self.n_slots]
        if self.paged:
            paging.select_paged(dst["cache"], src["cache"], slots, m[self.n_slots:],
                                out=dst["cache"])
        else:
            select_slots(dst["cache"], src["cache"], slots, out=dst["cache"])
        torch.where(slots[:, None], src["tokens"], dst["tokens"], out=dst["tokens"])

    def _reset_state(self) -> None:
        """Zero the decode state in place: the state a fresh allocation
        gives, at the addresses the captured graphs hold."""
        self._cache["step"].zero_()
        for blk in self._cache["layers"]:
            for leaf in blk.values():
                leaf.zero_()
        self._tokens.zero_()

    # -- integrity: detection and recovery -----------------------------------

    def _restore_state(self) -> None:
        """Put back the decode state the last step wrote (a retry, and each
        pass of a mixed-tier step after the first)."""
        _copy_tree({"cache": self._cache, "tokens": self._tokens}, self._backup)

    def _kv_folds(self, cache) -> tuple:
        """The KV checksums on the device: ``(slot_sums,)`` of the dense
        cache, ``(page_sums, slot_sums)`` of the paged one."""
        return fold.page_folds(cache) if self.paged else (fold.slot_folds(cache),)

    def _kv_moved(self, cache, ref) -> torch.Tensor:
        """Which checksums moved since ``ref``, as one bool vector on the
        device: the dense cache's slots, or the paged cache's pages 1.. (the
        null page is left out: free lanes scatter there every step) then
        its slots."""
        moved = [a != b for a, b in zip(self._kv_folds(cache), ref)]
        if self.paged:
            moved[0] = moved[0][1:]
        return torch.cat(moved)

    def _tally_folds(self, pending: list, vals, integ: dict, injector) -> None:
        """Tally read-back at-rest results in the order they were taken:
        ("audit", step, fingerprint) and ("kv", step, checksums that moved).
        Under tensor parallelism each rank audits its own shard and KV
        heads, and the ranks' results are maximized before the tally: an
        alarm on any rank is an alarm on every rank."""
        found = [int(self._audit_params(int(v))) if kind == "audit" else int(v)
                 for (kind, _, _), v in zip(pending, vals.tolist())]
        if self.tp is not None:
            found = self.tp.reduce_max_host(found, self.device)
        for (kind, step, _), v in zip(pending, found):
            category = "params" if kind == "audit" else "kv"
            integ["audit_alarms" if kind == "audit" else "kv_alarms"] += v
            if v and injector is not None:
                injector.mark_detected(category, step)
        pending.clear()

    @staticmethod
    def _harvest(col, alarms, integ: dict, keys=None) -> bool:
        """Tally one step's read-back alarm vector: every flag is a check,
        a step with any flag set is one alarm. Returns whether it alarmed."""
        res = col.harvest(alarms, keys)
        integ["abft_checks"] += len(res)
        bad = any(b for _, b in res)
        integ["abft_alarms"] += int(bad)
        return bad

    def _contain_kv(self, sched, bad_slots, slot_faults: dict, step_i: int, integ: dict):
        """Scrub-mode KV containment: a corrupt slot's request is requeued
        (it re-prefills from its prompt — KV is regenerable state, unlike
        weights it has no retained source) with exponential backoff;
        repeatedly faulting slots are quarantined."""
        active = set(sched.active_slots)
        for slot in bad_slots:
            slot_faults[slot] = slot_faults.get(slot, 0) + 1
            if slot in active:
                backoff = 1 << min(slot_faults[slot], 4)
                rid = sched.requeue(slot, arrival_step=step_i + backoff)
                integ["requeued"] += 1
                if sched.retries(rid) > self.max_retries:
                    sched.drop_pending(
                        rid, f"retry budget exhausted: {sched.retries(rid)} KV faults "
                        f"on request {rid}")
            # a flip in a free slot's extent is harmless now, but the slot
            # itself is suspect: it counts toward quarantine
            if slot_faults[slot] >= self.quarantine_after and slot not in sched.quarantined_slots:
                sched.quarantine(slot)
                integ["quarantined"] += 1

    # -- serving loop -------------------------------------------------------

    def _first_token(self, logits, request: Request) -> torch.Tensor:
        logits = sampling.mask_vocab(logits, self.cfg.vocab_size)
        gen = _seeded(self.seed, 0, request.rid, self.device)
        temps = torch.full(
            (logits.shape[0],), request.temperature, dtype=torch.float32, device=self.device
        )
        return sampling.sample_tokens(logits, temps, gen)[0]

    def stats(self) -> dict:
        """Stats of the last :meth:`run`."""
        return dict(self._last_stats)

    # -- staged prefill + paged KV ------------------------------------------

    def _open_job(self, slot, req, sched, pager, registry, precision) -> _PrefillJob:
        """Reserve ``slot`` and stage ``req``'s prefill at ``precision`` (the
        admission dial): resolve the shared-prefix registry (hit: map its
        pages read-only and resume from its scratch snapshot; miss: cut the
        chunk schedule at the prefix boundary and snapshot there for
        registration at commit), assign pages, and lay out the chunk
        bounds."""
        sched.reserve(slot)
        S = int(req.tokens.size)
        # always leave >= 1 suffix token: the request's first sampled token
        # needs the last prompt position's logits from its own chunk
        Lp = (
            min(int(req.shared_prefix_len), S - 1)
            if (self.share_prefixes and req.shared_prefix_len > 0)
            else 0
        )
        entry = registry.lookup(req.tokens[:Lp], tag=precision) if Lp else None
        if entry is not None:
            scratch, start, shared = entry.scratch, Lp, list(entry.page_ids)
        else:
            scratch = init_cache(self._kv_cfg, 1, self.max_len, self.cfg.dtype,
                                 kv_quant=False, device=self.device)
            start, shared = 0, []
        c = self.prefill_chunk if self.prefill_chunk > 0 else S
        bounds, pos = [], start
        while pos < S:
            nxt = min(pos + c, S)
            if entry is None and Lp and pos < Lp:
                nxt = min(nxt, Lp)  # miss: land a chunk edge exactly at Lp
            bounds.append((pos, nxt))
            pos = nxt
        prefill, _, pcol, _ = self._steps_for(precision)
        job = _PrefillJob(slot=slot, req=req, steps=(prefill, pcol),
                          precision=precision, scratch=scratch, bounds=bounds,
                          from_hit=entry is not None)
        if entry is None and Lp:
            job.snapshot_at = next(i for i, (_, b) in enumerate(bounds) if b == Lp)
            job.prefix_tokens = req.tokens[:Lp].copy()
        if self.paged:
            n_total = pager.pages_needed(S + req.max_new_tokens - 1)
            job.table, job.mask = pager.assign(slot, shared, n_total)
            if job.prefix_tokens is not None:
                job.prefix_pages = tuple(int(p) for p in job.table[: Lp // self.page_size])
        return job
    def _job_step(self, job: _PrefillJob, integ) -> bool:
        """Run the job's next chunk; True when the prefill is complete."""
        a, b = job.bounds[job.next_i]
        toks = torch.as_tensor(job.req.tokens[a:b], device=self.device)[None, :]
        prefill, pcol = job.steps
        with record_function("serve.prefill"):
            if pcol is None:
                job.logits, job.scratch = prefill(self.q_params, toks, job.scratch)
            elif self.integrity == "scrub":
                job.logits, job.scratch = self._chunk_scrubbed(job, toks, integ)
            else:
                job.logits, job.scratch, alarms = prefill(self.q_params, toks, job.scratch)
                job.alarms.append((pcol.keys, alarms))
        if job.next_i == job.snapshot_at:
            job.snapshot = job.scratch
        job.next_i += 1
        return job.next_i >= len(job.bounds)

    def _chunk_scrubbed(self, job: _PrefillJob, toks, integ):
        """One prefill chunk with its alarms read back at once and bounded
        scrub-and-retry: a retry re-runs the chunk on the same pre-chunk
        scratch (the step never writes its input). Returns (logits,
        scratch)."""
        prefill, pcol = job.steps
        for attempt in range(self.max_retries + 1):
            logits, scratch, alarms = prefill(self.q_params, toks, job.scratch)
            if not self._harvest(pcol, alarms.cpu(), integ, pcol.keys):
                return logits, scratch
            if attempt < self.max_retries:
                self._scrub()
                integ["step_retries"] += 1
        raise integrity.IntegrityError(
            f"chunked-prefill ABFT alarm (rid {job.req.rid}) persisted through "
            f"{self.max_retries} scrub-and-retry attempts"
        )

    def _settle(self, job: _PrefillJob, integ, tok=None) -> Optional[int]:
        """One read-back of the first token ``tok`` (a device tensor, at
        commit) together with the alarm vectors of the job's chunks since
        the last read-back, which are tallied; returns the token."""
        parts = [] if tok is None else [tok.reshape(1).to(torch.int64)]
        parts += [alarms.to(torch.int64) for _, alarms in job.alarms]
        vals = torch.cat(parts).cpu() if parts else None
        at = 0 if tok is None else 1
        for keys, alarms in job.alarms:
            self._harvest(job.steps[1], vals[at:at + alarms.numel()], integ, keys)
            at += alarms.numel()
        job.alarms.clear()
        return None if tok is None else int(vals[0])

    def _job_commit(self, job, cache, tokens, sched, pager, registry, integ):
        """Install the finished scratch (paged scatter or dense insert),
        sample the first token, start the slot. Returns the cache."""
        req, slot = job.req, job.slot
        with record_function("serve.prefill"):
            tok = self._settle(job, integ, self._first_token(job.logits, req))
            if self.paged:
                cache = paging.paged_commit(cache, job.scratch, slot, job.table, job.mask,
                                            int(req.tokens.size))
                if job.prefix_tokens is not None and registry is not None:
                    registry.register(job.prefix_tokens, job.prefix_pages, job.snapshot,
                                      tag=job.precision)
            else:
                seq = quantize_scratch(job.scratch) if self.kv_quant else job.scratch
                cache = insert_slot(cache, seq, slot)
        tokens[slot, 0] = tok
        done_now = sched.start(slot, req, tok)
        if done_now and self.paged:
            # clear immediately, not deferred: a same-iteration admission
            # may reallocate the freed pages before the next flush point,
            # and this lane's garbage decode write must land on the null
            # page, not in the new tenant's data
            pager.release(slot)
            cache = paging.clear_slot(cache, slot)
        return cache


    def run(self, requests: list[Request], precision_schedule: Optional[dict] = None,
            injector: Optional[FaultInjector] = None):
        """Serve ``requests`` to completion. Returns (results, stats):
        ``results`` maps rid -> generated int32 tokens; requests that cannot
        finish (deadline passed, retry budget exhausted, no servable slot
        left, shed under overload) land in ``stats['failed']`` (rid ->
        reason) instead.

        ``precision_schedule``: optional ``{decode_step: precision}`` over
        the decode-step counter; at each threshold the engine calls
        :meth:`set_precision` before that step. Switches are recorded in
        ``stats['precision_switches']`` as (decode_step, (a, w)). With an
        autopilot a scheduled entry is routed through the controller
        (``Autopilot.force``); one due on the decode step the controller
        switches on loses, is consumed and is recorded in
        ``stats['autopilot']['schedule_conflicts']``.

        ``injector``: a :class:`~repro_torch.runtime.faults.FaultInjector`
        (or a spec string) applied at the top of each engine iteration, the
        SEU harness. Under integrity its events are marked as the
        detectors fire; in scrub mode every weight fault is scrubbed (and
        an alarmed step retried) and KV faults are contained per slot or
        page (requeue, quarantine).

        With an autopilot the controller observes (queue depth, per-token
        latency, scrub count, shadow KL) every iteration and moves the
        admission tier; in-flight requests keep theirs (mixed-tier decode),
        and under sustained pressure at the lowest tier the queue tail is
        shed (``stats['autopilot']``: switches, per-tier tokens, shed
        counts and the quality probe)."""
        if isinstance(injector, (str, FaultSpec)):
            injector = FaultInjector(injector)
        if self.tp is not None:
            # Every rank must take the same host decisions, or the next
            # collective deadlocks. The workload and the precision schedule
            # are rank 0's, broadcast; everything else is the same on every
            # rank by construction: scheduling and deadlines count steps,
            # greedy and seeded sampling read the gathered logits (so does
            # the shadow probe's KL), and ABFT alarms (in the steps) and
            # at-rest results (_tally_folds, scrub's read-back) are
            # maximized over the ranks before the engine reads them. The
            # timed inputs are rank 0's: the autopilot's step latency is
            # broadcast before the controller reads it, and the tile
            # tuner's picks as each plan resolves (sharding.tp.RankTuner).
            requests, precision_schedule = self.tp.broadcast_object(
                (requests, precision_schedule))
        schedule = dict(precision_schedule or {})
        sched = SlotScheduler(self.n_slots, max_extent=self.max_len)
        for r in sorted(requests, key=lambda r: r.arrival_step):
            sched.submit(r)
        allocator = pager = registry = None
        job: Optional[_PrefillJob] = None
        clears: list[int] = []  # deferred null-page clears (flushed pre-admission)
        page_faults: dict[int, int] = {}
        slot_faults: dict[int, int] = {}
        prefill_chunks = 0
        shared_hits = 0
        capacity = None
        self._reset_state()
        cache, tokens = self._cache, self._tokens
        capture0 = dict(self.capture_s)
        ap = (Autopilot(self.autopilot_policy, self.n_slots)
              if self.autopilot_policy is not None else None)

        def admission_precision():
            return self._tier_precision(ap.tier_index) if ap is not None else self._precision

        if self.paged:
            allocator = paging.PageAllocator(self._kv_pages, self.page_size)
            pager = paging.SlotPager(allocator, self.n_slots, self._pages_per_slot)
            if self.share_prefixes:
                registry = paging.PrefixRegistry(allocator)
            page_nbytes = paging.page_nbytes(cache)

            def capacity(req: Request) -> bool:
                # free-page admission gate: the ask is the request's full
                # extent minus whatever a registry hit would map shared;
                # under pressure, evict cold registry entries (their pages
                # free once no live slot also maps them)
                S = int(req.tokens.size)
                need = pager.pages_needed(S + req.max_new_tokens - 1)
                protect = None
                if self.share_prefixes and req.shared_prefix_len > 0:
                    Lp = min(int(req.shared_prefix_len), S - 1)
                    if Lp:
                        prec = admission_precision()
                        protect = registry.key(req.tokens[:Lp], tag=prec)
                        hit = registry.peek(req.tokens[:Lp], tag=prec)
                        if hit is not None:
                            need -= len(hit.page_ids)
                while (allocator.free_pages < need and registry is not None
                       and registry.evict_oldest(protect)):
                    pass
                return allocator.free_pages >= need
        kv_bytes = cache_kv_bytes(cache)
        check = self.integrity != "off"
        scrub = self.integrity == "scrub"
        # the KV checksums' baseline stays on the device; in detect mode the
        # at-rest results wait in ``pending`` for the next read-back
        kv_ref = self._kv_folds(cache) if check else None
        pending: list = []
        integ = {
            "audits": 0, "audit_alarms": 0,
            "abft_checks": 0, "abft_alarms": 0,
            "kv_checks": 0, "kv_alarms": 0,
            "step_retries": 0, "requeued": 0, "quarantined": 0,
        }
        if self.paged:
            integ["page_faults"] = 0
            integ["pages_quarantined"] = 0
        scrubs0 = self._scrubs
        calls0 = collections.Counter(plan_mod.DEFAULT_REGISTRY.calls)
        slot_tier: dict[int, int] = {}  # in-flight tier contracts
        request_tiers: dict[int, tuple] = {}
        tier_tokens: dict[int, int] = {}
        schedule_conflicts: list = []
        shadow_probes = 0
        pending_kl: Optional[float] = None
        last_latency = float("nan")
        last_emitted = 0
        step_i = 0
        decode_steps = 0
        decoded_tokens = 0
        switches = []
        prefill_s = 0.0
        decode_s = 0.0
        step_passes: list = []  # autopilot: passes (tiers) of each decode step
        step_host_ms: list = []  # and its host time
        # per-iteration wall time including any admission or prefill work,
        # for iterations that emitted decode tokens: the inter-token latency
        # an active request sees (a chunked prefill bounds its stall)
        decode_iter_lat: collections.deque = collections.deque(maxlen=HISTORY_LIMIT)
        t0 = time.perf_counter()

        def keep_live_tiers():
            live = set(sched.active_slots)
            for s_ in [s for s in slot_tier if s not in live]:
                del slot_tier[s_]

        def committed(job, done_now):
            if ap is not None:
                request_tiers[job.req.rid] = self._tiers[job.tier_index]
                if not done_now:
                    slot_tier[job.slot] = job.tier_index

        while not sched.done or job is not None:
            t_iter = time.perf_counter()
            pre_expire = set(sched.active_slots) if self.paged else set()
            sched.expire(step_i)
            if self.paged:
                for s_ in pre_expire - set(sched.active_slots):
                    pager.release(s_)
                    clears.append(s_)
            keep_live_tiers()
            if not sched.servable:
                for rid in sched.pending_rids:
                    sched.drop_pending(rid, "unservable: every decode slot is quarantined")
                continue
            if injector is not None:
                injector.apply(step_i, self.q_params, cache)  # in place
            if check and self.audit_interval:
                # at-rest audits against the baselines of the last iteration:
                # the parameter fingerprint and the KV checksums
                audit = step_i % self.audit_interval == 0
                integ["audits"] += int(audit)
                integ["kv_checks"] += 1
                fp = fold.tree_fold(self.q_params) if audit else None
                moved = self._kv_moved(cache, kv_ref)
                if not scrub:
                    if audit:
                        pending.append(("audit", step_i, fp))
                    pending.append(("kv", step_i, moved.sum()))
                else:
                    # scrub acts before admission and the step: one read-back
                    parts = ([fp.reshape(1)] if audit else []) + [moved.to(torch.int64)]
                    vals = torch.cat(parts).cpu().tolist()
                    found = [int(self._audit_params(int(vals[0])))] if audit else []
                    found += [int(v) for v in vals[int(audit):]]
                    if self.tp is not None:
                        # a drift on any rank's shard or KV heads is one on
                        # every rank: the ranks scrub and requeue together
                        found = self.tp.reduce_max_host(found, self.device)
                    if audit and found[0]:
                        integ["audit_alarms"] += 1
                        if injector is not None:
                            injector.mark_detected("params", step_i)
                        self._scrub()
                    bad = [i for i, v in enumerate(found[int(audit):]) if v]
                    if bad:
                        job = self._contain(bad, sched, pager, registry, allocator, job,
                                            clears, page_faults, slot_faults, step_i, integ)
                        keep_live_tiers()
                        if injector is not None:
                            injector.mark_detected("kv", step_i)
            decision = None
            if ap is not None:
                if self.tp is not None:
                    # the controller reads the wall clock: rank 0's reading
                    # decides on every rank (its other inputs are the same
                    # on every rank), so the ranks switch and shed together
                    last_latency = self.tp.broadcast_host([last_latency], self.device)[0]
                decision = ap.observe(
                    step_i, sched.queue_depth(step_i), scrubs=self._scrubs - scrubs0,
                    step_latency_s=last_latency, tokens_emitted=last_emitted,
                    shadow_kl=pending_kl,
                )
                pending_kl = None
                if decision.switched:
                    switches.append((decode_steps, ap.tier))
            due = [s for s in schedule if s <= decode_steps]
            for s in sorted(due):
                prec = schedule.pop(s)
                if ap is None:
                    self.set_precision(prec)
                    switches.append((decode_steps, self._precision))
                elif decision is not None and decision.switched:
                    # a race on this decode step: the controller wins, the
                    # entry is consumed
                    schedule_conflicts.append((decode_steps, s, prec))
                elif ap.force(step_i, _norm_precision(prec)).switched:
                    switches.append((decode_steps, ap.tier))
            if ap is not None and ap.shedding:
                waiting = sched.waiting(step_i)
                if waiting:
                    est = max(1, round(sum(r.max_new_tokens for r in waiting) / len(waiting)))
                    for rid in ap.shed_victims(waiting, step_i, service_estimate=est):
                        sched.shed(rid, f"overload: shed from queue tail at step {step_i} "
                                        f"(autopilot, tier w{ap.tier[1]})")
            tp = time.perf_counter()
            # flush deferred clears BEFORE admission: pages released since
            # the last flush may be reallocated and committed into below,
            # and the releasing slot's table must point at the null page
            # before that happens
            for s_ in clears:
                cache = paging.clear_slot(cache, s_)
            clears.clear()
            if (job is not None and job.req.deadline_step is not None
                    and step_i >= job.req.deadline_step):
                # the job's scratch goes with it; its pages are released
                self._settle(job, integ)
                if self.paged:
                    pager.release(job.slot)
                    clears.append(job.slot)
                sched.unreserve(job.slot)
                sched.fail(job.req.rid, f"deadline: staged prefill expired at step {step_i}")
                job = None
            if job is None:
                for slot, req in sched.admissible(step_i, capacity=capacity):
                    # the tier is a per-request contract fixed at admission
                    tier_index = ap.tier_index if ap is not None else 0
                    job = self._open_job(slot, req, sched, pager, registry,
                                         admission_precision())
                    job.tier_index = tier_index
                    shared_hits += int(job.from_hit)
                    if self.prefill_chunk > 0:
                        # chunked: ONE job in flight, one chunk per engine
                        # iteration, so decode keeps its cadence
                        break
                    # whole prompt: run to completion now
                    done = False
                    while not done:
                        done = self._job_step(job, integ)
                        prefill_chunks += 1
                    cache = self._job_commit(job, cache, tokens, sched, pager, registry, integ)
                    committed(job, slot not in sched.active_slots)
                    job = None
            if job is not None:
                if self._job_step(job, integ):
                    cache = self._job_commit(job, cache, tokens, sched, pager, registry, integ)
                    committed(job, job.slot not in sched.active_slots)
                    job = None
                prefill_chunks += 1
            prefill_s += time.perf_counter() - tp
            if sched.active_slots:
                td = time.perf_counter()
                active = sched.active_slots
                shadow = None
                with record_function("serve.decode_step"):
                    self._set_temperatures(sched.temperatures())
                    if ap is None:
                        passes, pass_of = [self._precision], np.zeros(self.n_slots, np.int64)
                    else:
                        present = sorted({slot_tier.get(s, 0) for s in active})
                        passes = [self._tier_precision(t) for t in present]
                        # free slots ride the first pass (their lanes are
                        # never read)
                        pass_of = np.zeros(self.n_slots, np.int64)
                        for s in active:
                            pass_of[s] = present.index(slot_tier.get(s, 0))
                        frac = ap.policy.shadow_frac
                        if (frac > 0.0 and ap.tier_index > 0
                                and int(decode_steps * frac) > int((decode_steps - 1) * frac)):
                            shadow = ap.tier_index
                        if len(passes) > 1 or shadow is not None:
                            self._set_masks(pass_of, len(passes), active, pager)
                    toks_np, kl = self._decode_checked(step_i, passes, pass_of, pending, integ,
                                                       injector, shadow)
                if shadow is not None:
                    pending_kl = kl
                    shadow_probes += 1
                for slot in active:
                    if ap is not None:
                        ti = slot_tier.get(slot, 0)
                        tier_tokens[ti] = tier_tokens.get(ti, 0) + 1
                    evicted = sched.record(slot, int(toks_np[slot]))
                    decoded_tokens += 1
                    if evicted and self.paged:
                        # free the pages now (host side); the device-side
                        # null-page clear flushes before the next admission
                        pager.release(slot)
                        clears.append(slot)
                last_latency = time.perf_counter() - td
                last_emitted = len(active)
                decode_s += last_latency
                if ap is not None:
                    step_passes.append(len(passes))
                    step_host_ms.append(1e3 * last_latency)
                sched.observe_step(step_i, last_latency)
                decode_iter_lat.append(time.perf_counter() - t_iter)
                decode_steps += 1
                step_i += 1
            else:
                # nothing in flight: fast-forward to the next arrival (not
                # while a staged prefill progresses: its deadline counts steps)
                sched.observe_step(step_i)
                last_latency = float("nan")
                last_emitted = 0
                nxt = sched.next_arrival()
                if job is not None:
                    step_i += 1
                else:
                    step_i = step_i + 1 if nxt is None else max(nxt, step_i + 1)
            if check and self.audit_interval:
                kv_ref = self._kv_folds(cache)
        if pending:
            self._tally_folds(pending, torch.stack([v.reshape(()) for *_, v in pending]).cpu(),
                              integ, injector)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = max(time.perf_counter() - t0, 1e-9)
        s = sched.stats()
        waits = np.asarray(s.queue_waits, np.float64)
        p99_wait = float(np.percentile(waits, 99)) if waits.size else 0.0
        calls = plan_mod.DEFAULT_REGISTRY.calls - calls0
        stats = {
            "wall_s": wall,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_steps": decode_steps,
            "decoded_tokens": decoded_tokens,
            "prefill_tokens": int(sum(r.tokens.size for r in requests)),
            "tok_per_s": (decoded_tokens + s.admitted) / wall,
            "kv_cache_bytes": kv_bytes,
            "slot_utilization": decoded_tokens / max(decode_steps * self.n_slots, 1),
            "admitted": s.admitted,
            "peak_occupancy": s.peak_occupancy,
            "queue_steps": s.queue_steps,
            "p99_queue_steps": p99_wait,
            "decode_iter_p99_ms": (
                float(np.percentile(np.asarray(decode_iter_lat), 99)) * 1e3
                if decode_iter_lat else 0.0
            ),
            "precision_switches": switches,
            "failed": dict(sched.failed),
            "requeued": s.requeued,
            "quarantined_slots": sorted(sched.quarantined_slots),
            "route_calls": dict(calls),
            "device": str(self.device),
            # the plan layer: registry hits and misses, the autotuner's store
            # hits, misses and tunes (zeros untuned)
            "plans": self.plan_stats(),
            # warm-up and capture host seconds of the graphs this run captured
            "capture_s": {str(p): t for p, t in self.capture_s.items() if p not in capture0},
        }
        stats["prefill_chunks"] = prefill_chunks
        if self.paged:
            stats["paging"] = {
                "page_size": self.page_size,
                "kv_pages": self._kv_pages,
                "pages_per_slot": self._pages_per_slot,
                "page_nbytes": page_nbytes,
                "peak_used_pages": allocator.peak_used,
                # bytes of pages ever live at once; dense serving holds
                # n_slots * pages_per_slot pages whatever the prompts
                "kv_bytes_resident_peak": allocator.peak_used * page_nbytes,
                "shared_prefix_hits": shared_hits,
                "prefix_entries": len(registry) if registry is not None else 0,
                "prefix_evictions": registry.evictions if registry is not None else 0,
                "quarantined_pages": allocator.quarantined_pages,
            }
        if check:
            stats["integrity"] = dict(integ, mode=self.integrity,
                                      scrubs=self._scrubs - scrubs0)
        if ap is not None:
            stats["autopilot"] = {
                "tiers": [list(t) for t in self._tiers],
                "final_tier": list(ap.tier),
                "switches": list(ap.switches),
                "shed": s.shed,
                "request_tiers": {rid: f"w{w}a{a}" for rid, (a, w) in request_tiers.items()},
                "tier_tokens": {
                    f"w{self._tiers[ti][1]}a{self._tiers[ti][0]}": n
                    for ti, n in sorted(tier_tokens.items())
                },
                "shadow_probes": shadow_probes,
                "shadow_kl_ewma": ap.shadow_kl_ewma,
                "latency_ewma_ms": ap.latency_ewma_ms,
                "p99_queue_steps": p99_wait,
                "schedule_conflicts": schedule_conflicts,
                "depth_history": list(s.depth_history),
                # decode steps that ran more than one tier's pass; each
                # decode step's passes and host ms (its decode range)
                "mixed_steps": sum(n > 1 for n in step_passes),
                "step_passes": step_passes,
                "step_host_ms": step_host_ms,
            }
        self._last_stats = stats
        return sched.finished, stats

    def _decode_checked(self, step_i: int, passes: list, pass_of, pending: list, integ: dict,
                        injector, shadow=None):
        """One decode step — a pass per precision in ``passes`` (a
        mixed-tier step when more than one), then the shadow probe at tier
        ``shadow`` — and its one read-back (the tokens, each pass's alarm
        flags, detect's pending at-rest results, the probe's KL). Returns
        (tokens as numpy, the KL or None).

        Each pass after the first starts from the pre-step state (restored
        from the backup the first pass wrote); each but the last leaves the
        rows of its slots in the merge buffer, and they are put back after
        the last. In scrub mode each pass reads its alarms back, and an
        alarmed pass puts the pre-step state back, scrubs and replays with
        the same seed, at most ``max_retries`` times; then
        :class:`~repro_torch.core.integrity.IntegrityError`."""
        n, last = self.n_slots, len(passes) - 1
        written = {"cache": self._cache, "tokens": self._tokens}
        outs = []
        for p, prec in enumerate(passes):
            if p:
                self._restore_state()
            if self.integrity == "scrub":
                outs.append(self._scrubbed_pass(step_i, prec, integ, injector))
            else:
                outs.append(self._decode(step_i, prec))
            if p < last:
                self._merge_rows(self._merge, written, p)
        if last:
            self._merge_rows(written, self._merge, -2)
        if self.integrity == "scrub":
            # every pass's tokens were read back with its alarms
            toks_np = np.stack([o for o in outs])[pass_of, np.arange(n)]
            if shadow is None:
                return toks_np, None
            return toks_np, _f32_of_bits(self._shadow_bits(step_i, shadow).cpu()[0])
        parts = [outs[0][0] if not last else self._tokens[:, 0].to(torch.int64)]
        if last:
            parts += [out[n:] for out, _ in outs]
        parts += [v.reshape(1) for *_, v in pending]
        if shadow is not None:
            parts.append(self._shadow_bits(step_i, shadow))
        vals = torch.cat(parts).cpu()
        toks_np = vals[:n].numpy()
        kl = _f32_of_bits(vals[-1]) if shadow is not None else None
        if self.integrity == "off":
            return toks_np, kl
        at = n
        for (out, keys), prec in zip(outs, passes):
            n_flags = out.numel() - n
            if self._harvest(self._steps_for(prec)[3], vals[at:at + n_flags], integ, keys):
                if injector is not None:
                    injector.mark_detected("params", step_i)
            at += n_flags
        self._tally_folds(pending, vals[at:at + len(pending)], integ, injector)
        return toks_np, kl

    def _scrubbed_pass(self, step_i: int, precision, integ: dict, injector) -> np.ndarray:
        """One decode pass under scrub: its tokens and alarms read back at
        once; an alarm puts the pre-step state back, scrubs and replays the
        same pass with the same seed. Returns the pass's tokens."""
        n = self.n_slots
        col = self._steps_for(precision)[3]
        for attempt in range(self.max_retries + 1):
            out, keys = self._decode(step_i, precision)
            vals = out.cpu()
            if not self._harvest(col, vals[n:], integ, keys):
                return vals[:n].numpy()
            if injector is not None:
                injector.mark_detected("params", step_i)
            if attempt < self.max_retries:
                # re-run from the pre-step state with scrubbed weights and
                # the same seed: a bit-identical retry
                self._restore_state()
                self._scrub()
                integ["step_retries"] += 1
        raise integrity.IntegrityError(
            f"decode ABFT alarm at step {step_i} persisted through "
            f"{self.max_retries} scrub-and-retry attempts"
        )

    def _contain(self, bad: list, sched, pager, registry, allocator, job, clears: list,
                 page_faults: dict, slot_faults: dict, step_i: int, integ: dict):
        """Scrub-mode containment of the KV checksums that moved (``bad``:
        indices into :meth:`_kv_moved`'s vector). Dense: the slots' requests
        are requeued. Paged: each bad page (never the null page) counts a
        page fault, its registry entries are dropped, its holders are
        requeued and it is quarantined after ``quarantine_after`` faults; a
        staged job that maps a bad shared page is aborted and resubmitted (a
        bad page it owns is overwritten whole by its commit). Returns the
        job still in flight."""
        integ["kv_alarms"] += len(bad)
        if not self.paged:
            self._contain_kv(sched, bad, slot_faults, step_i, integ)
            return job
        n_pages = self._kv_pages - 1
        bad_pages = [i + 1 for i in bad if i < n_pages]
        affected = {i - n_pages for i in bad if i >= n_pages}
        before = set(sched.active_slots)
        for pid in bad_pages:
            integ["page_faults"] += 1
            page_faults[pid] = page_faults.get(pid, 0) + 1
            if registry is not None:
                registry.drop_page(pid)
            affected.update(pager.slots_holding(pid))
            if page_faults[pid] >= self.quarantine_after:
                allocator.quarantine(pid)
                integ["pages_quarantined"] += 1
        if job is not None and job.slot in affected:
            affected.discard(job.slot)
            shared_held = set(pager.pages(job.slot)) - set(pager.owned_pages(job.slot))
            if shared_held & set(bad_pages):
                jslot = job.slot
                slot_faults[jslot] = slot_faults.get(jslot, 0) + 1
                backoff = 1 << min(slot_faults[jslot], 4)
                pager.release(jslot)
                clears.append(jslot)
                sched.unreserve(jslot)
                rid = sched.resubmit(job.req, step_i + backoff)
                integ["requeued"] += 1
                if sched.retries(rid) > self.max_retries:
                    sched.drop_pending(
                        rid, f"retry budget exhausted: {sched.retries(rid)} KV faults "
                        f"on request {rid}")
                job = None
        self._contain_kv(sched, sorted(affected), slot_faults, step_i, integ)
        for s_ in before - set(sched.active_slots):
            pager.release(s_)
            clears.append(s_)
        return job


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="bit-serial quantized serving (continuous batching by default; "
        "PyTorch/CUDA)"
    )
    ap.add_argument("--arch", choices=ARCH_NAMES, default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--bits", type=int, default=8,
                    help="storage precision: weights are quantized and "
                    "decomposed at this width, 1..16 (0 disables quantization; "
                    "beyond 8 bits the float32-accumulated plain route serves)")
    ap.add_argument("--level", default="digit", choices=("bitplane", "digit"))
    ap.add_argument("--variant", default="booth", choices=("booth", "sbmwc"))
    ap.add_argument("--mode", default="cb", choices=("cb", "lockstep"),
                    help="serving mode: continuous batching (default) or the "
                    "lockstep fixed-batch baseline engine")
    ap.add_argument("--batch", type=int, default=4,
                    help="lockstep batch size / default slot count")
    ap.add_argument("--n-slots", type=int, default=None,
                    help="continuous-batching decode slots (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="lockstep prompt length")
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated mixed prompt lengths for the "
                    "continuous-batching workload, e.g. 8,32,128")
    ap.add_argument("--stagger", type=int, default=2,
                    help="decode steps between request arrivals")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--precision", type=int, default=None,
                    help="runtime execution precision (<= --bits) by plane-prefix "
                    "truncation (requires --level bitplane)")
    ap.add_argument("--precision-switch", default=None, metavar="STEP:BITS",
                    help="at decode step STEP drop to BITS (continuous batching "
                    "only), e.g. 8:4")
    ap.add_argument("--sparsity", default="off", choices=("off", "gate", "compact"),
                    help="occupancy-gated sparse plane execution: 'gate' skips "
                    "all-zero plane work in the kernels; 'compact' also drops "
                    "all-zero weight planes from the serving cache at load. Both "
                    "are bit-identical to 'off' (requires --level bitplane)")
    ap.add_argument("--integrity", default="off", choices=("off", "detect", "scrub"),
                    help="fault-tolerant serving: 'detect' "
                    "runs ABFT row-sum checks on every bit-serial matmul "
                    "plus at-rest fingerprint audits and counts alarms; "
                    "'scrub' additionally recovers — rebuild the weight "
                    "planes from retained source params and retry the "
                    "step (bit-identical tokens), requeue/quarantine on "
                    "KV faults (requires --level bitplane)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="SEU injection harness: comma-separated "
                    "site@step[xN] shots with optional ';seed=N', e.g. "
                    "'planes@2,kv@5x2;seed=7'; sites: planes, sign, "
                    "occupancy, checksum, scale, kv, kv_scale "
                    "(continuous batching only)")
    ap.add_argument("--autopilot", action="store_true",
                    help="closed-loop SLA autopilot: watch queue depth, per-token "
                    "decode latency and the shadow quality probe, and move the "
                    "admission precision tier down/up the 8-6-4 ladder with "
                    "hysteresis; past the lowest tier, shed the queue tail. "
                    "In-flight requests keep their admission tier (mixed-tier "
                    "decode). Continuous batching only; needs --level bitplane")
    ap.add_argument("--sla-ms", type=float, default=None,
                    help="autopilot wall-clock SLA: per-emitted-token decode "
                    "latency EWMA above this is pressure (degrade), below "
                    "half of it is headroom (upgrade)")
    ap.add_argument("--sla-queue-steps", type=int, default=None,
                    help="autopilot queue SLA: per-request queue-wait budget "
                    "in engine steps — the deterministic signal the shedding "
                    "ladder evicts against (predicted wait > budget)")
    ap.add_argument("--shadow-frac", type=float, default=0.0,
                    help="fraction of decode steps shadow-scored for quality "
                    "while degraded: an extra logits pass at the stored "
                    "width and the current tier, KL between them fed to the "
                    "controller (0 disables the probe)")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="P",
                    help="tensor-parallel serving over P ranks, one process each "
                    "(NCCL on cuda:0..P-1; gloo with --device cpu): plane caches "
                    "shard column-parallel (q/k/v/gate/up), row-parallel (o/down) "
                    "and vocab-parallel (lm_head), the KV cache by head; tokens "
                    "are bit-identical to P=1. Needs P CUDA devices on the card, "
                    "--bits in [1,8], head counts divisible by P; --mode cb only")
    ap.add_argument("--audit-interval", type=int, default=1,
                    help="integrity: run the at-rest parameter fingerprint "
                    "audit every N engine iterations (0 disables at-rest "
                    "audits, leaving per-matmul ABFT only)")
    ap.add_argument("--kv-page-size", type=int, default=0, metavar="POS",
                    help="paged KV cache: store KV in fixed-size pages of POS "
                    "positions with per-slot block tables instead of dense "
                    "per-slot extents; admission checks free-page capacity "
                    "(0 = dense; --mode cb only, needs int8 KV)")
    ap.add_argument("--kv-pages", type=int, default=None, metavar="N",
                    help="physical page-pool size (default: enough for "
                    "every slot's full extent plus the null page); smaller "
                    "pools admit by free-page capacity")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="TOKENS",
                    help="chunked prefill: stage each admission's prefill "
                    "in TOKENS-sized chunks interleaved with decode steps "
                    "(0 = monolithic; --mode cb only)")
    ap.add_argument("--share-prefixes", action="store_true",
                    help="copy-on-write shared-prefix reuse: requests "
                    "declaring a byte-identical prompt prefix map the same "
                    "physical KV pages read-only and resume prefill from "
                    "the registered snapshot (needs --kv-page-size)")
    ap.add_argument("--shared-prefix-len", type=int, default=0, metavar="N",
                    help="synthetic workload: give every request the same "
                    "first N prompt tokens and declare them shared")
    ap.add_argument("--autotune", action="store_true",
                    help="tile autotuning: prune each plan's launch geometry "
                    "(row tile bm, K split) with the calibrated analytic model, "
                    "time <= 4 survivors on the route's kernel, and serve every "
                    "plan at its winner (bit-identical tokens; tiles change the "
                    "launch geometry, never the arithmetic)")
    ap.add_argument("--plan-store", default=None, metavar="PATH",
                    help="persist winning tile configurations at PATH keyed "
                    "(host fingerprint, plan key): a warm store restarts "
                    "the process at peak with zero tuning runs — "
                    "tune-once-per-fleet (needs --autotune)")
    ap.add_argument("--deadline", type=int, default=None, metavar="STEPS",
                    help="per-request deadline: fail any request not "
                    "finished within STEPS engine iterations of its "
                    "arrival (frees its slot; continuous batching only)")
    ap.add_argument("--no-plane-cache", action="store_true",
                    help="skip the load-time weight-plane decomposition cache")
    ap.add_argument("--no-fused", action="store_true",
                    help="stage the linear (separate plane kernel + epilogue) "
                    "instead of the fused kernel")
    ap.add_argument("--no-kv-quant", action="store_true",
                    help="keep the KV cache in bf16 (the bit-exact fallback; int8 "
                    "quantize-on-append is the default)")
    ap.add_argument("--no-cb", action="store_true",
                    help="alias for --mode lockstep (deprecated)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain "
                    "versions on the host)")
    return ap


def validate_args(args) -> None:
    """Fail fast on inconsistent flag combinations, with the reference's
    messages."""

    def die(msg):
        raise SystemExit(f"[serve] invalid flags: {msg}")

    if args.no_cb:
        args.mode = "lockstep"
    if args.bits and not 1 <= args.bits <= 16:
        die("--bits must be in [1, 16] (the paper's synthesis-time maximum; "
            "0 disables quantization)")
    if args.bits and get_config(args.arch).family == "moe":
        die(f"--bits {args.bits} on {args.arch}: the CLI's uniform policy quantizes the "
            "MoE router, which the layer reads dense (reference defect G); serve it "
            "with --bits 0, or bit-serially through the Python API with "
            "PrecisionPolicy.uniform(..., keep_dense=('frontend', 'router'))")
    if args.mode == "lockstep" and args.prompt_lens:
        die("--prompt-lens (mixed prompt lengths) needs --mode cb; the "
            "lockstep engine serves one fixed shape")
    if args.mode == "lockstep" and args.precision_switch:
        die("--precision-switch is a continuous-batching feature (--mode cb)")
    if not args.bits:
        for flag, val in (("--no-fused", args.no_fused),
                          ("--no-plane-cache", args.no_plane_cache),
                          ("--precision", args.precision is not None),
                          ("--precision-switch", args.precision_switch),
                          ("--sparsity", args.sparsity != "off"),
                          ("--integrity", args.integrity != "off")):
            if val:
                die(f"{flag} needs an active quantization policy (--bits > 0)")
    if args.integrity != "off":
        if args.level != "bitplane":
            die("--integrity needs --level bitplane: the ABFT column "
                "checksums ride in the packed bit-plane cache")
        if args.no_plane_cache:
            die("--integrity needs the weight-plane cache (drop "
                "--no-plane-cache): checksums are computed at decompose "
                "time and scrub rebuilds the cached decomposition")
    if args.inject_faults:
        if args.mode == "lockstep":
            die("--inject-faults drives the continuous-batching engine "
                "(--mode cb)")
        try:
            args.inject_faults = FaultSpec.parse(args.inject_faults)
        except ValueError as e:
            die(f"--inject-faults: {e}")
    if args.autopilot:
        if args.mode == "lockstep":
            die("--autopilot drives the continuous-batching engine "
                "(--mode cb): the lockstep engine has no queue to watch")
        if not args.bits:
            die("--autopilot needs an active quantization policy "
                "(--bits > 0): the tier ladder truncates the stored "
                "decomposition")
        if args.level != "bitplane":
            die("--autopilot needs --level bitplane (the precision ladder "
                "is served by plane-prefix truncation)")
        if args.no_plane_cache:
            die("--autopilot needs the weight-plane cache (drop "
                "--no-plane-cache): tier switches truncate the stored "
                "decomposition instead of re-quantizing")
    for flag, val in (("--sla-ms", args.sla_ms is not None),
                      ("--sla-queue-steps", args.sla_queue_steps is not None),
                      ("--shadow-frac", args.shadow_frac != 0.0)):
        if val and not args.autopilot:
            die(f"{flag} is an autopilot knob: add --autopilot")
    if args.sla_ms is not None and args.sla_ms <= 0:
        die("--sla-ms must be > 0")
    if args.sla_queue_steps is not None and args.sla_queue_steps < 1:
        die("--sla-queue-steps must be >= 1")
    if not 0.0 <= args.shadow_frac <= 1.0:
        die("--shadow-frac must be in [0, 1]")
    if args.model_parallel < 1:
        die("--model-parallel must be >= 1")
    if args.model_parallel > 1:
        if args.mode == "lockstep":
            die("--model-parallel drives the continuous-batching engine "
                "(--mode cb)")
        if not args.bits:
            die("--model-parallel needs an active quantization policy "
                "(--bits > 0): TP shards the quantized serving tree")
        if args.bits > MAX_TP_BITS:
            die("--model-parallel needs --bits <= 8: the row-parallel "
                "partial sums must accumulate exactly in int32")
        on_card = args.device is None or torch.device(args.device).type == "cuda"
        if on_card and torch.cuda.device_count() < args.model_parallel:
            die(f"--model-parallel {args.model_parallel} needs that many "
                f"CUDA devices; this host exposes {torch.cuda.device_count()} "
                "(--device cpu runs the ranks on the host)")
    if args.deadline is not None:
        if args.mode == "lockstep":
            die("--deadline is a continuous-batching feature (--mode cb): "
                "the lockstep engine has no scheduler to evict from")
        if args.deadline < 1:
            die("--deadline must be >= 1 engine step")
    if args.kv_page_size < 0:
        die("--kv-page-size must be >= 0 (0 = dense KV)")
    if args.prefill_chunk < 0:
        die("--prefill-chunk must be >= 0 (0 = monolithic prefill)")
    if args.kv_page_size:
        if args.mode == "lockstep":
            die("--kv-page-size drives the continuous-batching engine "
                "(--mode cb): the lockstep engine has no slots to page")
        if args.no_kv_quant:
            die("--kv-page-size needs int8 KV (drop --no-kv-quant): pages "
                "hold int8 values plus their scale vectors")
    if args.kv_pages is not None:
        if not args.kv_page_size:
            die("--kv-pages needs --kv-page-size (paged KV)")
        if args.kv_pages < 2:
            die("--kv-pages must be >= 2 (page 0 is the reserved null page)")
    if args.prefill_chunk and args.mode == "lockstep":
        die("--prefill-chunk is a continuous-batching feature (--mode cb)")
    if args.share_prefixes and not args.kv_page_size:
        die("--share-prefixes needs --kv-page-size: physical pages are "
            "the sharing unit")
    # the reference's two defects on recurrent and windowed models, refused
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    lens = ([int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens
            else [args.prompt_len])
    chunk = args.prefill_chunk
    try:
        for s in lens:  # each prompt as the engine prefills it: its second chunk at ``chunk``
            check_prefill(cfg, s, chunk if 0 < chunk < s else 0,
                          min(cfg.local_window, max(lens) + args.gen))
    except ValueError as e:
        die(str(e))
    if args.shared_prefix_len < 0:
        die("--shared-prefix-len must be >= 0")
    if args.plan_store and not args.autotune:
        die("--plan-store needs --autotune: the store is only read and "
            "written by the attached tuner")
    if args.audit_interval < 0:
        die("--audit-interval must be >= 0")
    if args.sparsity != "off" and args.level != "bitplane":
        die("--sparsity needs --level bitplane: occupancy bitmaps and plane "
            "compaction exist for the packed bit-plane kernels only "
            "(radix-256 digit planes carry no pack-time occupancy)")
    if args.sparsity == "compact" and args.no_plane_cache:
        die("--sparsity compact needs the weight-plane cache (drop "
            "--no-plane-cache): compaction drops zero planes from the "
            "load-time decomposition")
    if args.level == "digit" and args.variant == "sbmwc":
        die("--level digit --variant sbmwc has no kernel (SBMwC radix-256 "
            "digits exceed int8); use --variant booth or --level bitplane")
    wants_precision = args.precision is not None or args.precision_switch
    if wants_precision:
        if args.level != "bitplane":
            die("--precision/--precision-switch need --level bitplane "
                "(digit-plane caches are not prefix-truncatable)")
        if args.no_plane_cache:
            die("--precision/--precision-switch need the weight-plane cache "
                "(drop --no-plane-cache): runtime reconfiguration truncates "
                "the stored decomposition instead of re-quantizing")
    if args.precision is not None and not 1 <= args.precision <= args.bits:
        die(f"--precision {args.precision} must be in [1, {args.bits}] — the "
            "dial truncates the stored decomposition, never extends it")
    if args.precision_switch:
        try:
            step_s, bits_s = args.precision_switch.split(":")
            args.precision_switch = (int(step_s), int(bits_s))
        except ValueError:
            die("--precision-switch expects STEP:BITS, e.g. 8:4")
        if not 1 <= args.precision_switch[1] <= args.bits:
            die(f"--precision-switch bits {args.precision_switch[1]} must be "
                f"in [1, {args.bits}] (the storage width)")
        if args.precision_switch[0] < 0:
            die("--precision-switch step must be >= 0")


def _print_plan_stats(engine) -> None:
    ps = engine.plan_stats()
    line = (
        f"[serve] plans: {ps['resolved']} resolved "
        f"(registry {ps['registry_hits']} hits / {ps['registry_misses']} "
        f"misses), store {ps['store_hits']} hits / {ps['store_misses']} "
        f"misses, {ps['tunes']} tuned"
    )
    if "fingerprint" in ps:
        line += f", host {ps['fingerprint']}"
    print(line)


def main(argv=None):
    args = build_parser().parse_args(argv)
    validate_args(args)
    if args.model_parallel > 1:
        # one process per rank (launch/mesh.py); rank 0's lines are printed
        from repro_torch.launch.mesh import spawn_ranks

        on_host = args.device is not None and torch.device(args.device).type == "cpu"
        print(spawn_ranks(_serve_rank, args.model_parallel, device="cpu" if on_host else "cuda",
                       args=(args,)), end="")
        return
    _serve(args, resolve_device(args.device))


def _host_peak_rss_gib() -> float:
    """This process's peak resident set on the host (Linux reports KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _serve_rank(backend, device, args) -> str:
    """One rank of a tensor-parallel :func:`main`: rank 0's printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _serve(args, device)
    return buf.getvalue() if torch.distributed.get_rank() == 0 else ""


def _serve(args, device) -> None:
    """Serve the CLI's workload on ``device`` (on every rank, under
    ``--model-parallel``) and print the results."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if not cfg.is_decoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    policy = (
        PrecisionPolicy.uniform(
            args.bits, args.bits, variant=args.variant, level=args.level,
            fuse_epilogue=False if args.no_fused else None,
            sparsity=args.sparsity, integrity=args.integrity,
        )
        if args.bits
        else PrecisionPolicy.off()
    )
    # a tensor-parallel rank draws the weights one part at a time and keeps
    # only its shard of each (sharding.tp.load_shard): the whole dense tree
    # is never held
    seeded = SeededParams(0)
    params = (seeded if args.model_parallel > 1
              else init_params(cfg, seeded.generator(device), device=device))
    rng = np.random.default_rng(0)
    run_bits = args.precision or args.bits
    tag = (f"{cfg.name} ({cfg.n_layers} layers) w{run_bits}a{run_bits} "
           f"{args.level}/{args.variant}")
    if args.precision:
        tag += f" (stored w{args.bits}, truncated)"
    if args.sparsity != "off":
        tag += f" sparsity={args.sparsity}"
    if args.integrity != "off":
        tag += f" integrity={args.integrity}"
    tag += f" on {device}"

    if args.mode == "lockstep":
        engine = Engine(
            cfg, params, policy, max_len=args.prompt_len + args.gen,
            plane_cache=not args.no_plane_cache,
            sample_fn=sampling.make_sample_fn(args.temperature),
            audit_interval=args.audit_interval, autotune=args.autotune,
            plan_store_path=args.plan_store, device=device,
        )
        if args.precision:
            engine.set_precision(args.precision)
        prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
        tokens, tps = engine.generate(prompts, args.gen)
        if args.autotune:
            _print_plan_stats(engine)
        print(f"[serve] {tag} lockstep: generated {tuple(tokens.shape)} at {tps:.1f} tok/s")
        if args.integrity != "off":
            print(f"[serve] integrity={args.integrity}: {engine.last_alarms} alarms")
        print("[serve] first row:", tokens[0].cpu().numpy())
        return

    lens = (
        [int(x) for x in args.prompt_lens.split(",")]
        if args.prompt_lens
        else [args.prompt_len]
    )
    if args.shared_prefix_len and args.shared_prefix_len >= min(lens):
        raise SystemExit(
            f"[serve] invalid flags: --shared-prefix-len {args.shared_prefix_len} "
            f"must be shorter than every prompt length (min {min(lens)})"
        )
    n_slots = args.n_slots or args.batch
    max_len = max(lens) + args.gen
    if args.kv_page_size:
        # round up to a whole number of pages (paged_init_cache requires it)
        max_len = -(-max_len // args.kv_page_size) * args.kv_page_size
    ap_policy = (
        AutopilotPolicy(sla_ms=args.sla_ms, sla_queue_steps=args.sla_queue_steps,
                        shadow_frac=args.shadow_frac)
        if args.autopilot
        else None
    )
    engine = ContinuousBatchingEngine(
        cfg, params, policy, n_slots=n_slots, max_len=max_len,
        kv_quant=not args.no_kv_quant, plane_cache=not args.no_plane_cache,
        device=device, audit_interval=args.audit_interval, autopilot=ap_policy,
        page_size=args.kv_page_size, kv_pages=args.kv_pages,
        prefill_chunk=args.prefill_chunk, share_prefixes=args.share_prefixes,
        autotune=args.autotune, plan_store_path=args.plan_store,
        model_parallel=args.model_parallel,
    )
    if args.autotune:
        tag += " autotuned"
    if args.model_parallel > 1:
        tag += f" tp={args.model_parallel}"
    if args.kv_page_size:
        tag += f" paged/{args.kv_page_size}"
    if args.precision:
        engine.set_precision(args.precision)
    prefix = (
        rng.integers(0, cfg.vocab_size, (args.shared_prefix_len,))
        if args.shared_prefix_len else None
    )

    def _prompt(s):
        if prefix is None:
            return rng.integers(0, cfg.vocab_size, (s,))
        return np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (s - prefix.size,))])

    requests = [
        Request(
            rid=i, tokens=_prompt(s), max_new_tokens=args.gen,
            temperature=args.temperature, arrival_step=i * args.stagger,
            deadline_step=i * args.stagger + args.deadline if args.deadline else None,
            shared_prefix_len=args.shared_prefix_len,
        )
        for i, s in enumerate(lens)
    ]
    schedule = (
        {args.precision_switch[0]: args.precision_switch[1]}
        if args.precision_switch
        else None
    )
    injector = FaultInjector(args.inject_faults) if args.inject_faults else None
    results, stats = engine.run(requests, precision_schedule=schedule, injector=injector)
    kv = "bf16" if args.no_kv_quant else "int8"
    print(
        f"[serve] {tag} cb/{kv}: {len(results)} requests, "
        f"{stats['decoded_tokens'] + stats['admitted']} tokens at "
        f"{stats['tok_per_s']:.1f} tok/s, slot util {stats['slot_utilization']:.2f}, "
        f"kv cache {stats['kv_cache_bytes'] / 1024:.1f} KiB"
    )
    print(f"[serve] routes: {stats['route_calls']}")
    if "paging" in stats:
        pg = stats["paging"]
        print(
            f"[serve] paging: {pg['kv_pages']} pages x {pg['page_size']} pos, "
            f"peak {pg['peak_used_pages']} pages resident "
            f"({pg['kv_bytes_resident_peak'] / 1024:.1f} KiB), "
            f"{pg['shared_prefix_hits']} shared-prefix hits, "
            f"{stats['prefill_chunks']} prefill chunks"
        )
    for step_i, prec in stats["precision_switches"]:
        print(f"[serve] precision switch at decode step {step_i}: -> {prec}")
    if "autopilot" in stats:
        apst = stats["autopilot"]
        print(
            f"[serve] autopilot: final tier {tuple(apst['final_tier'])}, "
            f"{len(apst['switches'])} switches, {apst['shed']} shed, "
            f"p99 queue wait {apst['p99_queue_steps']:.1f} steps, "
            f"tier tokens {apst['tier_tokens']}"
        )
        for sw_step, sw_tier, sw_reason in apst["switches"]:
            print(f"[serve]   step {sw_step}: -> {tuple(sw_tier)} ({sw_reason})")
        if apst["shadow_probes"]:
            print(
                f"[serve]   shadow probes {apst['shadow_probes']}, "
                f"KL ewma {apst['shadow_kl_ewma']:.5f}"
            )
    if "integrity" in stats:
        ig = stats["integrity"]
        print(
            f"[serve] integrity={ig['mode']}: {ig['abft_checks']} ABFT checks "
            f"({ig['abft_alarms']} alarms), {ig['audits']} audits "
            f"({ig['audit_alarms']} alarms), {ig['kv_checks']} KV checks "
            f"({ig['kv_alarms']} alarms), {ig['scrubs']} scrubs, "
            f"{ig['step_retries']} step retries"
        )
    if args.autotune:
        _print_plan_stats(engine)
    if injector is not None:
        undet = injector.undetected
        print(
            f"[serve] injected {len(injector.events)} faults, "
            f"{len(injector.events) - len(undet)} detected"
        )
        for e in undet:
            print(f"[serve]   UNDETECTED: {e.site}@{e.step} at {e.leaf}")
    for rid, reason in sorted(stats["failed"].items()):
        print(f"[serve] rid {rid} FAILED: {reason}")
    if device.type == "cuda":  # each rank's card and host process
        mine = (torch.cuda.max_memory_allocated(device) / 2**30,
                torch.cuda.memory_allocated(device) / 2**30, _host_peak_rss_gib())
        every = [mine]
        if args.model_parallel > 1:
            every = [None] * args.model_parallel
            torch.distributed.all_gather_object(every, mine)
        for name, i in (("card memory peak", 0), ("card memory resident", 1),
                        ("host peak RSS", 2)):
            print(f"[serve] {name} GiB per rank: {[round(m[i], 3) for m in every]}")
    for rid in sorted(results):
        print(f"[serve] rid {rid}:", results[rid])


if __name__ == "__main__":
    main()
