"""Serving driver: quantized weights + the continuous-batching engine.

Weights live in memory at their configured bit-width with a
decompose-once plane cache (:func:`~repro_torch.models.quant.quantize_params`),
activations are quantized per token, every projection runs through the
bit-serial matmul at the policy's level/variant — on CUDA the fused
Hopper kernel at ``--level bitplane`` and the plane-pair kernel at
``--level digit`` — and the KV cache is int8 (quantize-on-append).

:class:`ContinuousBatchingEngine` admits requests with different prompt
lengths and arrival steps into free decode slots mid-flight (a
per-request prefill inserted into its slot while the other slots keep
decoding), runs one decode pass over the whole slot array per step, and
evicts each request the step it finishes. :meth:`set_precision` dials
the steps to a lower width against the same weight tree (plane-prefix
truncation); ``run(precision_schedule={step: bits})`` automates it.

With ``policy.integrity == "detect"`` the engine layers three detectors
and counts their alarms in ``stats()["integrity"]``: the per-matmul ABFT
row-sum check of every projection (alarm vectors read back once per step,
with the tokens), an at-rest fingerprint of the whole quantized weight
tree audited every ``audit_interval`` iterations against the load-time
one, and per-slot KV checksums compared with their post-step baselines.
Detection only: scrub-and-retry recovery is not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --reduced --bits 8 --level bitplane --prompt-lens 8,32,64 --gen 16 \
        --precision-switch 8:4

Runs on CUDA unless ``--device cpu`` (or ``device="cpu"``) is given; with
no GPU and no explicit CPU request it raises.
"""

from __future__ import annotations

import argparse
import collections
import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.core import integrity
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import sampling
from repro_torch.launch.steps import make_cb_decode_step, make_prefill_step
from repro_torch.models.cache import (
    cache_kv_bytes,
    cache_slot_checksums,
    init_cache,
    insert_slot,
)
from repro_torch.models.quant import quantize_params
from repro_torch.models.transformer import init_params
from repro_torch.runtime.scheduler import Request, SlotScheduler


SCRUB_NOT_PORTED = (
    "integrity='scrub' (scrub-and-retry recovery) is not ported yet: see "
    "ROADMAP.md, open item 8 'Fault tolerance' (scrub half, next slice); "
    "use integrity='detect'"
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


def _seeded(seed: int, stream: int, n: int, device) -> torch.Generator:
    """A generator for one sampling event: ``stream`` 0 is first-token
    sampling (``n`` = request id), 1 is decode (``n`` = engine step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream * 7_919 + n) % (2**63))
    return gen


class ContinuousBatchingEngine:
    """Slot-scheduled serving over a shared, optionally int8, KV cache.

    ``n_slots`` decode lanes share one slot cache of ``max_len`` positions
    per slot. :meth:`run` drives a :class:`SlotScheduler`: each iteration
    admits pending requests into free slots (per-request prefill at the
    prompt's own length + :func:`insert_slot`), then runs one decode pass
    over the whole slot array; each prefill and decode step is a
    ``torch.profiler`` range (``serve.prefill``, ``serve.decode_step``),
    free when no profiler runs. ``backend`` picks the matmul kernels:
    ``"auto"`` (the Hopper kernels on CUDA) or ``"torch"`` (the plain
    versions, on any device). ``audit_interval``: with integrity on, the
    at-rest parameter audit runs every N iterations (0 disables it and
    the KV checks, leaving the per-matmul ABFT checks).
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
    ):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode path")
        self.integrity = integrity.check_integrity_mode(policy.integrity)
        if self.integrity == "scrub":
            raise NotImplementedError(SCRUB_NOT_PORTED)
        if audit_interval < 0:
            raise ValueError(f"audit_interval must be >= 0, got {audit_interval}")
        self.audit_interval = audit_interval
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.plane_cache = plane_cache
        self.seed = seed
        self.backend = backend
        params = _to_device(params, self.device)
        self.q_params = (
            quantize_params(
                params, policy, plane_cache=plane_cache, scan_layers=cfg.scan_layers
            )
            if policy.default.active
            else params
        )
        # the load-time fingerprint the at-rest audits compare against
        self._params_ref = (
            int(integrity.tree_checksum(self.q_params)) if self.integrity != "off" else None
        )
        self._precision: Optional[Tuple[int, int]] = None
        self._compiled: dict = {}
        self._last_stats: dict = {}
        self._bind_steps(self._steps_for(None))

    # -- runtime precision dial ---------------------------------------------

    def _make_steps(self, precision):
        check = self.integrity != "off"
        pcol = integrity.Collector() if check else None
        scol = integrity.Collector() if check else None
        return (
            make_prefill_step(
                self.cfg, self.policy, max_len=self.max_len, kv_quant=self.kv_quant,
                precision=precision, backend=self.backend, collector=pcol,
            ),
            make_cb_decode_step(
                self.cfg, self.policy, precision=precision, backend=self.backend,
                collector=scol,
            ),
            pcol,
            scol,
        )

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

    # -- integrity (detect) -------------------------------------------------

    def _audit_params(self) -> bool:
        """True if the at-rest parameter fingerprint drifted from the
        reference; the reference is then re-baselined, so one upset alarms
        once, not at every audit."""
        fp = int(integrity.tree_checksum(self.q_params))
        if fp == self._params_ref:
            return False
        self._params_ref = fp
        return True

    @staticmethod
    def _harvest(col, alarms, integ: dict) -> None:
        """Tally one step's read-back alarm vector: every flag is a check,
        a step with any flag set is one alarm."""
        res = col.harvest(alarms)
        integ["abft_checks"] += len(res)
        if any(bad for _, bad in res):
            integ["abft_alarms"] += 1

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

    def run(self, requests: list[Request], precision_schedule: Optional[dict] = None):
        """Serve ``requests`` to completion. Returns (results, stats):
        ``results`` maps rid -> generated int32 tokens.

        ``precision_schedule``: optional ``{decode_step: precision}`` over
        the decode-step counter; at each threshold the engine calls
        :meth:`set_precision` before that step. Switches are recorded in
        ``stats['precision_switches']`` as (decode_step, (a, w))."""
        schedule = dict(precision_schedule or {})
        sched = SlotScheduler(self.n_slots, max_extent=self.max_len)
        for r in sorted(requests, key=lambda r: r.arrival_step):
            sched.submit(r)
        cache = init_cache(
            self.cfg, self.n_slots, self.max_len, self.cfg.dtype,
            kv_quant=self.kv_quant, device=self.device,
        )
        tokens = torch.zeros((self.n_slots, 1), dtype=torch.int32, device=self.device)
        kv_bytes = cache_kv_bytes(cache)
        check = self.integrity != "off"
        kv_ref = cache_slot_checksums(cache).cpu() if check else None
        integ = {
            "audits": 0, "audit_alarms": 0,
            "abft_checks": 0, "abft_alarms": 0,
            "kv_checks": 0, "kv_alarms": 0,
        }
        calls0 = collections.Counter(plan_mod.DEFAULT_REGISTRY.calls)
        step_i = 0
        decode_steps = 0
        decoded_tokens = 0
        switches = []
        prefill_s = 0.0
        decode_s = 0.0
        t0 = time.perf_counter()
        while not sched.done:
            if check and self.audit_interval:
                # at-rest audits against the baselines of the last iteration:
                # the parameter fingerprint and the per-slot KV checksums
                if step_i % self.audit_interval == 0:
                    integ["audits"] += 1
                    if self._audit_params():
                        integ["audit_alarms"] += 1
                sums = cache_slot_checksums(cache).cpu()
                integ["kv_checks"] += 1
                n_bad = int((sums != kv_ref).sum())
                if n_bad:
                    integ["kv_alarms"] += n_bad
                    kv_ref = sums
            due = [s for s in schedule if s <= decode_steps]
            for s in sorted(due):
                self.set_precision(schedule.pop(s))
                switches.append((decode_steps, self._precision))
            for slot, req in sched.admissible(step_i):
                tp = time.perf_counter()
                with record_function("serve.prefill"):
                    prompt = torch.as_tensor(req.tokens, device=self.device)[None, :]
                    if check:
                        logits, seq_cache, alarms = self._prefill(self.q_params, prompt)
                        # one read-back: the first token, then the alarm vector
                        vals = torch.cat([
                            self._first_token(logits, req).reshape(1).to(torch.int64),
                            alarms.to(torch.int64),
                        ]).cpu()
                        tok = int(vals[0])
                        self._harvest(self._prefill_col, vals[1:], integ)
                    else:
                        logits, seq_cache = self._prefill(self.q_params, prompt)
                        tok = int(self._first_token(logits, req))
                    cache = insert_slot(cache, seq_cache, slot)
                tokens[slot, 0] = tok
                sched.start(slot, req, tok)
                prefill_s += time.perf_counter() - tp
            if sched.active_slots:
                td = time.perf_counter()
                active = sched.active_slots
                with record_function("serve.decode_step"):
                    gen = _seeded(self.seed, 1, step_i, self.device)
                    temps = torch.as_tensor(sched.temperatures(), device=self.device)
                    if check:
                        tokens, cache, alarms = self._step(
                            self.q_params, cache, tokens, temps, gen
                        )
                        vals = torch.cat(
                            [tokens[:, 0].to(torch.int64), alarms.to(torch.int64)]
                        ).cpu()
                        toks_np = vals[: self.n_slots].numpy()
                        self._harvest(self._step_col, vals[self.n_slots:], integ)
                    else:
                        tokens, cache = self._step(self.q_params, cache, tokens, temps, gen)
                        toks_np = tokens[:, 0].cpu().numpy()
                for slot in active:
                    sched.record(slot, int(toks_np[slot]))
                    decoded_tokens += 1
                decode_s += time.perf_counter() - td
                sched.observe_step(step_i)
                decode_steps += 1
                step_i += 1
            else:
                # nothing in flight: fast-forward to the next arrival
                sched.observe_step(step_i)
                nxt = sched.next_arrival()
                step_i = step_i + 1 if nxt is None else max(nxt, step_i + 1)
            if check and self.audit_interval:
                kv_ref = cache_slot_checksums(cache).cpu()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = max(time.perf_counter() - t0, 1e-9)
        s = sched.stats()
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
            "precision_switches": switches,
            "failed": dict(sched.failed),
            "route_calls": dict(calls),
            "device": str(self.device),
        }
        if check:
            stats["integrity"] = dict(integ, mode=self.integrity)
        self._last_stats = stats
        return sched.finished, stats


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="bit-serial quantized serving with continuous batching (PyTorch/CUDA)"
    )
    ap.add_argument("--arch", choices=ARCH_NAMES, default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--bits", type=int, default=8,
                    help="storage precision: weights are quantized and "
                    "decomposed at this width (0 disables quantization)")
    ap.add_argument("--level", default="digit", choices=("bitplane", "digit"))
    ap.add_argument("--variant", default="booth", choices=("booth", "sbmwc"))
    ap.add_argument("--n-slots", type=int, default=4, help="decode slots")
    ap.add_argument("--prompt-lens", default="32",
                    help="comma-separated prompt lengths, e.g. 8,32,128")
    ap.add_argument("--stagger", type=int, default=2,
                    help="decode steps between request arrivals")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--precision", type=int, default=None,
                    help="runtime execution precision (<= --bits) by plane-prefix "
                    "truncation (requires --level bitplane)")
    ap.add_argument("--precision-switch", default=None, metavar="STEP:BITS",
                    help="at decode step STEP drop to BITS, e.g. 8:4")
    ap.add_argument("--no-fused", action="store_true",
                    help="stage the linear (separate plane kernel + epilogue) "
                    "instead of the fused kernel")
    ap.add_argument("--integrity", default="off", choices=("off", "detect", "scrub"),
                    help="'detect' runs the ABFT row-sum check on every "
                    "bit-serial matmul plus at-rest fingerprint audits and "
                    "per-slot KV checksums, and counts alarms (requires "
                    "--level bitplane); 'scrub' is not ported yet")
    ap.add_argument("--audit-interval", type=int, default=1,
                    help="integrity: run the at-rest parameter fingerprint "
                    "audit every N engine iterations (0 disables at-rest "
                    "audits, leaving per-matmul ABFT only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain "
                    "versions on the host)")
    return ap


def validate_args(args) -> None:
    def die(msg):
        raise SystemExit(f"[serve] invalid flags: {msg}")

    if args.bits and not 1 <= args.bits <= 8:
        die("--bits must be in [1, 8] (wider widths are not ported yet; 0 "
            "disables quantization)")
    if not args.bits:
        for flag, val in (("--no-fused", args.no_fused),
                          ("--precision", args.precision is not None),
                          ("--precision-switch", args.precision_switch),
                          ("--integrity", args.integrity != "off")):
            if val:
                die(f"{flag} needs an active quantization policy (--bits > 0)")
    if args.integrity == "scrub":
        die(f"--integrity scrub: {SCRUB_NOT_PORTED}")
    if args.integrity != "off" and args.level != "bitplane":
        die("--integrity needs --level bitplane: the ABFT column "
            "checksums ride in the packed bit-plane cache")
    if args.audit_interval < 0:
        die("--audit-interval must be >= 0")
    if args.level == "digit" and args.variant == "sbmwc":
        die("--level digit --variant sbmwc has no kernel (SBMwC radix-256 "
            "digits exceed int8); use --variant booth or --level bitplane")
    if (args.precision is not None or args.precision_switch) and args.level != "bitplane":
        die("--precision/--precision-switch need --level bitplane "
            "(digit-plane caches are not prefix-truncatable)")
    if args.precision is not None and not 1 <= args.precision <= args.bits:
        die(f"--precision {args.precision} must be in [1, {args.bits}]")
    if args.precision_switch:
        try:
            step_s, bits_s = args.precision_switch.split(":")
            args.precision_switch = (int(step_s), int(bits_s))
        except ValueError:
            die("--precision-switch expects STEP:BITS, e.g. 8:4")
        if not 1 <= args.precision_switch[1] <= args.bits:
            die(f"--precision-switch bits must be in [1, {args.bits}]")
        if args.precision_switch[0] < 0:
            die("--precision-switch step must be >= 0")


def main(argv=None):
    args = build_parser().parse_args(argv)
    validate_args(args)
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    policy = (
        PrecisionPolicy.uniform(
            args.bits, args.bits, variant=args.variant, level=args.level,
            fuse_epilogue=False if args.no_fused else None,
            integrity=args.integrity,
        )
        if args.bits
        else PrecisionPolicy.off()
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=device)
    lens = [int(x) for x in args.prompt_lens.split(",")]
    engine = ContinuousBatchingEngine(
        cfg, params, policy, n_slots=args.n_slots, max_len=max(lens) + args.gen,
        device=device, audit_interval=args.audit_interval,
    )
    if args.precision:
        engine.set_precision(args.precision)
    rng = np.random.default_rng(0)
    requests = [
        Request(
            rid=i, tokens=rng.integers(0, cfg.vocab_size, (s,)),
            max_new_tokens=args.gen, arrival_step=i * args.stagger,
        )
        for i, s in enumerate(lens)
    ]
    schedule = (
        {args.precision_switch[0]: args.precision_switch[1]}
        if args.precision_switch
        else None
    )
    results, stats = engine.run(requests, precision_schedule=schedule)
    run_bits = args.precision or args.bits
    print(
        f"[serve] {cfg.name} ({cfg.n_layers} layers) w{run_bits}a{run_bits} "
        f"{args.level}/{args.variant} on {device}: {len(results)} requests, "
        f"{stats['decoded_tokens'] + stats['admitted']} tokens at "
        f"{stats['tok_per_s']:.1f} tok/s, slot util {stats['slot_utilization']:.2f}, "
        f"kv cache {stats['kv_cache_bytes'] / 1024:.1f} KiB"
    )
    print(f"[serve] routes: {stats['route_calls']}")
    if "integrity" in stats:
        ig = stats["integrity"]
        print(
            f"[serve] integrity={ig['mode']}: {ig['abft_checks']} ABFT checks "
            f"({ig['abft_alarms']} alarms), {ig['audits']} audits "
            f"({ig['audit_alarms']} alarms), {ig['kv_checks']} KV checks "
            f"({ig['kv_alarms']} alarms)"
        )
    for step_i, prec in stats["precision_switches"]:
        print(f"[serve] precision switch at decode step {step_i}: -> {prec}")
    for rid in sorted(results):
        print(f"[serve] rid {rid}:", results[rid])


if __name__ == "__main__":
    main()
