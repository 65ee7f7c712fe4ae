"""GPU smoke run of the PyTorch/CUDA port's main path (needs one CUDA card).

    python3 chip_smoke.py

Phases, each failing the run on any error:

1. build — compile every CUDA kernel of the path from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel) into build/repro_torch/;
2. kernel checks — each kernel against its plain PyTorch version on the
   card at the main path's shapes (granite-3-8b gate / down / lm_head at
   decode M=4 and prefill M=256): raw int32 bit-equal, the bf16 epilogue
   bit-equal, one truncated (4-bit) tier bit-equal; the packed kernel also
   on the blocked 8x8 Booth cache, SBMwC in the global planar layout, and
   gated against dense on a weight whose top planes are zero; plus timings
   (CUDA events, median of repeated launches) beside the bound and a
   library yardstick (``torch._int_mm``, never used by the port);
3. engine at --level bitplane — continuous batching over full-width
   granite-3-8b (depth cut to 4 layers), 8-bit Booth plane cache, 4 slots,
   prompts 32/64/128/256 arriving 2 steps apart, 16 new tokens, int8 KV,
   an 8 -> 4 bit switch at decode step 8; every projection must launch the
   fused kernel, and the greedy tokens must equal a run with every
   projection on the plain version (which must launch no kernel); two more
   timed runs give the spread of the host times, and one run under
   ``torch.profiler`` the device time in all and inside the engine's
   prefill and decode-step ranges;
4. engine at --level digit — the same through the plane-pair kernel
   (digit caches are not truncatable, so no precision switch);
5. engine bitplane-nofused — the bitplane workload with the fused kernel
   off (``--no-fused``): every projection must launch the packed kernel
   and the fused kernel never, and the tokens must equal the plain path's
   and the fused engine's; one warm-up, one timed and one profiled run;
6. engine bitplane-detect — the same with ``integrity="detect"`` and an
   audit every iteration, layers unrolled so that every projection's ABFT
   check counts on its own: a clean run has no alarm and one check per
   projection call, and its tokens equal bitplane-nofused's; then one bit
   of one packed weight word is flipped on the card and a second run must
   raise at least one ABFT alarm and one audit alarm. It prints what
   detection adds to the wall time and the decode step time. Then the
   same again on the default scanned layer stack (bitplane-detect-scan),
   which folds the stack's checks into one per forward: a clean run counts
   two checks per forward (the stack and lm_head) and no alarm, and the
   flipped bit again raises both alarms.

Prints one JSON line per kernel check, one ``{"kernels": [...]}`` summary
line, the card's name and power limit, and last ``{"ok": true, ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1.979e15

GRANITE_SHAPES = (  # (name, K, N, activation) of the main path's projections
    ("gate", 4096, 12800, "silu"),
    ("down", 12800, 4096, "none"),
    ("lm_head", 4096, 49408, "none"),
)
ROWS = (4, 256)  # decode M = n_slots, prefill M = longest prompt

# the engine workload: full-width granite-3-8b, depth cut to LAYERS
LAYERS = 4
N_SLOTS = 4
PROMPT_LENS = (32, 64, 128, 256)
STAGGER = 2  # decode steps between arrivals
GEN_TOKENS = 16


def _die(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-launch CUDA-event times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_ms(x_q: torch.Tensor, w_q: torch.Tensor):
    """``torch._int_mm`` of the same int8 product (rows padded to 32, the
    smallest M it takes) — a yardstick; None with the reason if refused."""
    m = x_q.shape[0]
    xp = torch.zeros((max(m, 32), x_q.shape[1]), dtype=torch.int8, device=x_q.device)
    xp[:m] = x_q
    for w in (w_q, w_q.t().contiguous().t()):
        try:
            torch._int_mm(xp, w)
        except RuntimeError as e:  # layout the library does not take
            reason = str(e).splitlines()[0]
            continue
        return _time_ms(lambda w=w: torch._int_mm(xp, w)), None
    return None, reason


def _packed_bound(m, n, pa, pw, gate_tiles=None) -> tuple[float, str]:
    """Bound of one packed product: A and W words read once, the int32
    output written once; P_w folded int8 products per (m, n, k). With
    ``gate_tiles`` (the weight's (P_w, chunks) tile occupancy) only the
    occupied (plane, chunk) tiles are counted: that is what these data
    need."""
    from repro_torch.kernels.plane_mm_packed import CHUNK_WORDS

    sides_a = 1 if pa.sign is None else 2
    sides_w = 1 if pw.sign is None else 2
    n_w, kw, _ = pw.mag.shape
    w_words = n_w * kw if gate_tiles is None else int(gate_tiles.sum()) * CHUNK_WORDS
    n_bytes = 4 * (sides_a * pa.mag.numel() + sides_w * w_words * n + m * n)
    return _bound(n_bytes, 2.0 * m * n * 32 * w_words)


def check_packed(summary: dict, name, m, k, n, x_q, w_q, wp, wp4, x4, lib_ms) -> list:
    """The packed kernel against its plain version: the blocked 8x8 Booth
    cache (cached_packed), the 4-bit truncated tier, SBMwC in the global
    planar layout (staged_packed), and gate=True against gate=False on a
    weight whose top Booth planes are zero — all bit-equal (int32)."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.core.bitserial import _wrap_weights
    from repro_torch.kernels import plane_mm_packed as pmp

    dev = x_q.device

    def pack_a(x, bits, variant, block):
        dec = bp.to_bitplanes(x, bits, variant)
        return bp.pack_planes(dec.planes, axis=-1, ternary=variant == "booth", block=block), dec

    def pair_w(dec_a, pw_side):
        return _wrap_weights([a * b for a in dec_a.weights for b in pw_side.weights], device=dev)

    sb = bp.make_weight_planes(w_q, w_bits=8, variant="sbmwc", level="bitplane", block=None)
    small = bp.make_weight_planes(w_q >> 3, w_bits=8, variant="booth", level="bitplane")
    cases = []
    pa8, da8 = pack_a(x_q, 8, "booth", wp.packed.block)
    cases.append(("booth8_blocked", pa8, wp.packed, pair_w(da8, wp.packed), False))
    pa4, da4 = pack_a(x4, 4, "booth", wp4.packed.block)
    cases.append(("booth4_truncated", pa4, wp4.packed, pair_w(da4, wp4.packed), False))
    pas, das = pack_a(x_q, 8, "sbmwc", None)
    cases.append(("sbmwc8_planar", pas, sb.packed, pair_w(das, sb.packed), False))
    cases.append(("booth8_gated", pa8, small.packed, pair_w(da8, small.packed), True))
    lines = []
    for variant, pa, pw, pairs, gate in cases:
        got = pmp.plane_matmul_packed(pa, pw, pairs, gate=gate)
        plain = pmp.plane_matmul_packed_plain(pa, pw, pairs)
        dense = pmp.plane_matmul_packed(pa, pw, pairs) if gate else got
        torch.cuda.synchronize()
        eq = bool(torch.equal(got, plain)) and bool(torch.equal(dense, got))
        err = float((got.double() - plain.double()).abs().max())
        k_ms = _time_ms(lambda: pmp.plane_matmul_packed(pa, pw, pairs, gate=gate))
        p_ms = _time_ms(lambda: pmp.plane_matmul_packed_plain(pa, pw, pairs), reps=3, warmup=1)
        tiles = bp.occupancy_per_tile(pw.occupancy, pmp.CHUNK_WORDS) if gate else None
        b_ms, b_by = _packed_bound(m, n, pa, pw, tiles)
        line = {
            "kernel": "plane_matmul_packed", "shape": name, "M": m, "K": k, "N": n,
            "variant": variant, "gate": gate, "planes": [pa.n_planes, pw.n_planes],
            "raw_int32_equal": eq, "max_abs_err": err,
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        if gate:
            line["dense_ms"] = _time_ms(lambda: pmp.plane_matmul_packed(pa, pw, pairs))
            line["occupied_tiles"] = [int(tiles.sum()), int(tiles.numel())]
        print(json.dumps(line), flush=True)
        lines.append(line)
        if not eq:
            _die(f"plane_matmul_packed {variant} differs from its plain version at {name} M={m}")
        summary.setdefault("plane_matmul_packed", []).append(line)
        del got, plain, dense
    return lines


def check_kernels(summary: dict) -> list:
    from repro_torch.core import bitplanes as bp
    from repro_torch.core.bitserial import _wrap_weights
    from repro_torch.kernels import plane_mm, plane_mm_fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    lines = []
    for name, k, n, act in GRANITE_SHAPES:
        w_q = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        wp = bp.make_weight_planes(w_q, w_bits=8, variant="booth", level="bitplane")
        wp4 = bp.truncate_weight_planes(wp, 4)
        w_dig = bp.to_digits(w_q, 8, "booth")
        w_scale = torch.rand((1, n), generator=gen, device=dev) * 1e-3 + 1e-4
        bias = (
            torch.randn((n,), generator=gen, device=dev) * 0.1 if name == "down" else None
        )
        for m in ROWS:
            x_q = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            a_scale = torch.rand((m, 1), generator=gen, device=dev) * 1e-2 + 1e-3
            # ---- fused_plane_linear ------------------------------------------------
            pw8 = _wrap_weights([a * b for a in bp.plane_weights(8, "booth") for b in wp.weights], device=dev)
            pw4 = _wrap_weights([a * b for a in bp.plane_weights(4, "booth") for b in wp4.weights], device=dev)
            x4 = torch.clamp_max(bp.shift_requantize(x_q, 8, 4, "booth"), 7).to(torch.int8)
            kw = dict(a_bits=8, variant="booth")
            raw_k = plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw)
            raw_p = plane_mm_fused.fused_plane_linear_plain(x_q, wp.packed, pw8, **kw)
            ep = dict(a_scale=a_scale, w_scale=w_scale, bias=bias, activation=act)
            out_k = plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw, **ep)
            out_p = plane_mm_fused.fused_plane_linear_plain(x_q, wp.packed, pw8, **kw, **ep)
            tr_k = plane_mm_fused.fused_plane_linear(x4, wp4.packed, pw4, a_bits=4, variant="booth", **ep)
            tr_p = plane_mm_fused.fused_plane_linear_plain(x4, wp4.packed, pw4, a_bits=4, variant="booth", **ep)
            torch.cuda.synchronize()
            raw_eq = bool(torch.equal(raw_k, raw_p))
            ep_err = float((out_k.float() - out_p.float()).abs().max())
            tr_err = float((tr_k.float() - tr_p.float()).abs().max())
            ep_eq = bool(torch.equal(out_k, out_p)) and bool(torch.equal(tr_k, tr_p))
            k_ms = _time_ms(lambda: plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw, **ep))
            p_ms = _time_ms(lambda: plane_mm_fused.fused_plane_linear_plain(x_q, wp.packed, pw8, **kw, **ep), reps=3, warmup=1)
            lib_ms, lib_why = _library_ms(x_q, w_q)
            n_w, kwords, _ = wp.packed.mag.shape
            n_bytes = (m * k + 2 * n_w * kwords * n * 4 + 4 * pw8.numel()
                       + 4 * m + 4 * n + m * n * 2)
            if bias is not None:
                n_bytes += 4 * n
            # the activation side folds into one operand per weight plane,
            # u_j = sum_i pw[i, j] * a_i, so the function needs P_w products
            b_ms, b_by = _bound(n_bytes, 2.0 * m * n * k * n_w)
            line = {
                "kernel": "fused_plane_linear", "shape": name, "M": m, "K": k, "N": n,
                "activation": act, "bias": bias is not None,
                "raw_int32_equal": raw_eq, "bf16_epilogue_equal": ep_eq,
                "epilogue_max_abs_err": ep_err, "trunc4_max_abs_err": tr_err,
                "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if lib_why:
                line["library_note"] = lib_why
            print(json.dumps(line), flush=True)
            lines.append(line)
            if not raw_eq:
                _die(f"fused_plane_linear raw int32 differs from its plain version at {name} M={m}")
            if not ep_eq:
                _die(
                    f"fused_plane_linear bf16 epilogue differs from its plain version at "
                    f"{name} M={m} (max abs err {max(ep_err, tr_err)})"
                )
            summary.setdefault("fused_plane_linear", []).append(line)
            # ---- plane_matmul (Booth radix-256 digits; a truncated bit-plane tier) ---
            a_dig = bp.to_digits(x_q, 8, "booth")
            pwd = _wrap_weights([a * b for a in a_dig.weights for b in w_dig.weights], device=dev)
            a_pl, w_pl = a_dig.planes.contiguous(), w_dig.planes.contiguous()
            dk = plane_mm.plane_matmul(a_pl, w_pl, pwd)
            dp = plane_mm.plane_matmul_plain(a_pl, w_pl, pwd)
            a_b4 = bp.to_bitplanes(x4, 4, "booth").planes.contiguous()
            w_b4 = bp.unpack_planes(wp4.packed).contiguous()
            tk = plane_mm.plane_matmul(a_b4, w_b4, pw4)
            tp = plane_mm.plane_matmul_plain(a_b4, w_b4, pw4)
            torch.cuda.synchronize()
            d_eq = bool(torch.equal(dk, dp))
            t_eq = bool(torch.equal(tk, tp))
            # the digit contraction is the plain int8 product (float64 is exact here)
            exact = bool(torch.equal(dp.double(), x_q.double() @ w_q.double()))
            d_err = float(max((dk - dp).abs().max(), (tk - tp).abs().max()))
            k_ms = _time_ms(lambda: plane_mm.plane_matmul(a_pl, w_pl, pwd))
            p_ms = _time_ms(lambda: plane_mm.plane_matmul_plain(a_pl, w_pl, pwd), reps=3, warmup=1)
            p_a, p_w = a_pl.shape[0], w_pl.shape[0]
            n_bytes = p_a * m * k + p_w * k * n + 4 * p_a * p_w + 4 * m * n
            # folding the side with fewer planes leaves min(P_a, P_w) products
            b_ms, b_by = _bound(n_bytes, 2.0 * m * n * k * min(p_a, p_w))
            line = {
                "kernel": "plane_matmul", "shape": name, "M": m, "K": k, "N": n,
                "planes": [p_a, p_w], "raw_int32_equal": d_eq, "trunc4_bitplane_equal": t_eq,
                "equals_int_matmul": exact, "max_abs_err": d_err,
                "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
            if not (d_eq and t_eq and exact):
                _die(f"plane_matmul differs from its plain version at {name} M={m}")
            summary.setdefault("plane_matmul", []).append(line)
            del raw_k, raw_p, out_k, out_p, tr_k, tr_p, dk, dp, tk, tp, a_b4, w_b4
            lines += check_packed(summary, name, m, k, n, x_q, w_q, wp, wp4, x4, lib_ms)
        del wp, wp4, w_dig, w_q
        torch.cuda.empty_cache()
    return lines


def _profile(engine, reqs, schedule) -> dict:
    """Device side of one served run under ``torch.profiler``: the time
    and number of device events (kernels, copies, sets) in all, and the
    time of those that start inside the host spans of the engine's
    ``serve.prefill`` / ``serve.decode_step`` ranges. The profiler slows
    the host, so host times come from unprofiled runs."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        engine.run(reqs, precision_schedule=schedule)
        torch.cuda.synchronize()
    spans: dict[str, list] = {"serve.prefill": [], "serve.decode_step": []}
    device = []  # (name, start, us) of each device event
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name in spans:
                spans[evt.name].append((evt.time_range.start, evt.time_range.end))
        elif evt.name not in spans:  # not a range's own span on the device timeline
            device.append((evt.name, evt.time_range.start,
                           evt.time_range.end - evt.time_range.start))
    # each range ends by reading its result back to the host, so the device
    # work it launched starts inside its host span (one profiler clock)
    in_range = {name: sum(us for _, start, us in device
                          if any(lo <= start < hi for lo, hi in ranges))
                for name, ranges in spans.items()}
    busy_us = sum(us for _, _, us in device)
    plane_us = sum(us for name, _, us in device
                   if any(tag in name for tag in ("plane_linear", "plane_mm", "packed_mm",
                                                  "epilogue_kernel")))
    return {
        "device_events": len(device), "device_busy_s": busy_us / 1e6,
        "plane_kernels_s": plane_us / 1e6,
        "prefill_ranges": len(spans["serve.prefill"]),
        "prefill_device_s": in_range["serve.prefill"] / 1e6,
        "decode_ranges": len(spans["serve.decode_step"]),
        "decode_device_s": in_range["serve.decode_step"] / 1e6,
        "outside_ranges_s": (busy_us - sum(in_range.values())) / 1e6,
    }


def _counters() -> dict:
    from repro_torch.kernels import plane_mm, plane_mm_fused, plane_mm_packed

    return {
        "fused_plane_linear": plane_mm_fused.fused_plane_linear,
        "plane_matmul": plane_mm.plane_matmul,
        "plane_matmul_packed": plane_mm_packed.plane_matmul_packed,
    }


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _requests(cfg) -> list:
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (s,)) for s in PROMPT_LENS]
    return [
        Request(rid=i, tokens=p, max_new_tokens=GEN_TOKENS, arrival_step=STAGGER * i)
        for i, p in enumerate(prompts)
    ]


def _check_finished(name: str, cfg, results: dict, stats: dict) -> None:
    if stats["failed"] or sorted(results) != list(range(len(PROMPT_LENS))):
        _die(f"{name}: not every request finished: {stats['failed']}")
    for rid, toks in results.items():
        if toks.shape != (GEN_TOKENS,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            _die(f"{name}: request {rid} produced malformed tokens {toks}")


def _same_tokens(name: str, results: dict, other: dict, what: str) -> None:
    mismatch = [rid for rid in results if not np.array_equal(results[rid], other[rid])]
    if mismatch:
        _die(f"{name}: greedy tokens differ from {what} for requests {mismatch}")


def _engine(cfg, params, policy, **kw):
    from repro_torch.launch.serve import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        cfg, params, policy, n_slots=N_SLOTS, max_len=max(PROMPT_LENS) + GEN_TOKENS,
        device="cuda", **kw,
    )


def _counted_run(name, cfg, engine, schedule, kernel, route) -> tuple:
    """One warm-up, then the counted run: launch counts are set to 0 just
    before it and read just after; ``kernel`` must have launched once per
    ``route`` projection call and no other kernel at all."""
    engine.run(_requests(cfg)[:1], precision_schedule=None)  # allocator, library handles
    engine.set_precision(None)
    _reset_counts()
    results, stats = engine.run(_requests(cfg), precision_schedule=schedule)
    counts = _read_counts()
    _check_finished(name, cfg, results, stats)
    calls = stats["route_calls"].get(route, 0)
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if counts[kernel] == 0 or counts[kernel] != calls or others:
        _die(f"{name}: launches {counts} against {route} projection calls {calls}")
    return results, stats, counts


def _summary(name, cfg, results, stats, counts, kernel, runs, profile) -> dict:
    return {
        "engine": name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "requests": len(results), "tokens": stats["decoded_tokens"] + stats["admitted"],
        "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "decode_steps": stats["decode_steps"], "launches": counts[kernel], "all_launches": counts,
        "route_calls": stats["route_calls"], "precision_switches": stats["precision_switches"],
        "runs": [{k: s[k] for k in ("wall_s", "prefill_s", "decode_s", "tok_per_s")} for s in runs],
        "profile": profile,
        # device time (in all, and inside the ranges) over each run's host
        # time (wall, and of the same phase)
        "busy_share": [profile["device_busy_s"] / s["wall_s"] for s in runs],
        "decode_busy_share": [profile["decode_device_s"] / s["decode_s"] for s in runs],
        "prefill_busy_share": [profile["prefill_device_s"] / s["prefill_s"] for s in runs],
    }


def run_engine(level: str, cfg, params, kernel: str, route: str) -> tuple[dict, dict, dict]:
    """Serve the workload at ``level`` (the fused kernel at bitplane, the
    plane-pair kernel at digit) and on the plain path; returns the summary,
    the kernel path's tokens and the plain path's."""
    from repro_torch.core.precision import PrecisionPolicy

    schedule = {8: 4} if level == "bitplane" else None
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level=level)
    engine = _engine(cfg, params, policy)
    results, stats, counts = _counted_run(level, cfg, engine, schedule, kernel, route)
    # two more timed runs give the spread of the host-side times
    reruns = []
    for _ in range(2):
        engine.set_precision(None)
        reruns.append(engine.run(_requests(cfg), precision_schedule=schedule)[1])
    engine.set_precision(None)
    profile = _profile(engine, _requests(cfg), schedule)
    plain = _engine(cfg, params, policy, backend="torch")
    _reset_counts()
    res_plain, stats_plain = plain.run(_requests(cfg), precision_schedule=schedule)
    plain_counts = _read_counts()
    del engine, plain
    torch.cuda.empty_cache()

    if any(plain_counts.values()) or set(stats_plain["route_calls"]) != {"cached_scan"}:
        _die(f"{level}: the plain run launched kernels {plain_counts} or took routes "
             f"{stats_plain['route_calls']}")
    _same_tokens(level, results, res_plain, "the plain path")
    out = _summary(level, cfg, results, stats, counts, kernel, [stats] + reruns, profile)
    out.update(plain_tok_per_s=stats_plain["tok_per_s"],
               plain_route_calls=stats_plain["route_calls"], tokens_equal_plain=True)
    print(json.dumps(out), flush=True)
    return out, results, res_plain


def run_nofused(cfg, params, fused_results: dict, plain_results: dict) -> tuple[dict, dict]:
    """The bitplane workload with the fused kernel off: every projection
    through the packed kernel (route cached_packed), tokens equal to the
    plain path's and to the fused engine's."""
    from repro_torch.core.precision import PrecisionPolicy

    name, schedule = "bitplane-nofused", {8: 4}
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                     fuse_epilogue=False)
    engine = _engine(cfg, params, policy)
    results, stats, counts = _counted_run(
        name, cfg, engine, schedule, "plane_matmul_packed", "cached_packed")
    engine.set_precision(None)
    profile = _profile(engine, _requests(cfg), schedule)
    del engine
    torch.cuda.empty_cache()
    _same_tokens(name, results, plain_results, "the plain path")
    _same_tokens(name, results, fused_results, "the fused bitplane engine")
    out = _summary(name, cfg, results, stats, counts, "plane_matmul_packed", [stats], profile)
    out.update(tokens_equal_plain=True, tokens_equal_fused=True)
    print(json.dumps(out), flush=True)
    return out, results


def _flip_weight_bit(engine) -> None:
    """Flip one bit of one packed weight word, on the card."""
    mag = engine.q_params["layers"][0]["mlp"]["gate_proj"]["w_planes"].packed.mag
    mag[0, 0, 0] ^= 1 << 5


def _detect_pass(name, cfg, params, schedule, nofused_results, checks_of) -> tuple:
    """Serve the workload with detect-mode integrity and an audit every
    iteration: the clean run must raise no alarm, count ``checks_of(stats)``
    ABFT checks and give bitplane-nofused's tokens; then one weight bit is
    flipped on the card and a second run must raise at least one ABFT alarm
    and one audit alarm. Returns the engine and the clean run's results,
    stats and launch counts."""
    from repro_torch.core.precision import PrecisionPolicy

    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                     integrity="detect")
    engine = _engine(cfg, params, policy, audit_interval=1)
    results, stats, counts = _counted_run(
        name, cfg, engine, schedule, "plane_matmul_packed", "cached_packed")
    clean = stats["integrity"]
    if (clean["abft_alarms"], clean["audit_alarms"], clean["kv_alarms"]) != (0, 0, 0):
        _die(f"{name}: alarms on a clean run: {clean}")
    if clean["abft_checks"] != checks_of(stats) or not clean["audits"] or not clean["kv_checks"]:
        _die(f"{name}: {clean['abft_checks']} ABFT checks against {checks_of(stats)} expected, "
             f"{clean['audits']} audits, {clean['kv_checks']} KV checks")
    _same_tokens(name, results, nofused_results, "bitplane-nofused")
    return engine, results, stats, counts


def _flipped_pass(name, cfg, engine, schedule) -> dict:
    """Flip one weight bit of ``engine`` and serve again: at least one ABFT
    alarm and one audit alarm must follow. Returns the integrity counts."""
    _flip_weight_bit(engine)
    engine.set_precision(None)
    _, fstats = engine.run(_requests(cfg), precision_schedule=schedule)
    flipped = fstats["integrity"]
    if flipped["abft_alarms"] < 1 or flipped["audit_alarms"] < 1:
        _die(f"{name}: a flipped weight bit went undetected: {flipped}")
    return flipped


def run_detect(cfg, params, nofused: dict, nofused_results: dict) -> dict:
    """The nofused workload with ABFT checks, at-rest audits every
    iteration and per-slot KV checksums, twice: with the layers unrolled
    (``scan_layers=False``: names only, the arithmetic is the same), so
    that every projection's check counts on its own, and on the default
    scanned stack, which reports one folded check for the stack and one
    for lm_head per forward, as the reference's lax.scan does."""
    name, schedule = "bitplane-detect", {8: 4}
    unrolled = dataclasses.replace(cfg, scan_layers=False)
    engine, results, stats, counts = _detect_pass(
        name, unrolled, params, schedule, nofused_results,
        lambda st: st["route_calls"].get("cached_packed", 0))
    engine.set_precision(None)
    profile = _profile(engine, _requests(cfg), schedule)
    flipped = _flipped_pass(name, unrolled, engine, schedule)
    del engine
    torch.cuda.empty_cache()

    scan_name = "bitplane-detect-scan"
    engine, _, scan_stats, _ = _detect_pass(
        scan_name, cfg, params, schedule, nofused_results,
        lambda st: 2 * (st["admitted"] + st["decode_steps"]))
    scan_flipped = _flipped_pass(scan_name, cfg, engine, schedule)
    del engine
    torch.cuda.empty_cache()

    steps = stats["decode_steps"]
    out = _summary(name, unrolled, results, stats, counts, "plane_matmul_packed", [stats],
                   profile)
    out.update(
        integrity_clean=stats["integrity"], integrity_flipped=flipped,
        tokens_equal_nofused=True,
        scan_integrity_clean=scan_stats["integrity"], scan_integrity_flipped=scan_flipped,
        scan_tokens_equal_nofused=True, scan_wall_s=scan_stats["wall_s"],
        # what detection adds over the same workload without it
        overhead_wall_s=stats["wall_s"] - nofused["wall_s"],
        overhead_wall_ratio=stats["wall_s"] / nofused["wall_s"],
        overhead_decode_step_ms=1e3 * (stats["decode_s"] / steps
                                       - nofused["decode_s"] / nofused["decode_steps"]),
        overhead_decode_step_ratio=(stats["decode_s"] / steps)
        / (nofused["decode_s"] / nofused["decode_steps"]),
    )
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        _die("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build_s = _build.build_all()
    print(f"[chip_smoke] build: {build_s:.1f} s (sources {', '.join(_build.SOURCES)})", flush=True)

    summary: dict = {}
    check_kernels(summary)
    print(f"[chip_smoke] kernel checks done at {time.perf_counter() - t0:.1f} s", flush=True)

    full = get_config("granite-3-8b")
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    print(f"[chip_smoke] model: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}); depth cut {full.n_layers} -> {cfg.n_layers} layers", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    eng_bit, res_bit, res_plain = run_engine(
        "bitplane", cfg, params, "fused_plane_linear", "fused_cached")
    print(f"[chip_smoke] engine bitplane done at {time.perf_counter() - t0:.1f} s", flush=True)
    eng_dig, _, _ = run_engine("digit", cfg, params, "plane_matmul", "cached_planes")
    print(f"[chip_smoke] engine digit done at {time.perf_counter() - t0:.1f} s", flush=True)
    eng_nof, res_nof = run_nofused(cfg, params, res_bit, res_plain)
    print(f"[chip_smoke] engine bitplane-nofused done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    eng_det = run_detect(cfg, params, eng_nof, res_nof)
    print(f"[chip_smoke] engine bitplane-detect done at {time.perf_counter() - t0:.1f} s "
          f"(detect adds {eng_det['overhead_wall_s']:.3f} s wall, "
          f"{eng_det['overhead_decode_step_ms']:.2f} ms per decode step)", flush=True)

    def entry(name, source, replaces, lines, launches):
        rep = lines[0]  # decode gate projection, M=4: the most frequent main-path call
        errs = [max(l.get("epilogue_max_abs_err", 0.0), l.get("trunc4_max_abs_err", 0.0),
                    l.get("max_abs_err", 0.0)) for l in lines]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs),
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": f"{rep['shape']} M={rep['M']} K={rep['K']} N={rep['N']}",
        }

    kernels = [
        entry("fused_plane_linear", "src/repro_torch/kernels/csrc/plane_mm_fused.cu",
              "src/repro/kernels/plane_mm_fused.py:168", summary["fused_plane_linear"],
              eng_bit["launches"]),
        entry("plane_matmul", "src/repro_torch/kernels/csrc/plane_mm.cu",
              "src/repro/kernels/plane_mm.py:62", summary["plane_matmul"],
              eng_dig["launches"]),
        entry("plane_matmul_packed", "src/repro_torch/kernels/csrc/plane_mm_packed.cu",
              "src/repro/kernels/plane_mm_packed.py:160", summary["plane_matmul_packed"],
              eng_nof["launches"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
