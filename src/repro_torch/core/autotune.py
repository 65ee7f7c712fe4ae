"""Roofline-ranked tile autotuner for the Hopper plane kernels, with a
pluggable persistent store.

The reference's tuner (``src/repro/core/autotune.py``, after BISMO's
analytic pruning) lets a calibrated performance model cut the tile space
to a handful of candidates and measures only those. This module is its
counterpart for the card's three plane kernels:

1. **Hardware table + calibration.** :data:`HARDWARE_TABLE` has an H100
   row (NVIDIA's data sheet for the SXM card at 700 W: the rates PERF.md
   bounds every kernel with) and the reference's conservative CPU row for
   the plain versions. :func:`calibrate_from_bench` fits the int8 rate and
   the memory rate to the best envelope of a kernel report's packed and
   fused sections (device µs under the ``cuda_packed`` / ``cuda_fused``
   wall keys), as the reference fits its row.

2. **Legality-first candidates.** The kernels' launch geometry has two
   knobs: the row tile ``bm`` (8, 16 or 32 tokens) and the K split (the
   ranges a call's K chunks split into, partial sums meeting by atomics).
   ``bn`` is the 128 columns of a block and ``bk`` the route's own K extent
   (the fused route's pack block): neither varies.
   :func:`tile_candidates` enumerates the legal ``(bm, bn, bk, k_split)``
   (``ops.tiles_legal`` is the shared predicate), ranks them with
   :func:`_predict_us` (waves of blocks over the SMs, the padding of M to
   ``bm``, the split's workspace) and keeps at most :data:`MAX_CANDIDATES`,
   the default (``hopper_tiles`` and ``bytesplit.k_split``) always first.

3. **Measure only the survivors.** :class:`PlanAutotuner` times each
   candidate on the route's own kernel (:class:`KernelTimer`, CUDA events)
   and records the winner in a store keyed ``(host_fingerprint, plan key)``
   (``runtime/plan_store``). ``PlanRegistry`` asks an attached tuner before
   the default. The plain routes and the ``torch`` backend have no tiles to
   tune: one candidate, nothing measured.

Tuning measures, and a measurement synchronizes, which a CUDA-graph
capture forbids: :meth:`PlanAutotuner.tiles_for` raises inside a capture.
Every plan of a captured step resolves in its eager warm-up
(``launch/graphs.py``).

Layering: this is ``core`` — it imports neither ``runtime`` nor
``launch``; the store is duck-typed (``get``/``put``) and injected by the
serving layer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import platform
import re
import sys
from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "HARDWARE_TABLE",
    "HardwareModel",
    "KernelTimer",
    "MAX_CANDIDATES",
    "PlanAutotuner",
    "calibrate_from_bench",
    "hardware_model",
    "host_fingerprint",
    "plan_key_id",
    "tile_candidates",
]

MAX_CANDIDATES = 4

#: plan routes that launch a Hopper kernel on the card, by the kernel
#: wrapper they launch (its ``.launches`` counter is the wrapper's)
ROUTE_KERNELS = {
    "fused_cached": "fused_plane_linear",
    "fused_repack": "fused_plane_linear",
    "cached_packed": "plane_matmul_packed",
    "staged_packed": "plane_matmul_packed",
    "cached_planes": "plane_matmul",
    "staged": "plane_matmul",
}
#: seconds of fixed cost per wave of blocks in the model (block launch,
#: prologue, the output's write-back); it breaks ties toward fewer waves.
#: The model only has to rank candidates, not predict their times.
WAVE_OVERHEAD_S = 2e-6
#: seconds of one extra launch: the fused route's split epilogue kernel
LAUNCH_S = 3e-6
#: the share of the default's time a candidate must save to replace it. On
#: the H100 the timer's repeats of one candidate agree within ~1%, and the
#: decode shapes' candidates come within 0.5% of the default: a strict
#: minimum there picks by noise (PERF.md, the autotuner findings)
MIN_GAIN = 0.03


def _ops():
    # kernels.ops imports core modules; the lazy import keeps the layering
    # acyclic at import time, as core/plan does
    from repro_torch.kernels import ops

    return ops


# ---------------------------------------------------------------------------
# Hardware table + calibration


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """One row of the backend-keyed roofline table (rates per card)."""

    name: str
    peak_flops_bf16: float  # dense bf16 tensor-core rate, FLOP/s
    peak_flops_int8: float  # dense int8 tensor-core rate, OP/s
    hbm_bw: float  # device-memory rate, bytes/s
    link_bw: float  # per-direction interconnect rate, bytes/s
    hbm_bytes: int  # device-memory capacity
    source: str = "builtin"  # "builtin" | "calibrated:<where>"
    sms: int = 0  # streaming multiprocessors (0: no SM grid to fill)

    def compute_rate(self, int8: bool = True) -> float:
        return self.peak_flops_int8 if int8 else self.peak_flops_bf16


HARDWARE_TABLE = {
    # NVIDIA's H100 SXM data sheet (dense rates, the 700 W power limit):
    # 989 TFLOP/s bf16, 1979 TOP/s int8, 80 GB at 3.35 TB/s, NVLink
    # 900 GB/s all to all (450 GB/s each way), 132 SMs
    "h100": HardwareModel(
        name="h100-sxm",
        peak_flops_bf16=989e12,
        peak_flops_int8=1979e12,
        hbm_bw=3.35e12,
        link_bw=450e9,
        hbm_bytes=80 * 1024**3,
        sms=132,
    ),
    # The reference's conservative host row, for the plain versions:
    # calibrate_from_bench replaces it with a measured envelope when a
    # report exists.
    "cpu": HardwareModel(
        name="cpu-host",
        peak_flops_bf16=2e11,
        peak_flops_int8=4e11,
        hbm_bw=2e10,
        link_bw=1e10,
        hbm_bytes=8 * 1024**3,
    ),
}


def hardware_model(backend: str = "auto") -> HardwareModel:
    """Resolve a backend name to its hardware-table row: ``"cuda"`` (the
    Hopper kernels) is the H100 row, ``"cpu"`` the host row; ``"torch"``
    and ``"auto"`` take the row of the device this process has."""
    if backend in ("auto", "torch"):
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'auto', 'torch', 'cuda' or 'cpu', got {backend!r}")
    return HARDWARE_TABLE["h100" if backend == "cuda" else "cpu"]


def _measured_rates(configs, shape_key, flops_of, bytes_of, wall_keys):
    """Best observed (OP/s, bytes/s) over a report section's configs."""
    best_flops = 0.0
    best_bytes = 0.0
    for cfg in configs or ():
        shape = cfg.get(shape_key)
        walls = cfg.get("wall_us") or {}
        if not shape:
            continue
        wall_us = min(
            (walls[k] for k in wall_keys if isinstance(walls.get(k), (int, float))),
            default=None,
        )
        if not wall_us or wall_us <= 0:
            continue
        wall_s = wall_us * 1e-6
        best_flops = max(best_flops, flops_of(cfg, shape) / wall_s)
        best_bytes = max(best_bytes, bytes_of(cfg, shape) / wall_s)
    return best_flops, best_bytes


def calibrate_from_bench(bench, backend: str = "auto") -> HardwareModel:
    """Fit the roofline terms to a measured kernel report.

    ``bench`` is the parsed report dict or a path to it, in the reference's
    section schema (``benches`` → ``packed_plane_matmul`` /
    ``fused_linear`` / ``fused_linear_smoke`` → ``configs``) with the
    card's device µs under ``wall_us["cuda_packed"]`` and
    ``wall_us["cuda_fused"]``. The fit is the envelope: the fastest
    plane-pass OP/s and byte/s observed become the int8 and memory rates
    (the bf16 rate half the int8 one), the reference's arithmetic. Falls
    back to the builtin row when the report is missing, malformed or has
    no usable section."""
    base = hardware_model(backend)
    if isinstance(bench, str):
        try:
            with open(bench) as fh:
                bench = json.load(fh)
        except (OSError, ValueError):
            return base
    if not isinstance(bench, dict):
        return base
    benches = bench.get("benches", {})
    if not isinstance(benches, dict):
        return base
    where = bench.get("host", "bench")

    # plane-pass operations: each of the mxu_passes plane pairs is a full
    # (m, k, n) multiply-accumulate
    def _plane_flops(cfg, shape):
        m, k, n = shape
        return 2.0 * m * k * n * max(1, cfg.get("mxu_passes", 1))

    flops_a, bytes_a = _measured_rates(
        benches.get("packed_plane_matmul", {}).get("configs"),
        "kernel_shape",
        _plane_flops,
        lambda cfg, s: (cfg.get("bytes") or {}).get("packed_operand_bytes", 0),
        ("cuda_packed",),
    )
    flops_b = bytes_b = 0.0
    for section in ("fused_linear", "fused_linear_smoke"):
        f, b = _measured_rates(
            benches.get(section, {}).get("configs"),
            "shape",
            _plane_flops,
            lambda cfg, s: (cfg.get("bytes") or {}).get("fused_hbm_bytes", 0),
            ("cuda_fused",),
        )
        flops_b, bytes_b = max(flops_b, f), max(bytes_b, b)

    peak_int8 = max(flops_a, flops_b)
    hbm_bw = max(bytes_a, bytes_b)
    if peak_int8 <= 0 or hbm_bw <= 0:
        return base
    return dataclasses.replace(
        base,
        peak_flops_int8=peak_int8,
        peak_flops_bf16=peak_int8 / 2.0,
        hbm_bw=hbm_bw,
        source=f"calibrated:{where}",
    )


# ---------------------------------------------------------------------------
# Host fingerprint + plan-key identity


def _slug(text: str) -> str:
    return re.sub(r"[^A-Za-z0-9.]+", "_", text).strip("_")


def host_fingerprint() -> str:
    """Stable identity of the (hardware, toolchain) tuning results bind to:
    OS, machine, Python, torch, CUDA, the device's name and count. The
    hostname stays out, so two hosts with the same card and toolchain share
    one store entry; a toolchain upgrade or another card changes the
    fingerprint and reads an empty namespace. The card's name is spelled
    out in it (``linux-x86_64-cuda-NVIDIA_H100_80GB_HBM3-<digest>``)."""
    if torch.cuda.is_available():
        backend = "cuda"
        device = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
    else:
        backend, device, count = "cpu", "cpu", 0
    raw = "|".join((
        platform.system(),
        platform.machine(),
        f"py{sys.version_info.major}.{sys.version_info.minor}",
        f"torch{torch.__version__}",
        f"cuda{torch.version.cuda}",
        backend,
        device,
        str(count),
    ))
    digest = hashlib.sha256(raw.encode()).hexdigest()[:12]
    where = backend if backend == "cpu" else f"{backend}-{_slug(device)}"
    return f"{platform.system().lower()}-{platform.machine()}-{where}-{digest}"


def plan_key_id(key) -> str:
    """A PlanKey as the store's lookup string: the reference's format
    (sorted-key compact JSON). The requested-tile fields are dropped: the
    tuner is consulted only when all are None."""
    d = dataclasses.asdict(key)
    for tile in ("bm", "bn", "bk"):
        d.pop(tile, None)
    if d.get("shard") is not None:
        d["shard"] = list(d["shard"])
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# Candidate generation + roofline ranking


def _pack_block(key, kernel: str) -> Optional[int]:
    """The weight's pack block a fused_cached plan runs with (the cache's)."""
    return key.cache[4] if kernel == "fused_cached" and key.cache else None


def _planes(bits: int, level: str) -> int:
    """Planes of an operand: bit planes, or radix-256 digits."""
    return bits if level == "bitplane" else -(-bits // 8)


def _digits(kernel: str, key) -> Tuple[int, int]:
    """(activation, weight) operands of the route kernel's int8 products
    per (m, n, k): the byte-split kernels' signed activation bytes and
    weight byte digits (``kernels/bytesplit.py``), or the plane-pair
    kernel's planes."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.kernels import bytesplit

    route = ROUTE_KERNELS[kernel]
    if route == "plane_matmul":
        return _planes(key.a_bits, key.level), _planes(key.w_bits, key.level)
    ternary = key.variant == "booth"
    n_wd = len(bytesplit.weight_digits(bp.plane_weights(key.w_bits, key.variant), ternary))
    if route == "fused_plane_linear":
        return 1, n_wd
    return bytesplit.signed_byte_count(bp.plane_weights(key.a_bits, key.variant), ternary), n_wd


def _predict_us(hw: HardwareModel, kernel: str, key, bm: int, bk: int, k_split: int) -> float:
    """Modelled time of one call at these tiles, µs.

    Blocks: ceil(N/128) x ceil(M/bm) x splits (``k_split`` capped at the
    K chunks: splits of equal chunk counts). They run in waves over
    ``bytesplit.BLOCKS_PER_SM`` slots on each SM, and a grid that leaves
    slots empty (one partial wave, or fewer blocks than slots) gets that
    share of the card's rates. The operations pad M to ``bm``; the weight is read once
    per row tile; a split adds its workspace (zeroing, and each split's
    partial sums) and, on the fused route, the epilogue's launch."""
    from repro_torch.kernels import bytesplit

    ops = _ops()
    m, k, n = key.m, key.k, key.n
    chunks = ops.k_chunks(kernel, k, bk)
    splits = _splits(chunks, k_split)
    gm, gn = -(-m // bm), -(-n // bytesplit.COLS_PER_BLOCK)
    blocks = gm * gn * splits
    slots = max(1, hw.sms) * bytesplit.BLOCKS_PER_SM
    waves = -(-blocks // slots)
    fill = blocks / (waves * slots)
    n_a, n_w = _digits(kernel, key)
    operations = 2.0 * gm * bm * k * gn * bytesplit.COLS_PER_BLOCK * n_a * n_w
    if ROUTE_KERNELS[kernel] == "plane_matmul":
        w_bytes = n_w * k * n  # int8 planes
    else:  # packed magnitude (and Booth sign) words
        w_bytes = key.w_bits * k * n * (2 if key.variant == "booth" else 1) / 8
    n_bytes = w_bytes * gm + n_a * m * k + 4 * m * n
    extra_s = 0.0
    if splits > 1:
        n_bytes += 4 * m * n * (splits + 1)
        if kernel in ops.FUSED_KERNELS:
            extra_s = LAUNCH_S
    body_s = max(operations / hw.compute_rate(int8=True), n_bytes / hw.hbm_bw) / fill
    return (body_s + waves * WAVE_OVERHEAD_S + extra_s) * 1e6


def _heuristic_tiles(key, kernel: str, sms: int = HARDWARE_TABLE["h100"].sms
                     ) -> Tuple[int, int, int, int]:
    """The default a plan without a tuner runs with: ``hopper_tiles`` and
    the K split the wrapper would pick at launch on a card of ``sms`` SMs
    (1 on the plain routes, which run in one pass)."""
    from repro_torch.kernels import bytesplit

    ops = _ops()
    bm, bn, bk = ops.hopper_tiles(key.m, key.k, key.n, kernel=kernel,
                                  pack_block=_pack_block(key, kernel))
    if kernel not in ROUTE_KERNELS or key.backend == "torch":
        return bm, bn, bk, 1
    chunks = ops.k_chunks(kernel, key.k, bk)
    return bm, bn, bk, bytesplit.k_split(key.m, key.n, chunks, bm, sms)


def _splits(chunks: int, k_split: int) -> int:
    per = -(-chunks // k_split)
    return -(-chunks // per)


def tile_candidates(key, kernel: str, hw: Optional[HardwareModel] = None) -> list:
    """Legal, model-ranked ``(bm, bn, bk, k_split)`` candidates.

    At most :data:`MAX_CANDIDATES`, the default first (so a tuner that
    measures this list can never do worse than the default), then the best
    predicted among row tiles up to the default's (a larger one only pads
    M); K splits that cut the chunks into the same number of ranges launch
    the same grid and count once. The plain routes and the ``torch``
    backend return the default alone."""
    from repro_torch.kernels import bytesplit

    ops = _ops()
    hw = hw or hardware_model(key.backend)
    heur = _heuristic_tiles(key, kernel, hw.sms or HARDWARE_TABLE["h100"].sms)
    if kernel not in ROUTE_KERNELS or key.backend == "torch":
        return [heur]
    _, bn, bk, _ = heur
    chunks = ops.k_chunks(kernel, key.k, bk)
    pack_block = _pack_block(key, kernel)
    scored = []
    # a row tile above the smallest one covering M pads M and reads no less
    for bm in (t for t in bytesplit.ROW_TILES if t <= heur[0]):
        for ks in range(1, chunks + 1):
            if ops.tiles_legal(bm, bn, bk, kernel=kernel, k_split=ks, k=key.k,
                               pack_block=pack_block):
                scored.append((_predict_us(hw, kernel, key, bm, bk, ks), (bm, bn, bk, ks)))
    scored.sort(key=lambda t: (t[0], t[1]))
    out = [heur]
    grids = {(heur[0], _splits(chunks, heur[3]))}
    for _, tiles in scored:
        grid = (tiles[0], _splits(chunks, tiles[3]))
        if grid not in grids:
            grids.add(grid)
            out.append(tiles)
        if len(out) >= MAX_CANDIDATES:
            break
    return out


# ---------------------------------------------------------------------------
# The tuner


class PlanAutotuner:
    """Tile tuner ``PlanRegistry`` consults before the ``hopper_tiles``
    default.

    ``store`` is duck-typed (``get(fingerprint, key_id)`` /
    ``put(fingerprint, key_id, record)``): pass a
    ``repro_torch.runtime.plan_store.PlanStore`` from the serving layer.
    ``measure(key, kernel, tiles, repeats=) -> µs`` times one candidate
    (default: a :class:`KernelTimer` on the card). Counters: ``store_hits``
    (a plan's tiles served from the store), ``store_misses`` (no usable
    record), ``tunes`` (candidate lists tuned)."""

    def __init__(
        self,
        store=None,
        *,
        fingerprint: Optional[str] = None,
        hw: Optional[HardwareModel] = None,
        tune_on_miss: bool = True,
        measure: Optional[Callable] = None,
        repeats: int = 2,
    ) -> None:
        self.store = store
        self.fingerprint = fingerprint or host_fingerprint()
        self.hw = hw or hardware_model()
        self.tune_on_miss = tune_on_miss
        self._measure = measure or KernelTimer()
        self.repeats = repeats
        self.store_hits = 0
        self.store_misses = 0
        self.tunes = 0
        self._memo: dict = {}

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        return {
            "store_hits": self.store_hits,
            "store_misses": self.store_misses,
            "tunes": self.tunes,
            "fingerprint": self.fingerprint,
            "hardware": self.hw.name,
            "hardware_source": self.hw.source,
        }

    # -- the PlanRegistry hook --------------------------------------------
    def tiles_for(self, key, kernel: str) -> Optional[Tuple[int, int, int, int]]:
        """``(bm, bn, bk, k_split)`` for ``(key, kernel)``, or None for the
        default.

        A store hit is checked for legality first: a stale or hand-edited
        record (a row tile the kernels lack, a K split beyond the chunks,
        another column tile) is a miss, never a crash and never a launch.
        A miss tunes the candidates when ``tune_on_miss``, stores the
        winner and returns it. Raises inside a CUDA-graph capture: a
        measurement synchronizes, which a capture forbids, so plans must
        resolve in the eager warm-up before it."""
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"plan {kernel} {key.m}x{key.k}x{key.n} resolved inside a CUDA-graph "
                "capture: the tuner would measure (and synchronize) there; resolve every "
                "plan of a captured step in its eager warm-up"
            )
        key_id = plan_key_id(key)
        if key_id in self._memo:
            return self._memo[key_id]
        record = self.store.get(self.fingerprint, key_id) if self.store else None
        if record is not None:
            tiles = _record_tiles(record)
            if (tiles is not None and record.get("kernel", kernel) == kernel
                    and _ops().tiles_legal(*tiles[:3], kernel=kernel, k_split=tiles[3],
                                           k=key.k, pack_block=_pack_block(key, kernel))):
                self.store_hits += 1
                self._memo[key_id] = tiles
                return tiles
        self.store_misses += 1
        if not self.tune_on_miss:
            return None
        tiles, detail = self.tune(key, kernel)
        self.tunes += 1
        if self.store is not None:
            self.store.put(
                self.fingerprint,
                key_id,
                {"bm": tiles[0], "bn": tiles[1], "bk": tiles[2], "k_split": tiles[3],
                 "kernel": kernel, **detail},
            )
        self._memo[key_id] = tiles
        return tiles

    def tune(self, key, kernel: str) -> Tuple[Tuple[int, int, int, int], dict]:
        """Time the ranked candidates; return (winner, detail). The fastest
        replaces the default only when it saves at least
        :data:`MIN_GAIN` of the default's time."""
        cands = tile_candidates(key, kernel, self.hw)
        if len(cands) == 1:
            # one survivor (a plain route): nothing to measure
            return cands[0], {"candidates": 1, "source": "heuristic"}
        walls = {tiles: self._measure(key, kernel, tiles, repeats=self.repeats)
                 for tiles in cands}
        best = min(cands, key=walls.__getitem__)
        if walls[best] > walls[cands[0]] * (1.0 - MIN_GAIN):
            best = cands[0]
        return best, {"candidates": len(cands), "source": "measured",
                      "wall_us": {"x".join(map(str, t)): round(us, 3) for t, us in walls.items()}}


def _record_tiles(record) -> Optional[Tuple[int, int, int, int]]:
    if not isinstance(record, dict):
        return None
    try:
        tiles = tuple(int(record[f]) for f in ("bm", "bn", "bk", "k_split"))
    except (KeyError, TypeError, ValueError):
        return None
    return tiles if all(t > 0 for t in tiles) else None


# ---------------------------------------------------------------------------
# Measuring a candidate on the card


class KernelTimer:
    """The default ``measure``: one call of the route's own kernel at the
    key's shape, timed on the card — the fused kernel for ``fused_*``, the
    packed kernel for ``*_packed``, the plane-pair kernel for
    ``cached_planes`` / ``staged`` (the three cost differently on this
    card). Operands are built on the card from a seeded
    ``torch.Generator``, once per (key, route) (the candidates of one key
    share them); the pair weights come from ``ops._pair_weights``, so the
    byte-split kernels run with no read-back.

    The weight is read cold, as a served step reads each layer's weight
    from HBM once: the timer rotates over enough copies of it that the
    others' bytes, read in between, exceed twice the L2 cache
    (:func:`_cold_copies`). Each repeat idles the card
    (``torch.cuda._sleep``) while the host enqueues ``calls`` launches
    between two CUDA events, so the events time the card alone; the result
    is the best repeat's µs a call, after one warm-up call on each copy.
    The wrappers' ``launches`` counts are put back: a timing launch is not
    a main-path one."""

    #: launches between the events of one repeat
    calls = 5
    #: cycles the card idles before a repeat (~1 ms at 1.98 GHz): room for
    #: the host to enqueue the repeat's launches ahead of the card
    sleep_cycles = 2_000_000

    def __init__(self) -> None:
        self._key = None
        self._call = None

    def route_call(self, key, kernel: str) -> Callable:
        """``call(bm, k_split, raw=False, copy=0)``: the route's kernel on
        the key's operands, built on the card once per (key, route); ``raw``
        takes the fused kernel's int32 accumulator instead of its bf16
        epilogue, ``copy`` one of ``call.copies`` equal weights."""
        if not torch.cuda.is_available():
            raise RuntimeError("the tuner times the Hopper kernels: it needs a CUDA card")
        if kernel not in ROUTE_KERNELS:
            raise ValueError(f"route {kernel!r} launches no Hopper kernel to time")
        ident = (plan_key_id(key), kernel)
        if self._key != ident:
            self._call, self._key = None, None  # free the last key's operands first
            self._call, self._key = _route_call(key, kernel), ident
        return self._call

    def __call__(self, key, kernel: str, tiles, repeats: int = 2) -> float:
        from repro_torch.kernels import plane_mm, plane_mm_fused, plane_mm_packed

        call = self.route_call(key, kernel)
        bm, _, _, k_split = tiles
        # the wrappers a plane route can launch (the fused and packed ones
        # reach plane_matmul on their all-pairs path)
        counters = {fn.__name__: fn for fn in (plane_mm_fused.fused_plane_linear,
                                               plane_mm_packed.plane_matmul_packed,
                                               plane_mm.plane_matmul)}
        saved = {name: fn.launches for name, fn in counters.items()}
        try:
            for copy in range(call.copies):
                call(bm, k_split, copy=copy)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            best = math.inf
            turn = 0
            for _ in range(max(1, repeats)):
                torch.cuda._sleep(self.sleep_cycles)
                start.record()
                for _ in range(self.calls):
                    call(bm, k_split, copy=turn % call.copies)
                    turn += 1
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / self.calls)
        finally:
            for name, fn in counters.items():
                fn.launches = saved[name]
        return best * 1e3


def _l2_bytes(dev: torch.device) -> int:
    # the H100's 50 MB where the properties lack the field
    return int(getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 0) or 50 << 20)


def _weight_bytes(w) -> int:
    parts = (w,) if isinstance(w, torch.Tensor) else (w.mag, w.sign)
    return sum(t.numel() * t.element_size() for t in parts if t is not None)


def _weight_copy(w):
    if isinstance(w, torch.Tensor):
        return w.clone()
    return dataclasses.replace(w, mag=w.mag.clone(),
                               sign=None if w.sign is None else w.sign.clone())


#: the most weight copies the timer rotates over (a 1 MB weight needs ~100)
MAX_COPIES = 64


def _cold_copies(w, l2_bytes: int) -> list:
    """``w`` and enough copies of it that, rotating over them, the bytes
    read between two reads of one copy exceed twice ``l2_bytes``: each
    read then comes from HBM (a weight of twice the L2 or more evicts
    itself)."""
    size = max(1, _weight_bytes(w))
    if size >= 2 * l2_bytes:
        return [w]
    n = min(MAX_COPIES, 1 + -(-2 * l2_bytes // size))
    return [w] + [_weight_copy(w) for _ in range(n - 1)]


def _route_call(key, kernel: str) -> Callable:
    """``call(bm, k_split, raw=False, copy=0)``: the route's kernel on
    operands of the key's shape and widths, built on the card from a seeded
    generator; ``copy`` picks one of ``call.copies`` equal weights
    (:func:`_cold_copies`)."""
    from repro_torch.core import bitplanes as bp

    ops = _ops()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def ints(shape, bits):
        hi = 1 << (bits - 1)
        return torch.randint(-hi, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    x = ints((key.m, key.k), min(key.a_bits, 8))
    w = ints((key.k, key.n), min(key.w_bits, 8))
    route = ROUTE_KERNELS[kernel]
    if route == "fused_plane_linear":
        _, _, bk, _ = _heuristic_tiles(key, kernel)
        packed_w = bp.make_weight_planes(w, w_bits=key.w_bits, variant=key.variant,
                                         level="bitplane", store="packed", block=bk).packed
        ep = ops.Epilogue(a_scale=torch.ones((key.m, 1), dtype=torch.float32, device=dev),
                          w_scale=torch.ones((key.n,), dtype=torch.float32, device=dev))
        weights = _cold_copies(packed_w, _l2_bytes(dev))

        def call(bm, k_split, raw=False, copy=0):
            return ops.fused_linear(x, weights[copy], None if raw else ep, a_bits=key.a_bits,
                                    variant=key.variant, backend="cuda", bm=bm, k_split=k_split)

        call.copies = len(weights)
        return call
    if route == "plane_matmul_packed":
        block = key.cache[4] if kernel == "cached_packed" and key.cache else None
        wp = bp.make_weight_planes(w, w_bits=key.w_bits, variant=key.variant,
                                   level="bitplane", store="packed", block=block)
        dec_a = bp.to_bitplanes(x, key.a_bits, key.variant)
        pa = bp.pack_decomposition(dec_a, axis=-1, variant=key.variant, block=block)
        pw = ops._pair_weights(dec_a.weights, wp.weights, dev)
        weights = _cold_copies(wp.packed, _l2_bytes(dev))

        def call(bm, k_split, raw=False, copy=0):
            return ops.plane_matmul_packed(pa, weights[copy], pw, backend="cuda", bm=bm,
                                           k_split=k_split)

        call.copies = len(weights)
        return call
    if key.level == "bitplane":
        wp = bp.make_weight_planes(w, w_bits=key.w_bits, variant=key.variant,
                                   level="bitplane", store="both")
        dec_a = bp.to_bitplanes(x, key.a_bits, key.variant)
    else:
        wp = bp.make_weight_planes(w, w_bits=key.w_bits, variant=key.variant, level="digit")
        dec_a = bp.to_digits(x, key.a_bits, key.variant)
    a_planes = dec_a.planes.to(torch.int8).contiguous()
    w_planes = wp.planes.to(torch.int8).contiguous()
    pw = ops._pair_weights(dec_a.weights, wp.weights, dev)
    weights = _cold_copies(w_planes, _l2_bytes(dev))

    def call(bm, k_split, raw=False, copy=0):
        return ops.plane_matmul(a_planes, weights[copy], pw, backend="cuda", bm=bm,
                                k_split=k_split)

    call.copies = len(weights)
    return call
