"""The port's tile autotuner and plan store, on the CPU.

Mirrors the reference's ``tests/test_autotune.py`` behaviour by behaviour
on the Hopper kernels' geometry — a candidate is ``(bm, bn, bk, k_split)``:
``bm`` a row tile the kernels are instantiated for, ``bn`` the 128 columns
of a block, ``bk`` the route's own K extent (the fused route's pack
block), ``k_split`` at most the call's K chunks:

* candidates always legal (``ops.tiles_legal``) for random shapes and
  every tunable route, at most ``MAX_CANDIDATES``, the default among them;
  the fused routes' ``bk`` pinned; the plain routes and the ``torch``
  backend collapsing to the default; the model only reordering;
* calibration falling back on garbage and fitting the envelope; the
  fingerprint stable and free of the hostname; plan-key ids dropping the
  requested tiles;
* the store's round trip, torn file and version mismatch; tuner
  persistence, a warm store with zero tunes, illegal records rejected (a
  row tile the kernels lack, a K split beyond the chunks, a 256-column
  tile, a missing field), the memo; registry provenance, degrading to the
  default, explicit tiles bypassing the tuner, zero counters untuned.

And against the JAX package: plan-key ids equal for the same key once the
backend names are mapped (``cuda``/``pallas``, ``torch``/``jnp``), stores
crossing both ways, and the calibrated rates equal on one synthetic report
written in each package's wall keys. Plus the port's own contracts: the
tuner refuses to resolve a plan inside a CUDA-graph capture, a tuned
plan's K split reaches the kernel wrappers, and a tuned plan gives the
default plan's integers.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.core import autotune as jautotune
from repro.core import plan as jplan
from repro.runtime.plan_store import PlanStore as JPlanStore
from repro_torch.core import autotune
from repro_torch.core import plan as plan_mod
from repro_torch.core.autotune import (
    HARDWARE_TABLE,
    MAX_CANDIDATES,
    PlanAutotuner,
    calibrate_from_bench,
    hardware_model,
    host_fingerprint,
    plan_key_id,
    tile_candidates,
)
from repro_torch.core.plan import PlanRegistry, plan_for_operands
from repro_torch.kernels import bytesplit, ops
from repro_torch.runtime.plan_store import STORE_VERSION, PlanStore

TUNABLE_KERNELS = sorted(autotune.ROUTE_KERNELS)
BLOCKED_CACHE = ("bitplane", "booth", 4, True, 512, False, 4, False)


def _key(m=64, k=2048, n=256, a_bits=4, w_bits=4, backend="cuda", **kw):
    defaults = dict(
        m=m, k=k, n=n, a_bits=a_bits, w_bits=w_bits, a_in_bits=a_bits, w_in_bits=w_bits,
        variant="booth", level="bitplane", mode="fully_serial", backend=backend,
        accum="int32", has_epilogue=False, cache=None, fused=None, packed=None,
        bm=None, bn=None, bk=None,
    )
    defaults.update(kw)
    return plan_mod.PlanKey(**defaults)


def _stub_measure(walls):
    """Deterministic measure fn: µs looked up by candidate."""

    def measure(key, kernel, tiles, repeats=2):
        return walls.get(tuple(tiles), 100.0)

    return measure


def _legal(key, kernel, tiles):
    bm, bn, bk, ks = tiles
    return ops.tiles_legal(bm, bn, bk, kernel=kernel, k_split=ks, k=key.k,
                           pack_block=autotune._pack_block(key, kernel))


# -- candidate generation ----------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(
    m=st.integers(1, 700),
    k=st.integers(32, 13000),
    n=st.integers(64, 2048),
    a_bits=st.integers(1, 8),
    w_bits=st.integers(1, 8),
    kernel=st.sampled_from(TUNABLE_KERNELS),
    level=st.sampled_from(("bitplane", "digit")),
)
def test_candidates_always_legal(m, k, n, a_bits, w_bits, kernel, level):
    if kernel not in ("cached_planes", "staged"):
        level = "bitplane"  # the byte-split kernels serve bit planes only
    cache = BLOCKED_CACHE if kernel == "fused_cached" else None
    key = _key(m=m, k=k, n=n, a_bits=a_bits, w_bits=w_bits, level=level, cache=cache)
    cands = tile_candidates(key, kernel)
    assert 1 <= len(cands) <= MAX_CANDIDATES
    heur = autotune._heuristic_tiles(key, kernel)
    assert cands[0] == heur, "the default must lead the candidates"
    chunks = ops.k_chunks(kernel, k, heur[2])
    for tiles in cands:
        bm, bn, bk, ks = tiles
        assert _legal(key, kernel, tiles), (kernel, tiles)
        assert bm in bytesplit.ROW_TILES and bm <= heur[0]
        assert bn == bytesplit.COLS_PER_BLOCK and bk == heur[2]
        assert 1 <= ks <= chunks
    grids = {(t[0], autotune._splits(chunks, t[3])) for t in cands}
    assert len(grids) == len(cands), "equal grids must count once"


def test_fused_routes_pin_bk_to_pack_block():
    """For the fused kernel the pack block is the K tile: bk never varies."""
    for kernel, cache, want in (("fused_cached", ("bitplane", "booth", 4, True, 256, False, 4,
                                                  False), 256),
                                ("fused_repack", None, 512)):
        key = _key(m=256, k=4096, n=1024, cache=cache)
        cands = tile_candidates(key, kernel)
        assert len(cands) > 1
        assert {t[2] for t in cands} == {want}


def test_plain_routes_collapse_to_heuristic():
    """The plain routes have no tiles to tune: one candidate, nothing to time."""
    for kernel, backend in [("cached_scan", "cuda"), ("oracle", "cuda"), ("staged", "torch"),
                            ("cached_packed", "torch")]:
        key = _key(backend=backend)
        assert tile_candidates(key, kernel) == [autotune._heuristic_tiles(key, kernel)]
        assert tile_candidates(key, kernel)[0][3] == 1


def test_candidates_ranked_by_calibrated_model():
    """Another hardware row changes the order, never legality."""
    key = _key(m=512, k=4096, n=4096)
    for hw in (HARDWARE_TABLE["cpu"], HARDWARE_TABLE["h100"]):
        cands = tile_candidates(key, "cached_packed", hw)
        assert len(cands) <= MAX_CANDIDATES
        for tiles in cands:
            assert _legal(key, "cached_packed", tiles)
    # at decode the default's split fills the card where one range leaves
    # three quarters of the SMs idle: the model ranks the unsplit grid below
    dec = _key(m=4, k=4096, n=12800, a_bits=8, w_bits=8)
    h100 = HARDWARE_TABLE["h100"]
    heur = autotune._heuristic_tiles(dec, "cached_packed")
    assert heur[3] > 1
    assert (autotune._predict_us(h100, "cached_packed", dec, 8, heur[2], heur[3])
            < autotune._predict_us(h100, "cached_packed", dec, 8, heur[2], 1))


@pytest.mark.parametrize("tiles, ok", [
    ((8, 128, 512, 1), True), ((16, 128, 512, 8), True), ((32, 128, 512, None), True),
    ((4, 128, 512, 1), False), ((64, 128, 512, 1), False), ((8, 256, 512, 1), False),
    ((8, 128, 128, 1), False), ((8, 128, 512, 9), False), ((8, 128, 512, 0), False),
    ((8, 128, 512, True), False), ((8, 128, 512, 2.0), False),
])
def test_tiles_legal_on_the_packed_route(tiles, ok):
    bm, bn, bk, ks = tiles
    assert ops.tiles_legal(bm, bn, bk, kernel="cached_packed", k_split=ks, k=4096) is ok


def test_k_chunks_per_route():
    assert ops.k_chunks("cached_planes", 4096, 128) == 32
    assert ops.k_chunks("staged_packed", 4096, 512) == 8
    assert ops.k_chunks("staged_packed", 1000, 512) == 2  # 32 words
    assert ops.k_chunks("fused_cached", 4096, 512) == 8
    assert ops.k_chunks("fused_cached", 130, 256) == 1  # 8 words of one padded block


# -- calibration + identity --------------------------------------------------


def test_calibration_falls_back_on_garbage(tmp_path):
    base = hardware_model("cpu")
    assert calibrate_from_bench(str(tmp_path / "missing.json"), "cpu") == base
    torn = tmp_path / "torn.json"
    torn.write_text('{"benches": {"packed_plane_mat')
    assert calibrate_from_bench(str(torn), "cpu") == base
    assert calibrate_from_bench({"benches": {}}, "cpu") == base
    assert calibrate_from_bench({"benches": []}, "cpu") == base
    assert calibrate_from_bench(None, "cpu") == base
    # the reference's CPU-interpret wall keys are not the card's
    ref_keys = _report("interpret_packed", "interpret_fused")
    assert calibrate_from_bench(ref_keys, "cuda") == hardware_model("cuda")


def _report(packed_key, fused_key):
    return {
        "host": "unit",
        "benches": {
            "packed_plane_matmul": {"configs": [{
                "kernel_shape": [128, 256, 128], "mxu_passes": 4,
                "wall_us": {packed_key: 100.0}, "bytes": {"packed_operand_bytes": 40_000},
            }]},
            "fused_linear": {"configs": [{
                "shape": [64, 512, 256], "mxu_passes": 2,
                "wall_us": {fused_key: 50.0}, "bytes": {"fused_hbm_bytes": 30_000},
            }]},
        },
    }


def test_calibration_fits_envelope():
    hw = calibrate_from_bench(_report("cuda_packed", "cuda_fused"), "cuda")
    flops = max(2 * 128 * 256 * 128 * 4 / 100e-6, 2 * 64 * 512 * 256 * 2 / 50e-6)
    assert hw.peak_flops_int8 == pytest.approx(flops)
    assert hw.peak_flops_bf16 == pytest.approx(flops / 2)
    assert hw.hbm_bw == pytest.approx(max(40_000 / 100e-6, 30_000 / 50e-6))
    assert hw.source == "calibrated:unit"
    # untouched terms keep the builtin values
    assert (hw.link_bw, hw.hbm_bytes, hw.sms) == (450e9, 80 * 1024**3, 132)


def test_calibrated_rates_equal_the_reference():
    """One report, written in each package's wall keys, fits the same rates."""
    ours = calibrate_from_bench(_report("cuda_packed", "cuda_fused"), "cpu")
    ref = jautotune.calibrate_from_bench(_report("interpret_packed", "interpret_fused"), "jnp")
    assert (ours.peak_flops_int8, ours.peak_flops_bf16, ours.hbm_bw, ours.source) == (
        ref.peak_flops_int8, ref.peak_flops_bf16, ref.hbm_bw, ref.source)


def test_hardware_table_rows():
    assert set(HARDWARE_TABLE) == {"h100", "cpu"}  # no TPU row
    h100 = hardware_model("cuda")
    assert (h100.peak_flops_bf16, h100.peak_flops_int8, h100.hbm_bw) == (989e12, 1979e12, 3.35e12)
    # the host row is the reference's (plus an empty SM grid)
    assert dataclasses.astuple(hardware_model("cpu"))[:7] == dataclasses.astuple(
        jautotune.HARDWARE_TABLE["cpu"])
    assert hardware_model("torch") == hardware_model("auto") == hardware_model("cpu")
    with pytest.raises(ValueError, match="backend"):
        hardware_model("pallas")


def test_host_fingerprint_stable_and_hostname_free():
    import socket

    fp = host_fingerprint()
    assert fp == host_fingerprint()
    assert socket.gethostname() not in fp
    assert fp.startswith(f"{__import__('platform').system().lower()}-")


def test_plan_key_id_drops_requested_tiles():
    a = plan_key_id(_key(bm=None, bn=None, bk=None))
    b = plan_key_id(_key(bm=8, bn=128, bk=512))
    assert a == b
    assert json.loads(a)["m"] == 64


@pytest.mark.parametrize("backend, jbackend", [("cuda", "pallas"), ("torch", "jnp")])
def test_plan_key_ids_equal_the_reference(backend, jbackend):
    """The same key in both packages has the same store id, backends mapped."""
    fields = dict(cache=BLOCKED_CACHE, has_epilogue=True, integrity="detect",
                  shard=("model", 2, "col"), bm=8)
    ours = plan_key_id(_key(backend=backend, **fields))
    ref = jautotune.plan_key_id(jplan.PlanKey(**dict(
        dataclasses.asdict(_key(backend=jbackend, **fields)))))
    assert ours.replace(f'"backend":"{backend}"', f'"backend":"{jbackend}"') == ref
    # keys the two packages resolve from the same operands agree too
    tk = plan_for_operands(((4, 128), (128, 64)), a_bits=8, w_bits=8, level="bitplane",
                           backend="torch", has_epilogue=True,
                           registry=PlanRegistry()).key
    jk = jplan.plan_for_operands(((4, 128), (128, 64)), a_bits=8, w_bits=8, level="bitplane",
                                 backend="jnp", has_epilogue=True,
                                 registry=jplan.PlanRegistry()).key
    assert plan_key_id(tk).replace('"torch"', '"jnp"') == jautotune.plan_key_id(jk)


# -- persistent store --------------------------------------------------------


def test_store_roundtrip_and_atomic_layout(tmp_path):
    path = tmp_path / "plans" / "store.json"
    store = PlanStore(str(path))
    assert store.get("fp", "k1") is None
    assert store.load_error is None
    store.put("fp", "k1", {"bm": 8, "bn": 128, "bk": 512, "k_split": 6})
    assert PlanStore(str(path)).get("fp", "k1")["k_split"] == 6
    doc = json.loads(path.read_text())
    assert doc["version"] == STORE_VERSION
    assert not list(path.parent.glob(".*tmp*")), "no temp files left behind"
    assert PlanStore(str(path)).stats() == {"path": str(path), "entries": 1,
                                            "version": STORE_VERSION}


def test_store_torn_json_degrades(tmp_path):
    path = tmp_path / "store.json"
    path.write_text('{"version": 1, "hosts": {"fp": {"k1"')
    store = PlanStore(str(path))
    assert store.get("fp", "k1") is None
    assert store.load_error is not None
    store.put("fp", "k2", {"bm": 32, "bn": 128, "bk": 512, "k_split": 1})
    assert PlanStore(str(path)).get("fp", "k2") is not None


def test_store_version_mismatch_discards(tmp_path):
    path = tmp_path / "store.json"
    path.write_text(json.dumps({
        "version": 999, "hosts": {"fp": {"k1": {"bm": 8, "bn": 128, "bk": 512}}},
    }))
    store = PlanStore(str(path))
    assert store.get("fp", "k1") is None
    assert "version mismatch" in (store.load_error or "")


def test_stores_cross_both_ways(tmp_path):
    """A file either package's store wrote loads in the other's, records whole."""
    rec = {"bm": 8, "bn": 128, "bk": 512, "k_split": 6, "kernel": "fused_cached",
           "candidates": 4, "source": "measured", "wall_us": {"8x128x512x6": 41.5}}
    JPlanStore(str(tmp_path / "ref.json")).put("fp-ref", "k", rec)
    assert PlanStore(str(tmp_path / "ref.json")).get("fp-ref", "k") == rec
    PlanStore(str(tmp_path / "port.json")).put("fp-port", "k", rec)
    jstore = JPlanStore(str(tmp_path / "port.json"))
    assert jstore.get("fp-port", "k") == rec and jstore.load_error is None
    # a reference record (no k_split) is a miss for the port's tuner, not a crash
    PlanStore(str(tmp_path / "ref.json")).put("fp", plan_key_id(_key()),
                                              {"bm": 32, "bn": 256, "bk": 512})
    tuner = PlanAutotuner(PlanStore(str(tmp_path / "ref.json")), fingerprint="fp",
                          tune_on_miss=False)
    assert tuner.tiles_for(_key(), "cached_packed") is None
    assert (tuner.store_hits, tuner.store_misses) == (0, 1)


# -- tuner: store consultation + degradation ---------------------------------


def test_tuner_measures_pruned_candidates_and_persists(tmp_path):
    key = _key(m=4, k=4096, n=12800)
    cands = tile_candidates(key, "cached_packed")
    assert len(cands) > 1, "shape chosen to leave something to measure"
    winner = cands[-1]
    walls = {tuple(t): 50.0 for t in cands}
    walls[tuple(winner)] = 1.0
    store = PlanStore(str(tmp_path / "s.json"))
    tuner = PlanAutotuner(store, fingerprint="fp", measure=_stub_measure(walls))
    assert tuner.tiles_for(key, "cached_packed") == winner
    assert (tuner.store_hits, tuner.store_misses, tuner.tunes) == (0, 1, 1)
    rec = store.get("fp", plan_key_id(key))
    assert (rec["bm"], rec["bn"], rec["bk"], rec["k_split"]) == winner
    assert rec["source"] == "measured" and rec["candidates"] == len(cands)
    assert rec["kernel"] == "cached_packed" and len(rec["wall_us"]) == len(cands)


@pytest.mark.parametrize("saving, wins", [(0.01, False), (0.029, False), (0.05, True)])
def test_tuner_keeps_the_default_within_the_noise(saving, wins):
    """A candidate replaces the default only when it saves MIN_GAIN of its time."""
    key = _key(m=4, k=4096, n=12800)
    cands = tile_candidates(key, "cached_packed")
    walls = {tuple(t): 100.0 for t in cands}
    walls[tuple(cands[2])] = 100.0 * (1 - saving)
    tiles, detail = PlanAutotuner(None, fingerprint="fp", measure=_stub_measure(walls)).tune(
        key, "cached_packed")
    assert tiles == (cands[2] if wins else cands[0])
    assert detail["wall_us"]["x".join(map(str, cands[2]))] == round(100.0 * (1 - saving), 3)
    assert autotune.MIN_GAIN == 0.03


def test_tuner_warm_store_zero_tunes(tmp_path):
    key = _key()
    path = str(tmp_path / "s.json")
    cold = PlanAutotuner(PlanStore(path), fingerprint="fp", measure=_stub_measure({}))
    tiles = cold.tiles_for(key, "cached_packed")
    warm = PlanAutotuner(PlanStore(path), fingerprint="fp", measure=_stub_measure({}),
                         tune_on_miss=False)
    assert warm.tiles_for(key, "cached_packed") == tiles
    assert (warm.store_hits, warm.store_misses, warm.tunes) == (1, 0, 0)


@pytest.mark.parametrize("bad", [
    {"bm": 4, "bn": 128, "bk": 512, "k_split": 1},   # a row tile the kernels lack
    {"bm": 64, "bn": 128, "bk": 512, "k_split": 1},
    {"bm": 8, "bn": 256, "bk": 512, "k_split": 1},   # another column tile
    {"bm": 8, "bn": 128, "bk": 512, "k_split": 99},  # beyond the 4 K chunks
    {"bm": 8, "bn": 128, "bk": 256, "k_split": 1},   # not the route's K extent
    {"bm": 8, "bn": 128, "bk": 512},                 # no K split
    {"bm": 8, "bn": 128, "bk": 512, "k_split": 1, "kernel": "cached_planes"},
    {"bm": "x", "bn": 128, "bk": 512, "k_split": 1},
])
def test_tuner_rejects_illegal_stored_record(tmp_path, bad):
    """A stale or hand-edited record is a miss (re-tuned), never a launch."""
    key = _key(k=2048)
    store = PlanStore(str(tmp_path / "s.json"))
    store.put("fp", plan_key_id(key), bad)
    tuner = PlanAutotuner(store, fingerprint="fp", tune_on_miss=False)
    assert tuner.tiles_for(key, "cached_packed") is None
    assert (tuner.store_hits, tuner.store_misses) == (0, 1)
    retune = PlanAutotuner(store, fingerprint="fp", measure=_stub_measure({}))
    tiles = retune.tiles_for(key, "cached_packed")
    assert _legal(key, "cached_packed", tiles) and retune.tunes == 1
    assert store.get("fp", plan_key_id(key))["k_split"] == tiles[3]


def test_store_filters_non_dict_records(tmp_path):
    path = tmp_path / "s.json"
    path.write_text(json.dumps({"version": 1, "hosts": {"fp": {"k": "not-a-dict"},
                                                        "fp2": "not-a-dict"}}))
    assert PlanStore(str(path)).get("fp", "k") is None
    assert PlanStore(str(path)).get("fp2", "k") is None


def test_tuner_memoizes_within_process(tmp_path):
    key = _key()
    tuner = PlanAutotuner(PlanStore(str(tmp_path / "s.json")), fingerprint="fp",
                          measure=_stub_measure({}))
    first = tuner.tiles_for(key, "cached_packed")
    assert tuner.tiles_for(key, "cached_packed") == first
    assert tuner.tunes == 1, "second lookup is memoized, not re-tuned"


def test_tuner_refuses_inside_a_capture(monkeypatch):
    """A plan resolved inside a CUDA-graph capture would measure there: raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    tuner = PlanAutotuner(None, fingerprint="fp", hw=HARDWARE_TABLE["h100"],
                          measure=_stub_measure({}))
    with pytest.raises(RuntimeError, match="capture"):
        tuner.tiles_for(_key(), "cached_packed")
    assert tuner.tunes == 0


@pytest.mark.parametrize("size", [1 << 10, 3 << 10, 40 << 10, 100 << 10, 200 << 10])
def test_timer_rotates_over_enough_weight_copies_to_read_cold(size):
    """The copies' bytes read between two reads of one copy exceed twice the
    L2 (capped at MAX_COPIES); a weight of twice the L2 or more is alone."""
    l2 = 50 << 10
    w = torch.arange(size, dtype=torch.int8)
    copies = autotune._cold_copies(w, l2)
    assert copies[0] is w and all(torch.equal(c, w) for c in copies)
    assert len({c.data_ptr() for c in copies}) == len(copies)
    if size >= 2 * l2:
        assert len(copies) == 1
    else:
        assert len(copies) == autotune.MAX_COPIES or (len(copies) - 1) * size >= 2 * l2
        assert (len(copies) - 2) * size < 2 * l2


def test_timer_copies_a_packed_weight_word_for_word():
    from repro_torch.core import bitplanes as bp

    gen = torch.Generator().manual_seed(0)
    w = torch.randint(-8, 8, (256, 64), dtype=torch.int8, generator=gen)
    packed = bp.make_weight_planes(w, w_bits=4, variant="booth", level="bitplane",
                                   store="packed").packed
    copies = autotune._cold_copies(packed, autotune._weight_bytes(packed) * 2)
    assert len(copies) == 5
    for c in copies[1:]:
        assert torch.equal(c.mag, packed.mag) and c.mag.data_ptr() != packed.mag.data_ptr()
        assert torch.equal(c.sign, packed.sign) and c.sign.data_ptr() != packed.sign.data_ptr()
        assert (c.k, c.axis, c.weights, c.block) == (packed.k, packed.axis, packed.weights,
                                                    packed.block)


def test_kernel_timer_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.KernelTimer()(_key(), "cached_packed", (8, 128, 512, 1))


# -- registry integration ----------------------------------------------------


def _resolve(registry, **kw):
    return plan_for_operands(((8, 64), (64, 128)), a_bits=4, w_bits=4, backend="torch",
                             registry=registry, **kw)


def test_registry_uses_tuner_and_marks_provenance(tmp_path):
    registry = PlanRegistry()
    tuner = PlanAutotuner(PlanStore(str(tmp_path / "s.json")), fingerprint="fp")
    registry.attach_tuner(tuner)
    plan = _resolve(registry)
    assert plan.tuned and plan.k_split == 1
    assert " tuned" in plan.describe()
    assert registry.store_stats()["tunes"] == 1
    registry.clear()  # keeps the tuner attached (warm memo)
    assert registry.tuner is tuner
    assert _resolve(registry).tuned


def test_registry_degrades_to_default_tiles_without_tuner_answer(tmp_path):
    registry = PlanRegistry()
    registry.attach_tuner(PlanAutotuner(PlanStore(str(tmp_path / "s.json")),
                                        fingerprint="fp", tune_on_miss=False))
    plan = _resolve(registry)
    assert not plan.tuned and plan.k_split is None
    assert (plan.bm, plan.bn, plan.bk) == ops.hopper_tiles(8, 64, 128, kernel=plan.kernel)
    assert registry.store_stats()["store_misses"] == 1


def test_registry_explicit_tiles_bypass_tuner():
    """Requested tiles always win; the tuner is never consulted."""
    registry = PlanRegistry()

    class Exploding:
        def tiles_for(self, key, kernel):  # pragma: no cover - must not run
            raise AssertionError("tuner consulted despite explicit tiles")

        def stats(self):
            return {"store_hits": 0, "store_misses": 0, "tunes": 0}

    registry.attach_tuner(Exploding())
    plan = _resolve(registry, bm=8)
    assert not plan.tuned and plan.bm == 8


def _last_wave_end(m, n, chunks, tile, sms, split):
    per = -(-chunks // split)
    blocks = -(-n // bytesplit.COLS_PER_BLOCK) * -(-m // tile) * -(-chunks // per)
    return -(-blocks // (bytesplit.BLOCKS_PER_SM * sms)) * per


@pytest.mark.parametrize("m, n, chunks, tile, want", [
    (4, 12800, 8, 8, 6),       # decode: under a wave, split to fill it
    (4, 12800, 32, 8, 6),
    (256, 4096, 8, 32, 3),
    (256, 12800, 8, 32, 4),    # prefill: 800 blocks, a half-empty second wave
    (256, 12800, 32, 32, 3),
    (4, 128256, 32, 8, 1),     # a full grid no split would end sooner
])
def test_default_k_split_fills_the_wave(m, n, chunks, tile, want):
    assert bytesplit.k_split(m, n, chunks, tile, 132) == want


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 2048), n=st.integers(1, 1 << 17), chunks=st.integers(1, 64),
       tile=st.sampled_from(bytesplit.ROW_TILES), sms=st.sampled_from([1, 8, 132]))
def test_default_k_split_never_ends_later_than_one_range(m, n, chunks, tile, sms):
    ks = bytesplit.k_split(m, n, chunks, tile, sms)
    assert 1 <= ks <= chunks
    blocks = -(-n // bytesplit.COLS_PER_BLOCK) * -(-m // tile)
    if blocks >= bytesplit.BLOCKS_PER_SM * sms:
        assert ks <= bytesplit.BLOCKS_PER_SM
        assert _last_wave_end(m, n, chunks, tile, sms, ks) <= \
            _last_wave_end(m, n, chunks, tile, sms, 1)


def test_registry_drops_the_plans_of_a_detached_tuner(tmp_path):
    """A change of tuner drops the old tuner's plans and keeps the default
    ones; attaching the same tuner again keeps everything."""
    registry = PlanRegistry()
    untuned = _resolve(registry, bm=8)
    tuner = PlanAutotuner(PlanStore(str(tmp_path / "s.json")), fingerprint="fp")
    registry.attach_tuner(tuner)
    tuned = _resolve(registry)
    registry.attach_tuner(tuner)
    assert set(registry.plans()) == {untuned, tuned}
    registry.attach_tuner(None)
    assert registry.plans() == (untuned,)
    assert not _resolve(registry).tuned
    assert registry.store_stats() == {"store_hits": 0, "store_misses": 0, "tunes": 0}


def test_registry_without_tuner_reports_zero_counters():
    registry = PlanRegistry()
    assert registry.store_stats() == {"store_hits": 0, "store_misses": 0, "tunes": 0}
    assert not _resolve(registry).tuned


# -- a tuned plan on the routes' executors -----------------------------------


class _Spy:
    """Records the k_split each kernel-wrapper dispatcher receives."""

    def __init__(self, monkeypatch):
        self.seen = []
        for name in ("fused_linear", "plane_matmul_packed", "plane_matmul"):
            orig = getattr(ops, name)

            def wrapped(*a, _orig=orig, _name=name, **kw):
                self.seen.append((_name, kw.get("k_split")))
                return _orig(*a, **{**kw, "backend": "torch"})

            monkeypatch.setattr(ops, name, wrapped)


@pytest.mark.parametrize("packed, fused, epilogue, level", [
    (None, None, True, "bitplane"),   # fused_repack
    (True, False, False, "bitplane"),  # staged_packed
    (False, False, False, "bitplane"),  # staged
    (False, False, False, "digit"),  # staged digits
])
def test_tuned_plan_passes_its_k_split_and_keeps_the_integers(monkeypatch, packed, fused,
                                                              epilogue, level):
    """A plan resolved for the card with a tuner hands its row tile and K
    split to the kernel wrapper, and gives the default plan's output (run
    here through the plain versions, as the wrappers would on host
    tensors)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-8, 8, (5, 600)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-8, 8, (600, 96)).astype(np.int8))
    ep = None
    if epilogue:
        ep = ops.Epilogue(a_scale=torch.full((5, 1), 0.5), w_scale=torch.full((96,), 0.25))
    outs, kernels = [], set()
    for tuned in (False, True):
        registry = PlanRegistry()
        if tuned:
            key_cands = None

            def measure(key, kernel, tiles, repeats=2):
                nonlocal key_cands
                key_cands = key_cands or tile_candidates(key, kernel)
                return 1.0 if tuple(tiles) == tuple(key_cands[-1]) else 50.0

            registry.attach_tuner(PlanAutotuner(None, fingerprint="fp", measure=measure))
        # a key resolved for the card (the executors run here through the
        # plain versions: the spy hands every dispatcher backend="torch")
        key = plan_mod.PlanKey(
            m=5, k=600, n=96, a_bits=4, w_bits=4, a_in_bits=4, w_in_bits=4, variant="booth",
            level=level, mode="fully_serial", backend="cuda", accum="int32",
            has_epilogue=ep is not None, cache=None, fused=fused, packed=packed,
            bm=None, bn=None, bk=None)
        plan = registry.get(key)
        kernels.add(plan.kernel)
        spy = _Spy(monkeypatch)
        outs.append(plan(x, w, epilogue=ep))
        monkeypatch.undo()
        if tuned:
            assert plan.tuned and plan.k_split == key_cands[-1][3] and plan.bm == key_cands[-1][0]
            assert spy.seen and all(ks == plan.k_split for _, ks in spy.seen)
        else:
            assert not plan.tuned and all(ks is None for _, ks in spy.seen)
    assert len(kernels) == 1 and kernels <= set(autotune.ROUTE_KERNELS)
    assert outs[0].dtype == outs[1].dtype
    assert torch.equal(outs[0], outs[1])


def test_wrappers_refuse_a_bad_k_split():
    a = torch.zeros((1, 2, 128), dtype=torch.int8)
    w = torch.zeros((1, 128, 4), dtype=torch.int8)
    pw = torch.ones((1,), dtype=torch.int32)
    from repro_torch.kernels import plane_mm

    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="k_split"):
            plane_mm.plane_matmul(a, w, pw, k_split=bad)
    assert torch.equal(plane_mm.plane_matmul(a, w, pw, k_split=3),
                       plane_mm.plane_matmul(a, w, pw))
