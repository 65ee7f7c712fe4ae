"""Port parity of detect-mode integrity: ABFT-checked plans, fingerprints,
KV slot checksums and the continuous-batching engine's integrity counts.

Tolerance: bit-equal throughout. Checked routes give the reference's int32
accumulators and the same alarm flags (clean, and on a corrupted
accumulator, with int32 wraparound on both sides of the row-sum identity);
``tree_checksum``/``bit_fold`` and ``cache_slot_checksums`` give the
reference's uint32 values on the same trees; on reduced granite-3-8b the
port's engine in ``integrity="detect"`` emits the reference engine's
greedy tokens and the same ``stats["integrity"]`` counts, clean and with
one weight bit flipped in the same packed word on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core import integrity as jinteg
from repro.core import plan as jplan
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.models.cache import cache_slot_checksums as jslot_checksums
from repro.models.cache import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core import bitplanes as tbp
from repro_torch.core import integrity as tinteg
from repro_torch.core import plan as tplan
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import serve
from repro_torch.launch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.models.cache import cache_slot_checksums as tslot_checksums
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import j2t, t2n, to_numpy_tree, weight_planes_to_jax

CPU = torch.device("cpu")
COUNT_KEYS = ("audits", "audit_alarms", "abft_checks", "abft_alarms", "kv_checks", "kv_alarms")


def _checked_jax(plan, x, w, wp):
    """The reference plan's output and alarm vector from one compiled call."""
    col = jinteg.Collector()

    def run(x, w, wp):
        with col.collect():
            out = plan(x, w, w_planes=wp)
            return out, col.stacked()

    return jax.jit(run)(x, w, wp)


def _checked_torch(plan, x, w, wp):
    col = tinteg.Collector()
    with col.collect():
        out = plan(x, w, w_planes=wp)
        return out, col.stacked()


@pytest.mark.parametrize("variant,dial", [("booth", None), ("booth", (4, 4)), ("sbmwc", (6, 8))])
def test_checked_routes_equal_reference(variant, dial, rng):
    """Every route a checked plan can take — the host routes the key
    resolves to and the kernel routes' executors on their plain versions —
    gives the reference's raw int32 accumulator and a clean flag."""
    m, k, n = 5, 96, 12
    x = rng.integers(-128, 128, (1, m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    wt = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant=variant,
                                level="bitplane", checksum=True)
    wj = weight_planes_to_jax(wt)
    xt, wtq = torch.from_numpy(x), torch.from_numpy(w)
    for cached in (True, False):
        kw = dict(a_bits=8, w_bits=8, variant=variant, level="bitplane", integrity="detect")
        jp = jplan.plan_for_operands(((1, m, k), (k, n)), backend="jnp",
                                     w_planes=wj if cached else None,
                                     registry=jplan.PlanRegistry(), **kw)
        tp = tplan.plan_for_operands(((1, m, k), (k, n)), backend="torch", device=CPU,
                                     w_planes=wt if cached else None,
                                     registry=tplan.PlanRegistry(), **kw)
        if dial:
            jp, tp = jp.with_precision(*dial), tp.with_precision(*dial)
        assert jp.kernel == tp.kernel and jp.check and tp.check
        want, flags_j = _checked_jax(jp, jnp.asarray(x), jnp.asarray(w), wj if cached else None)
        assert np.asarray(flags_j).tolist() == [False]
        routes = ["cached_scan", "cached_packed", "cached_planes"] if cached else [
            "oracle", "staged", "staged_packed"]
        for route in routes:
            shifted = tp.w_shift > 0
            plan = dataclasses.replace(
                tp, kernel=route,
                requant_w=shifted and route in ("staged", "staged_packed", "oracle"),
                trunc_cache=shifted and route.startswith("cached"),
            )
            got, flags_t = _checked_torch(plan, xt, wtq, wt if cached else None)
            np.testing.assert_array_equal(np.asarray(want), t2n(got), err_msg=route)
            assert flags_t.tolist() == [False], route


def test_abft_check_flag_agrees_on_clean_and_corrupted_accumulator(rng):
    """The row-sum identity with both sides past int32: the reference
    wraps in int32, the port masks int64 sums to 32 bits — the same flag,
    False on the exact accumulator and True after one corrupted entry."""
    m, k, n = 4, 96, 6
    x = rng.integers(-128, 128, (m, k)).astype(np.int32)
    w = rng.integers(-(2**20), 2**20, (k, n)).astype(np.int64)
    wrap = lambda a: ((a + 2**31) % 2**32 - 2**31).astype(np.int32)  # noqa: E731
    out = wrap(x.astype(np.int64) @ w)
    cv = wrap(w.sum(axis=-1))
    assert np.abs(x.astype(np.int64) @ w.sum(axis=-1)).max() > 2**31  # both sides wrap
    jp = jplan.plan_for_operands((m, k, n), a_bits=8, w_bits=8, level="bitplane",
                                 backend="jnp", integrity="detect", registry=jplan.PlanRegistry())
    tp = tplan.plan_for_operands((m, k, n), a_bits=8, w_bits=8, level="bitplane",
                                 backend="torch", device=CPU, integrity="detect",
                                 registry=tplan.PlanRegistry())
    bad = out.copy()
    bad[2, 3] += 1
    for acc, want in ((out, False), (bad, True)):
        cj, ct = jinteg.Collector(), tinteg.Collector()
        with cj.collect():
            jplan._abft_check(jp, jnp.asarray(x), jnp.asarray(acc), jnp.asarray(cv))
        with ct.collect():
            tplan._abft_check(tp, torch.from_numpy(x), torch.from_numpy(acc),
                              torch.from_numpy(cv))
        assert bool(cj.flags[0]) is bool(ct.flags[0]) is want
    # without a collector a flag is read and tallied under the plan's key
    tinteg.reset_tally()
    for acc in (out, bad):
        tplan._abft_check(tp, torch.from_numpy(x), torch.from_numpy(acc), torch.from_numpy(cv))
    assert tinteg.stats_for(tp.key) == {"checks": 2, "alarms": 1}
    assert tinteg.all_stats() == {tp.key: {"checks": 2, "alarms": 1}}
    tinteg.reset_tally()


def test_tree_checksum_and_bit_fold_equal_reference(rng):
    """Fingerprints of the same tree — int8/int32/float32/bf16 leaves and a
    checksummed plane cache — and the single-flip property."""
    w = rng.integers(-128, 128, (70, 5)).astype(np.int32)
    wt = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant="booth",
                                level="bitplane", checksum=True)
    wj = weight_planes_to_jax(wt)
    arrays = {
        "i8": rng.integers(-128, 128, (3, 7)).astype(np.int8),
        "i32": rng.integers(-(2**31), 2**31, (5,)).astype(np.int32),
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((6,)), jnp.bfloat16)),
    }
    tree_j = {"a": {k: jnp.asarray(v) for k, v in arrays.items()}, "wp": wj}
    tree_t = {"a": {k: j2t(v) for k, v in arrays.items()}, "wp": wt}
    assert int(jinteg.tree_checksum(tree_j)) == int(tinteg.tree_checksum(tree_t))
    for k, v in arrays.items():
        assert int(jinteg.bit_fold(jnp.asarray(v))) == int(tinteg.bit_fold(j2t(v))), k
    base = int(tinteg.bit_fold(j2t(arrays["i32"])))
    for bit in range(32):
        flipped = arrays["i32"].copy()
        flipped[2] ^= np.int32(np.uint32(1 << bit).view(np.int32))
        assert int(tinteg.bit_fold(torch.from_numpy(flipped))) != base, bit


def test_cache_slot_checksums_equal_reference(rng):
    """Per-slot folds of the same int8 KV cache contents; one flipped bit
    in slot 1 moves slot 1's fold and no other."""
    cfg = jget("granite-3-8b")
    cache_j = jinit_cache(cfg, 3, 8, kv_quant=True)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return rng.standard_normal(a.shape).astype(np.float32)
        info = np.iinfo(a.dtype)
        return rng.integers(info.min, info.max, a.shape, endpoint=True).astype(a.dtype)

    cache_np = jax.tree_util.tree_map(fill, cache_j)
    stack = cache_np["periods"]["b0_dense"]
    cache_t = {
        "step": torch.from_numpy(cache_np["step"].copy()),
        "layers": [{key: torch.from_numpy(leaf[i].copy()) for key, leaf in stack.items()}
                   for i in range(cfg.n_layers)],
    }
    want = np.asarray(jslot_checksums(jax.tree_util.tree_map(jnp.asarray, cache_np)))
    got = t2n(tslot_checksums(cache_t))
    np.testing.assert_array_equal(want.astype(np.int64), got)
    cache_t["layers"][1]["k_q"][1, 3, 0, 5] ^= 16
    moved = t2n(tslot_checksums(cache_t)) != got
    assert moved.tolist() == [False, True, False]


# ---------------------------------------------------------------------------
# The engine in detect mode
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 9)
GEN = 4


def test_detect_engine_tokens_and_counts_equal_reference():
    """Two requests, the second admitted mid-flight, through 2 slots:
    clean, then with bit 0 of one
    packed word of layer 0's gate projection flipped (and the raw plane
    value it holds, which the host route reads) on both sides. The audit
    and the ABFT check both alarm, and every count equals the reference's."""
    arch = "granite-3-8b"
    jc, tc = jget(arch), tget(arch)
    jp = jax.jit(lambda key: jinit(jc, key))(jax.random.PRNGKey(0))
    tp = params_from_numpy(tc, to_numpy_tree(jp), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, (s,)) for s in PROMPT_LENS]
    pol = dict(level="bitplane", integrity="detect")
    je = JEngine(jc, jp, JPolicy.uniform(8, 8, **pol), n_slots=2, max_len=24)
    te = TEngine(tc, tp, TPolicy.uniform(8, 8, **pol), n_slots=2, max_len=24, device="cpu")

    def serve_both():
        rj, sj = je.run([JRequest(rid=i, tokens=p, max_new_tokens=GEN, arrival_step=2 * i)
                         for i, p in enumerate(prompts)])
        rt, st = te.run([TRequest(rid=i, tokens=p, max_new_tokens=GEN, arrival_step=2 * i)
                         for i, p in enumerate(prompts)])
        assert sorted(rj) == sorted(rt) == list(range(len(PROMPT_LENS)))
        for rid in rj:
            np.testing.assert_array_equal(rj[rid], rt[rid], err_msg=f"rid {rid}")
        ij, it = sj["integrity"], st["integrity"]
        assert {k: ij[k] for k in COUNT_KEYS} == {k: it[k] for k in COUNT_KEYS}
        return it

    clean = serve_both()
    assert clean["abft_checks"] > 0 and clean["audits"] > 0 and clean["kv_checks"] > 0
    assert clean["abft_alarms"] == clean["audit_alarms"] == clean["kv_alarms"] == 0

    # the same flip on both sides: bit 0 of word 0 holds K index 0 in either
    # layout; pick a plane and column whose value there is 0, so it becomes 1
    jwp = je.q_params["periods"]["b0_dense"]["mlp"]["gate_proj"]["w_planes"]
    twp = te.q_params["layers"][0]["mlp"]["gate_proj"]["w_planes"]
    planes0 = np.asarray(jwp.planes[0])
    plane, col = map(int, np.argwhere(planes0[:, 0, :] == 0)[0])
    assert t2n(twp.planes)[plane, 0, col] == 0
    jmag = jwp.packed.mag.at[0, plane, 0, col].set(jwp.packed.mag[0, plane, 0, col] ^ 1)
    jpl = jwp.planes.at[0, plane, 0, col].set(1)
    je.q_params["periods"]["b0_dense"]["mlp"]["gate_proj"]["w_planes"] = dataclasses.replace(
        jwp, packed=dataclasses.replace(jwp.packed, mag=jmag), planes=jpl)
    twp.packed.mag[plane, 0, col] ^= 1
    twp.planes[plane, 0, col] = 1
    flipped = serve_both()
    assert flipped["audit_alarms"] >= 1 and flipped["abft_alarms"] >= 1
    assert flipped["kv_alarms"] == 0


def test_scrub_is_accepted_and_other_flags_still_validated(capsys):
    """The engine and the CLI accept integrity='scrub' (scrub-and-retry
    recovery); the CLI still refuses what the reference refuses."""
    tc = tget("granite-3-8b")
    eng = TEngine(tc, {}, TPolicy.uniform(8, 8, level="bitplane", integrity="scrub"),
                  device="cpu")
    assert eng.integrity == "scrub" and eng.max_retries == 2 and eng.quarantine_after == 2
    serve.main(["--reduced", "--device", "cpu", "--integrity", "scrub", "--level", "bitplane",
                "--n-slots", "2", "--prompt-lens", "4,8", "--gen", "3",
                "--inject-faults", "scale@1;seed=3"])
    out = capsys.readouterr().out
    assert "integrity=scrub" in out and "1 scrubs" in out and "1 detected" in out
    for argv, match in ((["--integrity", "detect", "--level", "digit"], "--level bitplane"),
                        (["--integrity", "detect", "--bits", "0"], "--bits > 0"),
                        (["--audit-interval", "-1"], "audit-interval"),
                        (["--inject-faults", "warp@2"], "unknown fault site")):
        with pytest.raises(SystemExit, match=match):
            serve.main(["--reduced", "--device", "cpu", *argv])
