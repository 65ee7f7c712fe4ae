"""Port parity of the SLA autopilot, on the CPU.

Three layers, as the reference's ``tests/test_autopilot.py``:

* the host-only control law (``repro_torch.runtime.autopilot``): patience,
  cooldown, the scrub-storm cap, the KL-budget guard and the shedding
  ladder, the cases that repeat merged into parametrised ones;
* the scheduler's controller signals (queue depth, histories, shed);
* the engine: on reduced granite-3-8b the port's autopilot engine, dense
  and paged, given the same weights, the same overload ramp (2 slots, 8
  requests of 4 tokens arriving as fast as slots exist, 5 new tokens, a
  queue SLA of 6 steps, shadow probes on half the decode steps) and a
  precision-schedule entry due on the decode step of the controller's
  first switch, must give the reference's tokens, request tiers,
  switches, shed set, per-tier token counts and schedule conflicts, and
  its shadow-KL EWMA within ``KL_RTOL`` relative; every finished request must
  equal the port's static run of its admission tier. The deprecated
  ``degrade_after``/``degrade_to`` alias builds the same policy and warns
  once.

The reference's weights are quantized once for both of its engines (its
eager quantization and its compiles per tier are most of this file's
time). The layer stack is the default scanned one: there the port repeats
the reference's compiled rounding bit for bit (``test_torch_serving.py``),
so the probes' logits, and with them the KL, agree.
"""

import contextlib
import warnings

import jax
import numpy as np
import pytest

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import serve as jserve
from repro.models.quant import quantize_params as jquantize_params
from repro.models.transformer import init_params as jinit
from repro.runtime.autopilot import AutopilotPolicy as JAutopilotPolicy
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import LayerPrecision, PrecisionPolicy as TPolicy
from repro_torch.launch import serve
from repro_torch.launch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.autopilot import Autopilot, AutopilotPolicy, OverloadError
from repro_torch.runtime.scheduler import AdmissionError, Request, SlotScheduler

from _torch_parity import to_numpy_tree

ARCH = "granite-3-8b"


def _req(rid, arrival=0, gen=5, deadline=None, plen=4):
    rng = np.random.default_rng(rid)
    return Request(rid=rid, tokens=rng.integers(1, 100, (plen,)), max_new_tokens=gen,
                   arrival_step=arrival, deadline_step=deadline)


# --------------------------------------------------------------------------
# Control law (host only)
# --------------------------------------------------------------------------


def _pol(**kw):
    kw.setdefault("sla_queue_steps", 6)
    kw.setdefault("degrade_patience", 2)
    kw.setdefault("upgrade_patience", 3)
    kw.setdefault("cooldown_steps", 4)
    return AutopilotPolicy(**kw)


@pytest.mark.parametrize("kw, match", [
    (dict(tiers=()), "non-empty"),
    (dict(tiers=((4, 4), (8, 8))), "widest-first"),
    (dict(tiers=((8, 8), (0, 4))), "1..16-bit"),
    (dict(tiers=((17, 17),)), "1..16-bit"),
    (dict(shadow_frac=1.5), "shadow_frac"),
    (dict(ewma_alpha=0.0), "ewma_alpha"),
    (dict(degrade_patience=0), "patience"),
    (dict(upgrade_patience=0), "patience"),
    (dict(cooldown_steps=-1), "cooldown"),
])
def test_policy_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        AutopilotPolicy(**kw)


def test_overload_error_is_admission_error():
    assert issubclass(OverloadError, AdmissionError)


@pytest.mark.parametrize("patience, depths, switch_at", [
    (2, [5, 5], 1),  # one pressured step is noise; the second switches
    (3, [5, 5, 1, 5, 5, 5], 5),  # a quiet step restarts the run
])
def test_descent_needs_sustained_pressure(patience, depths, switch_at):
    ap = Autopilot(_pol(degrade_patience=patience), n_slots=2)
    for step, depth in enumerate(depths):
        d = ap.observe(step, queue_depth=depth)
        assert d.switched == (step == switch_at), step
    assert ap.tier == (6, 6) and "queue depth" in d.reason


def test_cooldown_blocks_back_to_back_switches():
    ap = Autopilot(_pol(cooldown_steps=5), n_slots=2)
    ap.observe(0, queue_depth=5)
    assert ap.observe(1, queue_depth=5).switched  # -> (6,6) at step 1
    for step in range(2, 6):  # still inside the refractory window
        assert not ap.observe(step, queue_depth=5).switched
    assert ap.observe(6, queue_depth=5).switched  # window over -> (4,4)
    assert ap.tier == (4, 4)


def test_upgrade_is_stepwise_and_slower():
    ap = Autopilot(_pol(cooldown_steps=0), n_slots=2)
    for step in range(4):
        ap.observe(step, queue_depth=5)
    assert ap.tier == (4, 4)
    assert not ap.observe(4, queue_depth=0).switched
    assert not ap.observe(5, queue_depth=0).switched
    d = ap.observe(6, queue_depth=0)
    assert d.switched and ap.tier == (6, 6) and "headroom" in d.reason


def test_alternating_signals_never_flap():
    ap = Autopilot(_pol(), n_slots=2)
    for step in range(40):
        ap.observe(step, queue_depth=5 if step % 2 == 0 else 0)
    assert ap.switches == [] and ap.tier == (8, 8)


def test_shed_only_past_lowest_tier():
    ap = Autopilot(_pol(cooldown_steps=0), n_slots=2)
    for step in range(10):
        d = ap.observe(step, queue_depth=5)
        assert not (d.shed_active and ap.tier != (4, 4))
        if d.shed_active:
            break
    assert ap.shedding and ap.tier == (4, 4) and "lowest tier" in d.reason


def test_recovery_lifts_shedding_before_climbing():
    ap = Autopilot(_pol(cooldown_steps=0, upgrade_patience=2), n_slots=2)
    for step in range(8):
        ap.observe(step, queue_depth=5)
    assert ap.shedding
    ap.observe(8, queue_depth=0)
    d = ap.observe(9, queue_depth=0)
    assert not ap.shedding and not d.switched and "shedding lifted" in d.reason
    ap.observe(10, queue_depth=0)
    d = ap.observe(11, queue_depth=0)
    assert d.switched and ap.tier == (6, 6)


def test_scrub_storm_degrades_immediately_and_caps_recovery():
    ap = Autopilot(_pol(scrub_degrade_after=3, scrub_degrade_to=4, cooldown_steps=0,
                        upgrade_patience=1), n_slots=2)
    d = ap.observe(0, queue_depth=0, scrubs=3)
    assert d.switched and ap.tier == (4, 4) and "scrub storm" in d.reason
    for step in range(1, 6):
        assert not ap.observe(step, queue_depth=0, scrubs=3).switched
    assert ap.tier == (4, 4)


def test_kl_budget_blocks_descent_and_escalates_to_shedding():
    ap = Autopilot(_pol(kl_budget=0.1, cooldown_steps=0), n_slots=2)
    ap.observe(0, queue_depth=5)
    ap.observe(1, queue_depth=5)
    assert ap.tier == (6, 6)
    ap.observe(2, queue_depth=5, shadow_kl=0.5)
    d = ap.observe(3, queue_depth=5, shadow_kl=0.5)
    assert not d.switched and ap.tier == (6, 6)
    assert d.shed_active and "quality budget" in d.reason


def test_latency_signal():
    ap = Autopilot(_pol(sla_ms=10.0), n_slots=2)
    ap.observe(0, queue_depth=0, step_latency_s=5.0, tokens_emitted=0)
    assert ap.latency_ewma_ms is None  # a step that emitted nothing is skipped
    ap.observe(1, queue_depth=0, step_latency_s=0.004, tokens_emitted=2)
    assert ap.latency_ewma_ms == pytest.approx(2.0)
    ap = Autopilot(_pol(sla_ms=1.0, depth_high=10_000), n_slots=2)
    ap.observe(0, queue_depth=0, step_latency_s=0.01, tokens_emitted=1)
    d = ap.observe(1, queue_depth=0, step_latency_s=0.01, tokens_emitted=1)
    assert d.switched and "latency over SLA" in d.reason


def test_force_snaps_to_ladder_rung():
    ap = Autopilot(_pol(), n_slots=2)
    assert ap.force(0, (6, 6)).switched and ap.tier == (6, 6)
    assert ap.force(1, (5, 5)).switched and ap.tier == (4, 4)
    assert not ap.force(2, (4, 4)).switched


@pytest.mark.parametrize("sla, n_slots, waiting, step, est, want", [
    # already waited 2; predicted = 2 + (pos//2 + 1)*4: positions 0 and 1
    # keep, the tail is shed (survivors keep their queue position)
    (6, 2, [dict(rid=i) for i in range(6)], 2, 4, [2, 3, 4, 5]),
    # the tighter of the SLA and the deadline's headroom
    (100, 1, [dict(rid=0, deadline=4), dict(rid=1, deadline=50)], 2, 3, [0]),
])
def test_shed_victims(sla, n_slots, waiting, step, est, want):
    ap = Autopilot(_pol(sla_queue_steps=sla), n_slots=n_slots)
    reqs = [_req(w["rid"], arrival=0, deadline=w.get("deadline")) for w in waiting]
    assert ap.shed_victims(reqs, step=step, service_estimate=est) == want
    with pytest.raises(ValueError, match="service_estimate"):
        ap.shed_victims([], step=0, service_estimate=0)


@pytest.mark.parametrize("case", ["alias_ignores_queue", "alias_scrub_rule"])
def test_alias_policy_is_a_pure_scrub_rule(case):
    ap = Autopilot(serve._degrade_alias_policy(5, 4), n_slots=2)
    if case == "alias_ignores_queue":
        for step in range(20):
            assert not ap.observe(step, queue_depth=100).switched
    assert ap.observe(20, queue_depth=0, scrubs=5).switched and ap.tier == (4, 4)


# --------------------------------------------------------------------------
# Scheduler signals
# --------------------------------------------------------------------------


def test_queue_depth_counts_only_arrived_requests():
    sched = SlotScheduler(n_slots=2)
    for rid, arrival in ((0, 0), (1, 0), (2, 9)):
        sched.submit(_req(rid, arrival=arrival))
    assert sched.queue_depth(0) == 2 and [r.rid for r in sched.waiting(0)] == [0, 1]
    assert sched.queue_depth(9) == 3


def test_observe_step_histories_and_queue_waits():
    sched = SlotScheduler(n_slots=2)
    sched.submit(_req(0, arrival=1))
    sched.observe_step(0, 0.25)
    sched.observe_step(1)
    s = sched.stats()
    assert s.depth_history == (0, 1)
    assert s.latency_history[0] == 0.25 and np.isnan(s.latency_history[1])
    sched = SlotScheduler(n_slots=1)
    sched.submit(_req(0, arrival=0))
    sched.submit(_req(1, arrival=0))
    for slot, req in sched.admissible(3):
        sched.start(slot, req, 7)
    assert sched.stats().queue_waits == (3,)


def test_shed_is_typed_counted_and_pending_only():
    sched = SlotScheduler(n_slots=1)
    sched.submit(_req(0))
    sched.submit(_req(1))
    for slot, req in sched.admissible(0):
        sched.start(slot, req, 7)
    sched.shed(1, "overload: shed from queue tail at step 0")
    s = sched.stats()
    assert s.shed == 1 and s.failed == 1 and sched.failed[1].startswith("overload:")
    assert sched.pending_rids == []
    with pytest.raises(KeyError):
        sched.shed(0, "active requests are never shed")


def test_signals_track_requeue_and_quarantine():
    sched = SlotScheduler(n_slots=2)
    for i in range(3):
        sched.submit(_req(i))
    for slot, req in sched.admissible(0):
        sched.start(slot, req, 7)
    assert sched.queue_depth(0) == 1
    sched.requeue(0, arrival_step=2)
    sched.quarantine(0)
    assert sched.queue_depth(1) == 1 and sched.queue_depth(2) == 2
    assert [r.rid for r in sched.waiting(2)] == [2, 0]
    sched.shed(0, "overload: shed retried request")
    assert sched.stats().shed == 1 and sched.queue_depth(2) == 1
    assert all(slot != 0 for slot, _ in sched.admissible(2))


def test_storage_width_and_vacuous_truncation_audit():
    assert TPolicy.uniform(8, 8).storage_width() == 8
    assert TPolicy.off().storage_width() is None
    mixed = TPolicy(default=LayerPrecision(4, 4),
                    overrides=(("lm_head", LayerPrecision(8, 8)),))
    assert mixed.storage_width() == 8
    audit = plan_mod.truncation_audit(plan_mod.PlanRegistry())
    assert audit["dialed_plans"] == 0 and audit["truncated_ok"] is False


def test_runtime_package_exports_autopilot():
    import repro_torch.runtime as rt

    for name in ("Autopilot", "AutopilotPolicy", "AutopilotDecision", "OverloadError",
                 "retry_step", "StragglerDetector", "SlotScheduler"):
        assert name in rt.__all__ and hasattr(rt, name)


# --------------------------------------------------------------------------
# The engine against the reference's
# --------------------------------------------------------------------------

N_SLOTS, PLEN, GEN, N_REQ, SLA = 2, 4, 5, 8, 6
AP_KW = dict(sla_queue_steps=SLA, degrade_patience=2, upgrade_patience=4,
             cooldown_steps=2, shadow_frac=0.5)
LAYOUTS = {"dense": dict(max_len=12), "paged": dict(max_len=12, page_size=4)}
# the probes' logits are bit-equal and the KL sums in the reference's order
# (``serve._row_sum``), but the reference's compiled float32 ``log`` and
# ``exp`` are not correctly rounded: one ulp of one row's log-sum-exp moved
# one probe of the uneven workload by 2.9e-6 and the EWMA by 1.6e-6 (the
# ramp's EWMA agrees within 1e-7)
KL_RTOL = 1e-5
# the reference's ramp (every request 5 new tokens: slots admitted together
# finish together), and the same ramp with uneven lengths, whose slots fall
# out of step, so requests of different tiers decode side by side
WORKLOADS = {"ramp": (GEN,) * N_REQ, "uneven": (5, 3, 7, 4, 6, 8, 3, 5)}

_S: dict = {}


def _setup():
    """The carried parameters and the reference's quantized tree, built once
    (its eager quantization is the reference engine's load time)."""
    if not _S:
        jc, tc = jget(ARCH), tget(ARCH)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        tp = params_from_numpy(tc, to_numpy_tree(jp), device="cpu")
        jq = jquantize_params(jp, JPolicy.uniform(8, 8, variant="booth", level="bitplane"),
                              plane_cache=True)
        _S.update(jc=jc, tc=tc, jp=jp, tp=tp, jq=jq)
    return _S


@contextlib.contextmanager
def _quantized_once(tree):
    """The reference's engines take the one quantized tree instead of
    quantizing at construction."""
    orig = jserve.quantize_params
    jserve.quantize_params = lambda *a, **k: tree
    try:
        yield
    finally:
        jserve.quantize_params = orig


def _burst(cls, cfg, gens=WORKLOADS["ramp"]):
    rng = np.random.default_rng(0)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (PLEN,)), max_new_tokens=g,
                arrival_step=i // N_SLOTS) for i, g in enumerate(gens)]


def _overload(layout, workload):
    """The port's and the reference's autopilot runs of a workload, with a
    schedule entry due on the controller's first switch, and the port's
    static runs at every tier the autopilot admitted at."""
    key = (layout, workload)
    if key in _S.get("runs", {}):
        return _S["runs"][key]
    st = _setup()
    gens = WORKLOADS[workload]
    policy = TPolicy.uniform(8, 8, variant="booth", level="bitplane")
    kw = dict(n_slots=N_SLOTS, **LAYOUTS[layout])
    engines = _S.setdefault("engines", {})
    if layout not in engines:
        te = TEngine(st["tc"], st["tp"], policy, autopilot=AutopilotPolicy(**AP_KW),
                     device="cpu", **kw)
        with _quantized_once(st["jq"]):
            je = jserve.ContinuousBatchingEngine(
                st["jc"], st["jp"], JPolicy.uniform(8, 8, variant="booth", level="bitplane"),
                autopilot=JAutopilotPolicy(**AP_KW), **kw)
        engines[layout] = (te, je, TEngine(st["tc"], st["tp"], policy, device="cpu", **kw))
    te, je, static = engines[layout]
    _, dry = te.run(_burst(Request, st["tc"], gens))
    first = dry["autopilot"]["switches"][0][0]
    schedule = {first: 6}
    t_res, t_stats = te.run(_burst(Request, st["tc"], gens), precision_schedule=dict(schedule))
    j_res, j_stats = je.run(_burst(JRequest, st["jc"], gens), precision_schedule=dict(schedule))
    static_runs = {}
    for name in sorted(set(t_stats["autopilot"]["request_tiers"].values())):
        w = int(name.split("a")[0][1:])
        static.set_precision(None if w == 8 else w)
        static_runs[name] = static.run(_burst(Request, st["tc"], gens))
    _S.setdefault("runs", {})[key] = (t_res, t_stats, j_res, j_stats, static_runs)
    return _S["runs"][key]


CASES = [(lay, wl) for lay in LAYOUTS for wl in WORKLOADS]


@pytest.mark.parametrize("layout, workload", CASES)
def test_autopilot_engine_equals_reference(layout, workload):
    t_res, t_stats, j_res, j_stats, _ = _overload(layout, workload)
    ta, ja = t_stats["autopilot"], j_stats["autopilot"]
    assert sorted(t_res) == sorted(j_res)
    for rid in j_res:
        np.testing.assert_array_equal(t_res[rid], np.asarray(j_res[rid]), err_msg=f"rid {rid}")
    for key in ("tiers", "final_tier", "shed", "request_tiers", "tier_tokens",
                "schedule_conflicts", "depth_history", "shadow_probes"):
        assert ta[key] == ja[key], key
    assert [(s, tuple(t), why) for s, t, why in ta["switches"]] == \
        [(s, tuple(t), why) for s, t, why in ja["switches"]]
    assert t_stats["failed"] == j_stats["failed"]
    assert t_stats["precision_switches"] == j_stats["precision_switches"]
    assert ta["p99_queue_steps"] == ja["p99_queue_steps"]
    assert ta["shadow_kl_ewma"] == pytest.approx(ja["shadow_kl_ewma"], rel=KL_RTOL)
    # the run exercised what it claims to: mixed tiers, shedding at the
    # lowest tier, a consumed schedule entry and the probe
    assert len(set(ta["request_tiers"].values())) >= 2 and len(ta["tier_tokens"]) >= 2
    if workload == "uneven":
        assert ta["mixed_steps"] > 0
    lowest = min(w for _, w in ta["tiers"])
    shed = [r for r in t_stats["failed"].values() if r.startswith("overload:")]
    assert len(shed) == ta["shed"] > 0 and all(f"tier w{lowest}" in r for r in shed)
    assert len(ta["schedule_conflicts"]) == 1 and ta["shadow_probes"] > 0


@pytest.mark.parametrize("layout, workload", CASES)
def test_mixed_tier_requests_equal_their_static_tier(layout, workload):
    t_res, t_stats, _, _, static_runs = _overload(layout, workload)
    tiers = t_stats["autopilot"]["request_tiers"]
    for rid, toks in t_res.items():
        np.testing.assert_array_equal(toks, static_runs[tiers[rid]][0][rid],
                                      err_msg=f"rid {rid} (tier {tiers[rid]})")
    static8 = static_runs["w8a8"][1]
    assert static8["p99_queue_steps"] > SLA >= t_stats["autopilot"]["p99_queue_steps"]


def test_schedule_race_is_deterministic_and_consumed():
    """The controller switching on the first pressured step (patience 1, no
    cooldown) wins against a schedule entry due that decode step: the entry
    is consumed and recorded, never forces a later switch, and a rerun is
    identical step for step."""
    st = _setup()
    engine = TEngine(st["tc"], st["tp"], TPolicy.uniform(8, 8, level="bitplane"),
                     autopilot=AutopilotPolicy(sla_queue_steps=SLA, degrade_patience=1,
                                               upgrade_patience=8, cooldown_steps=0),
                     n_slots=N_SLOTS, max_len=PLEN + GEN, device="cpu")
    _, dry = engine.run(_burst(Request, st["tc"]))
    first = dry["autopilot"]["switches"][0][0]
    runs = [engine.run(_burst(Request, st["tc"]), precision_schedule={first: 6})
            for _ in range(2)]
    (res_a, st_a), (res_b, st_b) = runs
    apst = st_a["autopilot"]
    assert apst["schedule_conflicts"] == [(first, first, 6)]
    assert not any("scheduled switch" in why for _, _, why in apst["switches"])
    assert apst["switches"] == st_b["autopilot"]["switches"]
    for rid in res_a:
        np.testing.assert_array_equal(res_a[rid], res_b[rid])


def test_degrade_alias_builds_the_policy_and_warns_once():
    st = _setup()
    policy = TPolicy.uniform(8, 8, level="bitplane")
    kw = dict(n_slots=N_SLOTS, max_len=PLEN + GEN, device="cpu")
    serve._DEGRADE_ALIAS_WARNED = False
    with pytest.warns(DeprecationWarning, match="degrade_after/degrade_to"):
        eng = TEngine(st["tc"], {}, policy, degrade_after=3, degrade_to=4, **kw)
    expected = TEngine(st["tc"], {}, policy, autopilot=AutopilotPolicy(
        scrub_degrade_after=3, scrub_degrade_to=4, shed=False), **kw)
    assert eng.autopilot_policy == expected.autopilot_policy
    assert eng.autopilot_policy.shed is False and eng._tiers == expected._tiers
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TEngine(st["tc"], {}, policy, degrade_after=3, degrade_to=4, **kw)
    with pytest.raises(ValueError, match="not both"):
        TEngine(st["tc"], {}, policy, degrade_after=3, autopilot=AutopilotPolicy(), **kw)
    with pytest.raises(ValueError, match="active quantization policy"):
        TEngine(st["tc"], {}, TPolicy.off(), autopilot=AutopilotPolicy(), **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_select_merges_per_slot_and_page_in_place(paged):
    """``cache.select_slots`` / ``paging.select_paged``: slot leaves take the
    second cache's row where the slot mask is set, pool leaves the page
    where the page mask is set; with ``out`` the result is written into the
    given cache's leaves (no new tensor) and equals the functional one."""
    import torch

    from repro_torch.models import paging
    from repro_torch.models.cache import init_cache, select_slots

    cfg = tget(ARCH)
    gen = torch.Generator()
    gen.manual_seed(4)

    def filled():
        c = (paging.paged_init_cache(cfg, 3, 8, 4, 7) if paged
             else init_cache(cfg, 3, 8, kv_quant=True))
        for leaf in [c["step"]] + [v for blk in c["layers"] for v in blk.values()]:
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen).to(leaf.dtype))
        return c

    a, b = filled(), filled()
    slots = torch.tensor([True, False, True])
    pages = torch.tensor([False, True, True, False, False, True, False])
    if paged:
        want = paging.select_paged(a, b, slots, pages)
        got = paging.select_paged(a, b, slots.numpy(), pages.numpy().tolist(), out=a)
    else:
        want = select_slots(a, b, slots)
        got = select_slots(a, b, slots.numpy(), out=a)
    assert got is a
    for key, m in (("step", slots),):
        assert torch.equal(want[key], torch.where(m, b[key], want[key]))
    for wblk, gblk, bblk in zip(want["layers"], got["layers"], b["layers"]):
        for key in wblk:
            assert torch.equal(wblk[key], gblk[key]), key
            mask = pages if paged and key in paging._POOL_KEYS else slots
            for i, take in enumerate(mask.tolist()):
                if take:
                    assert torch.equal(gblk[key][i], bblk[key][i]), (key, i)
