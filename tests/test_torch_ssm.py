"""Port parity of the attention-free Mamba2 stack (reduced mamba2-1.3b),
held against the JAX reference on the CPU.

* The layer functions (``_causal_conv``, ``ssd_chunked`` over several
  chunks and at L = chunk, ``ssm_apply`` prefill and the recurrent decode
  step, in place) on inputs from a numpy seed. Their bf16 outputs are
  bit-equal; their float32 values (the SSD output, the recurrent state)
  agree within 4e-6 relative to the state's magnitude: the reference's
  compiled ``exp``, ``log1p`` and ``sigmoid`` are not correctly rounded,
  so its float32 operators differ from any other implementation by an
  ulp here and there, and the port repeats only its FMA contractions.
* ``forward`` (scanned and unrolled): quantized logits bit-equal, the
  unquantized forward within 4 bf16 steps; prefill into a cache and 6
  decode steps: logits within 1e-5 (the state's ulps, above), tokens
  equal.
* The continuous-batching engine at bitplane with an 8 -> 4 switch, at
  digit, ``--no-fused``, detect (scanned: one folded ABFT check per step;
  unrolled: one per projection), with compacted planes and under the SLA
  autopilot: tokens and ``stats()`` equal. With
  random weights reduced mamba2 emits one token over and over, so the
  logits above carry the weight of the comparison.
* The lockstep ``Engine``, and the quantized leaves: the projections, not
  ``conv_w``, ``A_log``, ``D`` or ``dt_bias``.
* The decode step the card captures as a CUDA graph: on the card's routes
  (kernels stubbed) it reads nothing back and keeps every state leaf at
  its address; a runner that replays like a graph gives the eager tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import serve as jserve
from repro.layers import ssm as jssm
from repro.models.cache import init_cache as jinit_cache
from repro.models.quant import quantize_params as jquantize_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro.runtime.autopilot import AutopilotPolicy as JAutopilotPolicy
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import serve
from repro_torch.layers import ssm as tssm
from repro_torch.models.cache import init_cache as tinit_cache
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import forward as tforward
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.autopilot import AutopilotPolicy as TAutopilotPolicy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import (
    StubRunner,
    Watch,
    j2t,
    j2t_tree,
    quantized_paths,
    quantized_to_jax,
    reference_quantizes_to,
    stub_kernels,
    t2n,
    to_numpy_tree,
)

ARCH = "mamba2-1.3b"
# float32 values of the SSD and the recurrent state, relative to the
# largest magnitude of the compared tensor (module docstring)
STATE_RTOL = 4e-6

_S: dict = {}


def _params(scan: bool):
    if scan not in _S:
        jc = dataclasses.replace(jget(ARCH), scan_layers=scan)
        tc = dataclasses.replace(tget(ARCH), scan_layers=scan)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        _S[scan] = (jc, tc, jp, params_from_numpy(tc, to_numpy_tree(jp), device="cpu"))
    return _S[scan]


def _close(want, got, rtol=STATE_RTOL):
    want = np.asarray(want, dtype=np.float32)
    got = t2n(got)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _layer_params(seed=1, d=64, **kw):
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), d, **kw)
    return jp, j2t_tree(jp)


LAYER = dict(d_inner=128, n_heads=4, head_dim=32, d_state=16)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_equals_reference(with_cache, rng):
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32) * 0.1
    b = rng.normal(size=(24,)).astype(np.float32)
    c = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_cache else None
    yj, cj = jax.jit(jssm._causal_conv)(x, w, b, c)
    yt, ct = tssm._causal_conv(*(None if a is None else torch.from_numpy(a) for a in (x, w, b, c)))
    np.testing.assert_array_equal(np.asarray(yj), t2n(yt))  # FMAs in the reference's order
    np.testing.assert_array_equal(np.asarray(cj), t2n(ct))


@pytest.mark.parametrize("length, chunk", [(32, 8), (16, 16), (8, 256)],
                         ids=["four_chunks", "one_chunk", "short"])
def test_ssd_chunked_equals_reference(length, chunk, rng):
    b, h, p, n = 2, 4, 8, 16
    x = rng.normal(size=(b, length, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (b, length, h)).astype(np.float32)
    a = -rng.uniform(1, 16, (h,)).astype(np.float32)
    bm = rng.normal(size=(b, length, n)).astype(np.float32)
    cm = rng.normal(size=(b, length, n)).astype(np.float32)
    yj, sj = jax.jit(lambda *args: jssm.ssd_chunked(*args, chunk))(x, dt, a, bm, cm)
    yt, st = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk)
    _close(yj, yt)
    _close(sj, st)


def test_ssd_chunked_refuses_a_ragged_length():
    z = torch.zeros((1, 12, 2, 4))
    with pytest.raises(ValueError, match="must divide chunk"):
        tssm.ssd_chunked(z, torch.zeros((1, 12, 2)), torch.ones(2), torch.zeros((1, 12, 3)),
                         torch.zeros((1, 12, 3)), 8)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "w8a8"])
def test_ssm_apply_prefill_and_decode_equal_reference(quantized, rng):
    """Prefill into a cache, then three decode steps that write the conv rows
    and the state in place (the same tensors keep the results)."""
    jp, tp = _layer_params(**LAYER)
    if quantized:
        jpol = JPolicy.uniform(8, 8, level="bitplane")
        tpol = TPolicy.uniform(8, 8, level="bitplane")
        jp = jquantize_params(jp, jpol, plane_cache=True)
        tp = tquantize_params(tp, tpol, cfg=None, plane_cache=True)  # one layer
    else:
        jpol, tpol = JPolicy.off(), TPolicy.off()
    kw = dict(LAYER, conv_width=4, chunk=8)
    step = jax.jit(lambda p, x, c: jssm.ssm_apply(p, x, policy=jpol, cache=c, **kw))
    b, conv_dim = 2, 128 + 32
    cj = {"conv": jnp.zeros((b, 3, conv_dim)), "state": jnp.zeros((b, 4, 32, 16)),
          "len": jnp.zeros((b,), jnp.int32)}
    ct = {k: j2t(v) for k, v in cj.items()}
    x = jnp.asarray(rng.normal(size=(b, 16, 64)), jnp.bfloat16)
    yj, cj = step(jp, x, cj)
    yt, ct = tssm.ssm_apply(tp, j2t(x), policy=tpol, cache=ct, **kw)
    np.testing.assert_array_equal(np.asarray(yj).astype(np.float32), t2n(yt))
    np.testing.assert_array_equal(np.asarray(cj["conv"]), t2n(ct["conv"]))
    _close(cj["state"], ct["state"])
    conv_t, state_t = ct["conv"], ct["state"]
    for _ in range(3):
        x1 = jnp.asarray(rng.normal(size=(b, 1, 64)), jnp.bfloat16)
        yj, cj = step(jp, x1, cj)
        yt, out = tssm.ssm_apply(tp, j2t(x1), policy=tpol, cache=ct, **kw)
        assert out is ct and ct["conv"] is conv_t and ct["state"] is state_t
        np.testing.assert_array_equal(np.asarray(yj).astype(np.float32), t2n(yt))
        np.testing.assert_array_equal(np.asarray(cj["conv"]), t2n(ct["conv"]))
        _close(cj["state"], ct["state"])
    np.testing.assert_array_equal(np.asarray(cj["len"]), t2n(ct["len"]))


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
@pytest.mark.parametrize("level", ["bitplane", "dense"])
def test_forward_equals_reference(scan, level, rng):
    jc, tc, jp, tp = _params(scan)
    toks = rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    if level == "dense":
        jpol, tpol, jpar, tpar = None, None, jp, tp
    else:
        jpol, tpol = JPolicy.uniform(8, 8, level=level), TPolicy.uniform(8, 8, level=level)
        jpar = jquantize_params(jp, jpol, plane_cache=True)
        tpar = tquantize_params(tp, tpol, plane_cache=True, cfg=tc)
    lj = np.asarray(jax.jit(lambda p, t: jforward(jc, p, {"tokens": t}, policy=jpol)[0])(
        jpar, jnp.asarray(toks))).astype(np.float32)
    lt = t2n(tforward(tc, tpar, {"tokens": torch.from_numpy(toks)}, policy=tpol)[0])
    if level == "dense":
        np.testing.assert_allclose(lt, lj, atol=4 * 2.0**-6, rtol=0)
    else:
        np.testing.assert_array_equal(lj, lt)


def test_cached_prefill_and_decode_logits_equal_reference(rng):
    """Prefill 16 tokens into a cache, then 6 decode steps on the stacked
    (scanned) layers at w8a8: logits within 1e-5, argmax equal."""
    jc, tc, jp, tp = _params(True)
    jpol, tpol = JPolicy.uniform(8, 8, level="bitplane"), TPolicy.uniform(8, 8, level="bitplane")
    jpar = jquantize_params(jp, jpol, plane_cache=True)
    tpar = tquantize_params(tp, tpol, plane_cache=True, cfg=tc)
    toks = rng.integers(0, jc.vocab_size, (2, 22)).astype(np.int32)
    fj = jax.jit(lambda p, t, c: jforward(jc, p, {"tokens": t}, policy=jpol, cache=c))
    jcache, tcache = jinit_cache(jc, 2, 24), tinit_cache(tc, 2, 24, device="cpu")
    for lo, hi in [(0, 16)] + [(i, i + 1) for i in range(16, 22)]:
        lj, _, jcache = fj(jpar, jnp.asarray(toks[:, lo:hi]), jcache)
        lt, _, tcache = tforward(tc, tpar, {"tokens": torch.from_numpy(toks[:, lo:hi])},
                                 policy=tpol, cache=tcache)
        lj = np.asarray(lj).astype(np.float32)[:, -1]
        lt = t2n(lt)[:, -1]
        np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
        assert (lj.argmax(-1) == lt.argmax(-1)).all()


PROMPTS = (8, 16, 32)

ENGINE_CASES = {
    "bitplane-8-4": (dict(level="bitplane"), {3: 4}, True),
    "digit": (dict(level="digit"), None, False),
    "no-fused": (dict(level="bitplane", fuse_epilogue=False), None, False),
    "detect-scanned": (dict(level="bitplane", integrity="detect"), None, True),
    "detect-unrolled": (dict(level="bitplane", integrity="detect"), None, False),
    "sparsity-compact": (dict(level="bitplane", sparsity="compact"), None, True),
}


def _requests(cls, vocab):
    rng = np.random.default_rng(1)
    return [cls(rid=i, tokens=rng.integers(0, vocab, (s,)), max_new_tokens=5, arrival_step=2 * i)
            for i, s in enumerate(PROMPTS)]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_cb_engine_equals_reference(case):
    pol, sched, scan = ENGINE_CASES[case]
    jc, tc, jp, tp = _params(scan)
    je = jserve.ContinuousBatchingEngine(jc, jp, JPolicy.uniform(8, 8, **pol), n_slots=2,
                                         max_len=40)
    te = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, **pol), n_slots=2,
                                        max_len=40, device="cpu")
    rj, sj = je.run(_requests(JRequest, jc.vocab_size), precision_schedule=sched)
    rt, st = te.run(_requests(TRequest, tc.vocab_size), precision_schedule=sched)
    assert sorted(rj) == sorted(rt) == [0, 1, 2]
    for rid in rj:
        np.testing.assert_array_equal(np.asarray(rj[rid]), rt[rid], err_msg=f"rid {rid}")
    for key in ("precision_switches", "decode_steps", "admitted", "kv_cache_bytes", "failed"):
        assert sj[key] == st[key], key
    assert st["kv_cache_bytes"] == 0  # no attention: nothing counts as KV
    if "integrity" in pol:
        assert st["integrity"] == sj["integrity"]
        assert st["integrity"]["abft_checks"] > 0 and st["integrity"]["abft_alarms"] == 0


def test_lockstep_engine_equals_reference(rng):
    jc, tc, jp, tp = _params(True)
    prompts = rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    je = jserve.Engine(jc, jp, JPolicy.uniform(8, 8, level="bitplane"), max_len=22)
    te = serve.Engine(tc, tp, TPolicy.uniform(8, 8, level="bitplane"), max_len=22, device="cpu")
    want, _ = je.generate(jnp.asarray(prompts), 6)
    got, _ = te.generate(prompts, 6)
    np.testing.assert_array_equal(np.asarray(want), t2n(got))


def test_quantized_leaves_are_the_references():
    jc, tc, jp, tp = _params(False)
    pol = dict(level="bitplane")
    jq = jquantize_params(jp, JPolicy.uniform(8, 8, **pol))
    tq = tquantize_params(tp, TPolicy.uniform(8, 8, **pol), cfg=tc)
    assert quantized_paths(tq) == quantized_paths(jq)
    assert quantized_paths(tq) == {f"/layers/{i}/ssm/{p}" for i in range(tc.n_layers)
                                    for p in ("in_proj", "out_proj")}
    for key in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert tq["layers"][0]["ssm"][key].dtype == torch.float32


# --------------------------------------------------------------------------
# The decode step the card captures
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pol", [dict(level="bitplane"),
                                 dict(level="bitplane", integrity="detect")], ids=["fused", "detect"])
def test_decode_step_reads_nothing_back(pol, monkeypatch):
    """One decode step on the card's routes (kernels stubbed: they run only
    on the card) reads nothing back to the host and builds no tensor from
    host data, so a CUDA graph captures it with the state in place."""
    jc, tc, jp, tp = _params(True)
    stub_kernels(monkeypatch)
    eng = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, **pol), n_slots=2,
                                         max_len=24, device="cpu")
    eng._decode(0)  # warm-up: builds the constants every later step reuses
    leaves = [t.data_ptr() for blk in eng._cache["layers"] for t in blk.values()]
    with Watch() as watch:
        eng._decode(1)
    assert watch.bad == []
    assert [t.data_ptr() for blk in eng._cache["layers"] for t in blk.values()] == leaves


def test_stub_graph_replay_equals_eager():
    """A runner that replays like a graph (the step reruns on the static
    state): the eager run's tokens, route calls and decode steps."""
    jc, tc, jp, tp = _params(True)

    def serve_with(runner):
        eng = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, level="bitplane"),
                                             n_slots=2, max_len=40, device="cpu")
        eng._runner = runner
        return eng.run(_requests(TRequest, tc.vocab_size), precision_schedule={3: 4})

    r_eager, s_eager = serve_with(None)
    r_graph, s_graph = serve_with(StubRunner)
    assert s_graph["route_calls"] == s_eager["route_calls"]
    assert s_graph["decode_steps"] == s_eager["decode_steps"]
    assert set(s_graph["capture_s"]) == {"None", "(4, 4)"}
    for rid in r_eager:
        np.testing.assert_array_equal(r_eager[rid], r_graph[rid])


AP_KW = dict(sla_queue_steps=6, degrade_patience=2, upgrade_patience=4, cooldown_steps=2,
             shadow_frac=0.5)


def test_autopilot_engine_equals_reference():
    """The SLA autopilot over an overload ramp (8 requests, 2 per step, 2
    slots): tokens, tiers, switches, shed set and shadow probes equal; the
    probe's KL EWMA within 1e-5 relative (the reference's compiled
    float32 ``log``/``exp``, as for the dense family)."""
    jc, tc, jp, tp = _params(False)
    pol = dict(level="bitplane")
    kw = dict(n_slots=2, max_len=12)
    te = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, **pol), device="cpu",
                                        autopilot=TAutopilotPolicy(**AP_KW), **kw)
    with reference_quantizes_to(lambda: quantized_to_jax(te.q_params)):
        je = jserve.ContinuousBatchingEngine(jc, jp, JPolicy.uniform(8, 8, **pol),
                                             autopilot=JAutopilotPolicy(**AP_KW), **kw)

    def burst(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, tokens=rng.integers(0, jc.vocab_size, (4,)), max_new_tokens=5,
                    arrival_step=i // 2) for i in range(8)]

    rj, sj = je.run(burst(JRequest))
    rt, st = te.run(burst(TRequest))
    assert sorted(rj) == sorted(rt)
    for rid in rj:
        np.testing.assert_array_equal(np.asarray(rj[rid]), rt[rid], err_msg=f"rid {rid}")
    ta, ja = st["autopilot"], sj["autopilot"]
    for key in ("tiers", "final_tier", "shed", "request_tiers", "tier_tokens", "shadow_probes"):
        assert ta[key] == ja[key], key
    assert [(s, tuple(t), w) for s, t, w in ta["switches"]] == \
        [(s, tuple(t), w) for s, t, w in ja["switches"]]
    assert st["failed"] == sj["failed"] and ta["shed"] > 0
    np.testing.assert_allclose(ta["shadow_kl_ewma"], ja["shadow_kl_ewma"], rtol=1e-5)

