"""Port parity of the Griffin hybrid (reduced recurrentgemma-2b: RG-LRU and
sliding-window attention blocks in a (rec, rec, attn) period, window 16),
held against the JAX reference on the CPU.

* ``linear_scan`` combines in ``lax.associative_scan``'s tree order:
  bit-equal at odd and even lengths. ``rglru_apply`` (prefill, then decode
  steps in place) and ``_local_gqa``: bf16 outputs bit-equal, float32
  values (``h``, the attention output) within 4e-6 of the magnitude — the
  reference's compiled ``exp``, ``tanh`` and ``sigmoid`` are not correctly
  rounded, so its float32 operators differ from the port's by an ulp here
  and there (the port repeats its FMA contractions and its fusions).
* ``forward`` scanned, unrolled and with a period tail (``n_layers=5``:
  one period and two tail layers): quantized logits bit-equal (the port
  repeats where XLA keeps a residual sum unrounded into the next norm),
  the unquantized forward within 4 bf16 steps.
* The ring: prefills of 12, 16 and 32 tokens, then decode through the
  16-row ring's wrap: logits within 0.1 of the reference's (a rare int8
  rounding flip from those ulps moves a logit by ~0.04) with equal
  tokens, and within 0.1 of a cache-free forward over the same tokens.
* The reference's two defects, measured on its own code (each gap above
  0.1), and the port's refusals: a chunked prefill (E) and a windowed
  prompt longer than the ring and not a multiple of it (F) raise
  ``ValueError`` in the engines and kill the CLI.
* The continuous-batching engine at bitplane with an 8 -> 4 switch, at
  digit, ``--no-fused``, detect (scanned, unrolled, and one period with a
  tail, whose ABFT checks fold per scan and count per tail projection),
  scrub under a
  seeded fault spec and the SLA autopilot; the lockstep ``Engine``:
  tokens and ``stats()`` equal. The quantized leaves: the projections, not ``conv_w`` or ``lam``.
* The decode step the card captures as a CUDA graph: on the card's routes
  (kernels stubbed) it reads nothing back and keeps every state leaf at
  its address; a runner that replays like a graph gives the eager tokens.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import serve as jserve
from repro.layers import attention as jattn
from repro.layers import rglru as jrglru
from repro.models.cache import init_cache as jinit_cache
from repro.models.quant import quantize_params as jquantize_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro.runtime.autopilot import AutopilotPolicy as JAutopilotPolicy
from repro.runtime.faults import FaultInjector as JInjector
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels.plane_mm_fused import ACTIVATIONS
from repro_torch.launch import serve
from repro_torch.layers import attention as tattn
from repro_torch.layers import rglru as trglru
from repro_torch.models.cache import init_cache as tinit_cache
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import forward as tforward
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.autopilot import AutopilotPolicy as TAutopilotPolicy
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import (
    StubRunner,
    Watch,
    j2t,
    j2t_tree,
    quantized_paths,
    reference_layout,
    reference_quantizes_to,
    stub_kernels,
    t2n,
    to_numpy_tree,
)

ARCH = "recurrentgemma-2b"
WINDOW = 16  # the reduced config's local_window
STATE_RTOL = 4e-6  # float32 values, relative to the magnitude (docstring)
RING_ATOL = 0.1  # decode logits through the ring (docstring)
W8 = dict(level="bitplane")

_S: dict = {}


def _params(scan: bool = True, n_layers=None):
    key = (scan, n_layers)
    if key not in _S:
        jc = dataclasses.replace(jget(ARCH), scan_layers=scan)
        tc = dataclasses.replace(tget(ARCH), scan_layers=scan)
        if n_layers:
            jc = dataclasses.replace(jc, n_layers=n_layers)
            tc = dataclasses.replace(tc, n_layers=n_layers)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        _S[key] = (jc, tc, jp, params_from_numpy(tc, to_numpy_tree(jp), device="cpu"))
    return _S[key]


def _quantized(scan: bool = True, n_layers=None, reference_quantizes=False):
    """(the reference's quantized tree, the port's) at w8a8. The reference's
    eager quantization takes seconds per tree, so except where a test asks
    for it its tree is the port's in its layout (the two are the same: the
    forward test on the reference's own tree holds the logits bit-equal)."""
    key = ("q", scan, n_layers, reference_quantizes)
    if key not in _S:
        jc, tc, jp, tp = _params(scan, n_layers)
        tq = tquantize_params(tp, TPolicy.uniform(8, 8, **W8), plane_cache=True, cfg=tc)
        jq = (jquantize_params(jp, JPolicy.uniform(8, 8, **W8), plane_cache=True)
              if reference_quantizes else reference_layout(tc, tq))
        _S[key] = (jq, tq)
    return _S[key]


def _close(want, got, rtol=STATE_RTOL):
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=rtol * scale)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 2, 5, 12, 16, 33])
def test_linear_scan_is_the_reference_tree(length, rng):
    a = rng.uniform(0.5, 1.0, (2, length, 8)).astype(np.float32)
    b = rng.normal(size=(2, length, 8)).astype(np.float32)

    def comb(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    aj, hj = jax.jit(lambda a, b: jax.lax.associative_scan(comb, (a, b), axis=1))(a, b)
    at, ht = trglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    np.testing.assert_array_equal(np.asarray(aj), t2n(at))
    np.testing.assert_array_equal(np.asarray(hj), t2n(ht))


def test_rglru_apply_prefill_and_decode_equal_reference(rng):
    """w8a8 projections; prefill into a cache, then three decode steps that
    write the conv rows and ``h`` in place."""
    jp = jrglru.rglru_init(jax.random.PRNGKey(2), 80, 80)
    tp = j2t_tree(jp)
    jpol, tpol = JPolicy.uniform(8, 8, **W8), TPolicy.uniform(8, 8, **W8)
    jp = jquantize_params(jp, jpol, plane_cache=True)
    tp = tquantize_params(tp, tpol, cfg=None, plane_cache=True)  # one layer
    step = jax.jit(lambda p, x, c: jrglru.rglru_apply(p, x, lru_width=80, policy=jpol, cache=c))
    b = 2
    cj = {"conv": jnp.zeros((b, 3, 80)), "h": jnp.zeros((b, 80)),
          "len": jnp.zeros((b,), jnp.int32)}
    ct = {k: j2t(v) for k, v in cj.items()}
    x = jnp.asarray(rng.normal(size=(b, 12, 80)), jnp.bfloat16)
    yj, cj = step(jp, x, cj)
    yt, ct = trglru.rglru_apply(tp, j2t(x), lru_width=80, policy=tpol, cache=ct)
    np.testing.assert_array_equal(np.asarray(yj).astype(np.float32), t2n(yt))
    _close(cj["h"], ct["h"])
    conv_t, h_t = ct["conv"], ct["h"]
    for _ in range(3):
        x1 = jnp.asarray(rng.normal(size=(b, 1, 80)), jnp.bfloat16)
        yj, cj = step(jp, x1, cj)
        yt, out = trglru.rglru_apply(tp, j2t(x1), lru_width=80, policy=tpol, cache=ct)
        assert out is ct and ct["conv"] is conv_t and ct["h"] is h_t
        np.testing.assert_array_equal(np.asarray(yj).astype(np.float32), t2n(yt))
        np.testing.assert_array_equal(np.asarray(cj["conv"]), t2n(ct["conv"]))
        _close(cj["h"], ct["h"])


@pytest.mark.parametrize("length", [12, 16, 33])
def test_local_gqa_equals_reference(length, rng):
    q, k, v = (jnp.asarray(rng.normal(size=(2, length, h, 40)), jnp.bfloat16) for h in (2, 1, 1))
    oj = jax.jit(lambda q, k, v: jattn._local_gqa(q, k, v, window=WINDOW))(q, k, v)
    ot = tattn._local_gqa(j2t(q), j2t(k), j2t(v), window=WINDOW)
    _close(oj, ot)


def test_geglu_gelu_is_the_tanh_form(rng):
    """The GeGLU gate's gelu (and the RG-LRU's y branch) is jax.nn.gelu's
    default, the tanh form, within the reference's compiled tanh's ulps —
    not the erf form, which differs by ~1e-3."""
    x = (rng.normal(size=(4096,)) * 3).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(x))
    got = t2n(ACTIVATIONS["gelu"](torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    erf = t2n(torch.nn.functional.gelu(torch.from_numpy(x)))
    assert np.abs(erf - want).max() > 1e-4


# --------------------------------------------------------------------------
# The stack
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scan, n_layers", [(True, None), (False, None), (True, 5)],
                         ids=["scanned", "unrolled", "period-tail"])
@pytest.mark.parametrize("level", ["bitplane", "dense"])
def test_forward_equals_reference(scan, n_layers, level, rng):
    jc, tc, jp, tp = _params(scan, n_layers)
    toks = rng.integers(0, jc.vocab_size, (2, 20)).astype(np.int32)
    if level == "dense":
        jpol, tpol, jpar, tpar = None, None, jp, tp
    else:
        jpol, tpol = JPolicy.uniform(8, 8, **W8), TPolicy.uniform(8, 8, **W8)
        jpar, tpar = _quantized(scan, n_layers, reference_quantizes=n_layers is None and scan)
    lj = np.asarray(jax.jit(lambda p, t: jforward(jc, p, {"tokens": t}, policy=jpol)[0])(
        jpar, jnp.asarray(toks))).astype(np.float32)
    lt = t2n(tforward(tc, tpar, {"tokens": torch.from_numpy(toks)}, policy=tpol)[0])
    if level == "dense":
        np.testing.assert_allclose(lt, lj, atol=4 * 2.0**-6, rtol=0)
    else:
        np.testing.assert_array_equal(lj, lt)


def _ring_run(fwd, params, cfg, toks, prompt, max_len, init_cache, to_host, **kw):
    """Prefill ``prompt`` tokens into a cache, then decode the rest one by
    one: the last-position logits of every call, as float32 numpy."""
    cache = init_cache(cfg, toks.shape[0], max_len)
    out = []
    for lo, hi in [(0, prompt)] + [(i, i + 1) for i in range(prompt, toks.shape[1])]:
        logits, _, cache = fwd(params, toks[:, lo:hi], cache, **kw)
        out.append(to_host(logits)[:, -1])
    return out


@pytest.mark.parametrize("prompt", [12, 16, 32])
def test_ring_decode_equals_reference_and_the_cache_free_forward(prompt, rng):
    """Aligned prompts (shorter than the ring, or a multiple of it), then
    decode through the ring's wrap: each step's logits against the
    reference's, and against a cache-free forward over the same tokens."""
    jc, tc, jp, tp = _params()
    jpar, tpar = _quantized()
    jpol, tpol = JPolicy.uniform(8, 8, **W8), TPolicy.uniform(8, 8, **W8)
    n = prompt + 20
    toks = rng.integers(0, jc.vocab_size, (1, n)).astype(np.int32)
    fj = jax.jit(lambda p, t, c: jforward(jc, p, {"tokens": t}, policy=jpol, cache=c))
    want = _ring_run(lambda p, t, c: fj(p, jnp.asarray(t), c), jpar, jc, toks, prompt, n,
                     jinit_cache, lambda a: np.asarray(a).astype(np.float32))
    got = _ring_run(
        lambda p, t, c: tforward(tc, p, {"tokens": torch.from_numpy(t)}, policy=tpol, cache=c),
        tpar, tc, toks, prompt, n, lambda c, b, m: tinit_cache(c, b, m, device="cpu"), t2n)
    free = t2n(tforward(tc, tpar, {"tokens": torch.from_numpy(toks)}, policy=tpol)[0])[0]
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, atol=RING_ATOL, rtol=0, err_msg=f"call {i}")
        assert (w.argmax(-1) == g.argmax(-1)).all(), f"call {i}"
        np.testing.assert_allclose(g[0], free[prompt - 1 + i], atol=RING_ATOL, rtol=0,
                                   err_msg=f"call {i} against the cache-free forward")


@pytest.mark.parametrize("prompt", [12, 16, 32])
def test_ring_decode_gap_is_the_bf16_softmax_weights(prompt, rng, monkeypatch):
    """The smoke's ring witness on the host: through the wrap, the ring
    decode's logits differ from the cache-free forward's only by
    ``_decode_gqa``'s bf16 rounding of the softmax weights. With them kept
    in float32 (``chip_smoke._decode_gqa_f32_weights``, which the smoke
    runs on the card) the two are equal."""
    _, tc, _, _ = _params()
    _, tpar = _quantized()
    tpol = TPolicy.uniform(8, 8, **W8)
    n = prompt + 20
    toks = rng.integers(0, tc.vocab_size, (1, n)).astype(np.int32)
    free = t2n(tforward(tc, tpar, {"tokens": torch.from_numpy(toks)}, policy=tpol)[0])[0]

    def decode_gaps():
        steps = _ring_run(
            lambda p, t, c: tforward(tc, p, {"tokens": torch.from_numpy(t)}, policy=tpol, cache=c),
            tpar, tc, toks, prompt, n, lambda c, b, m: tinit_cache(c, b, m, device="cpu"), t2n)
        return [np.abs(s[0] - free[prompt - 1 + i]).max() for i, s in enumerate(steps)][1:]

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bf16 = decode_gaps()
    monkeypatch.setattr(tattn, "_decode_gqa", smoke._decode_gqa_f32_weights)
    f32 = decode_gaps()
    assert max(bf16) > 0 and max(f32) == 0, (max(bf16), max(f32))


# --------------------------------------------------------------------------
# The reference's defects E and F: its gap, and the port's refusal
# --------------------------------------------------------------------------


def test_reference_chunked_prefill_restarts_the_recurrence():
    """Defect E on the reference: 16 tokens prefilled as 8 + 8 against one
    call of 16 (the second chunk restarts the RG-LRU state and writes its
    window at ring row 0)."""
    jc, _, jp, _ = _params()
    toks = jnp.asarray(np.random.default_rng(0).integers(0, jc.vocab_size, (1, 16)), jnp.int32)
    f = jax.jit(lambda p, t, c: jforward(jc, p, {"tokens": t}, cache=c)[::2])
    whole, _ = f(jp, toks, jinit_cache(jc, 1, 16))
    _, cache = f(jp, toks[:, :8], jinit_cache(jc, 1, 16))
    chunked, _ = f(jp, toks[:, 8:], cache)
    gap = np.abs(np.asarray(whole[:, -1], np.float32) - np.asarray(chunked[:, -1], np.float32))
    assert gap.max() > 0.1


def test_reference_misaligned_ring_evicts_the_wrong_position():
    """Defect F on the reference: a 20-token prompt into the 16-row ring,
    then decode; its logits against a cache-free forward."""
    jc, _, jp, _ = _params()
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (1, 26)).astype(np.int32)
    f = jax.jit(lambda p, t, c: jforward(jc, p, {"tokens": t}, cache=c))
    steps = _ring_run(lambda p, t, c: f(p, jnp.asarray(t), c), jp, jc, toks, 20, 26,
                      jinit_cache, lambda a: np.asarray(a).astype(np.float32))
    free = np.asarray(jax.jit(lambda p, t: jforward(jc, p, {"tokens": t})[0])(
        jp, jnp.asarray(toks)), np.float32)[0]
    gaps = [np.abs(s[0] - free[19 + i]).max() for i, s in enumerate(steps)]
    assert gaps[0] < 0.05 and max(gaps[1:]) > 0.1  # the prefill is right, decode is not


def test_port_refuses_the_defects():
    jc, tc, jp, tp = _params()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tc.vocab_size, (1, 16)))
    _, _, cache = tforward(tc, tp, {"tokens": toks[:, :8]},
                           cache=tinit_cache(tc, 1, 16, device="cpu"))
    with pytest.raises(ValueError, match="defect E"):
        tforward(tc, tp, {"tokens": toks[:, 8:]}, cache=cache)
    chunked = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, **W8), n_slots=1,
                                             max_len=24, prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="defect E"):
        chunked.run([TRequest(rid=0, tokens=np.arange(16), max_new_tokens=2)])
    with pytest.raises(ValueError, match="defect F"):
        tforward(tc, tp, {"tokens": toks[:, :4].repeat(1, 5)},
                 cache=tinit_cache(tc, 1, 24, device="cpu"))
    eng = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, **W8), n_slots=1,
                                         max_len=24, device="cpu")
    with pytest.raises(ValueError, match="defect F"):
        eng.run([TRequest(rid=0, tokens=np.arange(20), max_new_tokens=2)])
    lock = serve.Engine(tc, tp, TPolicy.uniform(8, 8, **W8), max_len=24, device="cpu")
    with pytest.raises(ValueError, match="defect F"):
        lock.generate(np.zeros((1, 20), np.int32), 2)
    for argv, what in ((["--prefill-chunk", "8", "--prompt-lens", "16"], "defect E"),
                       (["--prompt-lens", "12,20"], "defect F")):
        with pytest.raises(SystemExit, match=what):
            serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--gen", "2"] + argv)


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------

PROMPTS = (8, 16, 8)

ENGINE_CASES = {  # case: (policy, precision schedule, scan_layers, n_layers)
    "bitplane-8-4": (dict(level="bitplane"), {3: 4}, True, None),
    "digit": (dict(level="digit"), None, True, None),
    "no-fused": (dict(level="bitplane", fuse_epilogue=False), None, False, None),
    "detect-scanned": (dict(level="bitplane", integrity="detect"), None, True, None),
    "detect-unrolled": (dict(level="bitplane", integrity="detect"), None, False, None),
    # one scanned period (one folded check) and a 2-layer tail (a check per
    # projection), as the reference's lax.scan and unrolled tail report
    "detect-period-tail": (dict(level="bitplane", integrity="detect"), None, True, 5),
}


def _requests(cls, vocab, gen=5):
    rng = np.random.default_rng(1)
    return [cls(rid=i, tokens=rng.integers(0, vocab, (s,)), max_new_tokens=gen,
                arrival_step=2 * i) for i, s in enumerate(PROMPTS)]


def _port_quantization(tree, cfg):
    """The reference engine takes the port's quantized tree in its layout
    (``reference_layout``) in place of its eager quantization."""
    return reference_quantizes_to(lambda: reference_layout(cfg, tree))


def _same(rj, rt):
    assert sorted(rj) == sorted(rt)
    for rid in rj:
        np.testing.assert_array_equal(np.asarray(rj[rid]), rt[rid], err_msg=f"rid {rid}")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_cb_engine_equals_reference(case):
    pol, sched, scan, n_layers = ENGINE_CASES[case]
    jc, tc, jp, tp = _params(scan, n_layers)
    te = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, **pol), n_slots=2,
                                        max_len=24, device="cpu")
    with _port_quantization(te.q_params, tc):
        je = jserve.ContinuousBatchingEngine(jc, jp, JPolicy.uniform(8, 8, **pol), n_slots=2,
                                             max_len=24)
    rj, sj = je.run(_requests(JRequest, jc.vocab_size), precision_schedule=sched)
    rt, st = te.run(_requests(TRequest, tc.vocab_size), precision_schedule=sched)
    _same(rj, rt)
    for key in ("precision_switches", "decode_steps", "admitted", "kv_cache_bytes", "failed"):
        assert sj[key] == st[key], key
    if "integrity" in pol:
        assert st["integrity"] == sj["integrity"]
        assert st["integrity"]["abft_alarms"] == 0


def _events(inj):
    return [(e.site, e.step, e.leaf, e.byte, e.bit, e.category, e.detected) for e in inj.events]


def test_scrub_engine_equals_reference():
    """Scrub under a seeded spec over the weights and the ring's KV
    (unrolled, so the injector's walk meets the same leaves): the clean
    run's tokens, the reference's counts and events."""
    jc, tc, jp, tp = _params(False)
    pol = dict(level="bitplane", integrity="scrub")
    te = serve.ContinuousBatchingEngine(tc, tp, TPolicy.uniform(8, 8, **pol), n_slots=2,
                                        max_len=24, device="cpu")
    pristine = te._requantize(tp)
    with _port_quantization(pristine, tc):
        je = jserve.ContinuousBatchingEngine(jc, jp, JPolicy.uniform(8, 8, **pol), n_slots=2,
                                             max_len=24)
    spec = "planes@2,scale@3,kv@4,kv_scale@6;seed=11"
    clean, _ = te.run(_requests(TRequest, tc.vocab_size, gen=8))
    inj_t, inj_j = FaultInjector(spec), JInjector(spec)
    rt, st = te.run(_requests(TRequest, tc.vocab_size, gen=8), injector=inj_t)
    with _port_quantization(pristine, tc):
        rj, sj = je.run(_requests(JRequest, jc.vocab_size, gen=8), injector=inj_j)
    _same(rj, rt)
    _same(clean, rt)
    assert st["integrity"] == sj["integrity"] and st["integrity"]["scrubs"] > 0
    assert _events(inj_t) == _events(inj_j) and not inj_t.undetected


def test_lockstep_engine_equals_reference(rng):
    jc, tc, jp, tp = _params(False)
    te = serve.Engine(tc, tp, TPolicy.uniform(8, 8, **W8), max_len=18, device="cpu")
    with _port_quantization(te.q_params, tc):
        je = jserve.Engine(jc, jp, JPolicy.uniform(8, 8, **W8), max_len=18)
    prompts = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    want, _ = je.generate(jnp.asarray(prompts), 6)
    got, _ = te.generate(prompts, 6)
    np.testing.assert_array_equal(np.asarray(want), t2n(got))


def test_quantized_leaves_are_the_references():
    jc, tc, jp, tp = _params(False)
    jq = jquantize_params(jp, JPolicy.uniform(8, 8, **W8))
    tq = tquantize_params(tp, TPolicy.uniform(8, 8, **W8), cfg=tc)
    assert quantized_paths(tq) == quantized_paths(jq)
    rec = {f"rglru/{p}" for p in ("in_x", "in_y", "out", "gate_a", "gate_x")}
    assert {p.split("/", 3)[3] for p in quantized_paths(tq) if p.startswith("/layers/0/")} == \
        rec | {f"mlp/{p}" for p in ("gate_proj", "up_proj", "down_proj")}
    for key in ("conv_w", "conv_b", "lam"):
        assert tq["layers"][0]["rglru"][key].dtype == torch.float32


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
                                             n_slots=2, max_len=24, device="cpu")
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
    with _port_quantization(te.q_params, tc):
        je = jserve.ContinuousBatchingEngine(jc, jp, JPolicy.uniform(8, 8, **pol),
                                             autopilot=JAutopilotPolicy(**AP_KW), **kw)

    def burst(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, tokens=rng.integers(0, jc.vocab_size, (4,)), max_new_tokens=5,
                    arrival_step=i // 2) for i in range(8)]

    rj, sj = je.run(burst(JRequest))
    rt, st = te.run(burst(TRequest))
    _same(rj, rt)
    ta, ja = st["autopilot"], sj["autopilot"]
    for key in ("tiers", "final_tier", "shed", "request_tiers", "tier_tokens", "shadow_probes"):
        assert ta[key] == ja[key], key
    assert [(s, tuple(t), w) for s, t, w in ta["switches"]] == \
        [(s, tuple(t), w) for s, t, w in ja["switches"]]
    assert st["failed"] == sj["failed"] and ta["shed"] > 0
    np.testing.assert_allclose(ta["shadow_kl_ewma"], ja["shadow_kl_ewma"], rtol=1e-5)
