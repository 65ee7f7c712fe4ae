"""The plan layer's front door in the port, against the JAX package, on the
CPU:

* ``ops.bitserial_matmul`` (the legacy shim over plans) on the same seeded
  operands, over every ``level`` / ``mode`` / ``variant`` / ``packed`` /
  ``fused`` / ``epilogue`` / ``w_planes`` combination: the reference's
  integers bit-equal (the JAX side through its own CPU route, ``jnp``, as
  its tests run it; the port's through its plain versions), the bf16
  epilogue output bit-equal with ``activation="none"`` (the transcendental
  activations round as each library's ``sigmoid``/``tanh`` do: within one
  bf16 ulp, rtol 2^-7), and on every combination the reference refuses the
  same exception with the same message; the ``TypeError`` for an unknown
  tile keyword; one ``DeprecationWarning`` per legacy keyword per process;
* ``core.quantized_matmul`` bit-equal (the same float32 ``(acc * scale_a)
  * scale_w``; tolerance 0) and ``core.plane_pass_count`` equal on a grid;
* reduced granite with ``value_bits=4``: both engines give the reference
  engines' greedy tokens;
* ``serve --reduced --device cpu --autotune --plan-store P``: the
  reference's plans (the store's key ids equal the reference CLI's with the
  backend names mapped), store counters and records, the untuned run's
  tokens, zero tunes on a second run; ``--plan-store`` alone dies with the
  reference's message.
"""

import itertools
import re
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core import bitserial as jbs
from repro.core import plan as jplan
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models.transformer import init_params as jinit
from repro.runtime.plan_store import PlanStore as JPlanStore
from repro.runtime.scheduler import Request as JRequest
from repro_torch import core as tcore
from repro_torch.configs import get_reduced as tget
from repro_torch.core import bitplanes as tbp
from repro_torch.core import plan as tplan
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.plan_store import PlanStore
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import t2n, to_numpy_tree, weight_planes_to_jax

M, K, N = 3, 40, 24
BITS = 4


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 8, (M, K)).astype(np.int8)
    w = rng.integers(-8, 8, (K, N)).astype(np.int8)
    a_scale = rng.random((M, 1)).astype(np.float32)
    w_scale = rng.random((N,)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    return a, w, a_scale, w_scale, bias


def _epilogues(activation):
    _, _, a_scale, w_scale, bias = _operands()
    return (jops.Epilogue(jnp.asarray(a_scale), jnp.asarray(w_scale), jnp.asarray(bias),
                          activation),
            tops.Epilogue(torch.from_numpy(a_scale), torch.from_numpy(w_scale),
                          torch.from_numpy(bias), activation))


def _both(jkw, tkw):
    """(reference output or exception, port output or exception)."""
    a, w = _operands()[:2]
    out = []
    for fn, x, y, kw in ((jops.bitserial_matmul, jnp.asarray(a), jnp.asarray(w), jkw),
                         (tops.bitserial_matmul, torch.from_numpy(a), torch.from_numpy(w), tkw)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                out.append(fn(x, y, **kw))
            except (ValueError, TypeError) as e:
                out.append(e)
    return out


def _bits(x):
    """Integers as they are; bf16 as its bit pattern."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


COMBOS = list(itertools.product(("bitplane", "digit"), ("fully_serial", "serial_parallel"),
                                ("booth", "sbmwc")))


@pytest.mark.parametrize("level, mode, variant", COMBOS, ids=["-".join(c) for c in COMBOS])
def test_bitserial_matmul_equals_reference(level, mode, variant):
    wt = torch.from_numpy(_operands()[1])
    cache_t = tbp.make_weight_planes(wt, w_bits=BITS, variant=variant, level=level)
    cache_j = weight_planes_to_jax(cache_t)
    ep_j, ep_t = _epilogues("none")
    served = refused = 0
    for packed, fused, ep, cached in itertools.product((None, True, False), (None, True, False),
                                                       (False, True), (False, True)):
        base = dict(a_bits=BITS, w_bits=BITS, level=level, mode=mode, variant=variant,
                    packed=packed, fused=fused)
        jkw = dict(base, epilogue=ep_j if ep else None, w_planes=cache_j if cached else None)
        tkw = dict(base, epilogue=ep_t if ep else None, w_planes=cache_t if cached else None)
        ref, got = _both(jkw, tkw)
        case = f"packed={packed} fused={fused} epilogue={ep} w_planes={cached}"
        if isinstance(ref, Exception) or isinstance(got, Exception):
            assert type(got) is type(ref) and str(got) == str(ref), (case, ref, got)
            refused += 1
            continue
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=case)
        assert got.shape == (M, N) and got.dtype == (torch.bfloat16 if ep else torch.int32)
        served += 1
    assert served and refused  # both kinds of combination occur at every level


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_bitserial_matmul_activations_within_one_bf16_ulp(activation):
    ep_j, ep_t = _epilogues(activation)
    kw = dict(a_bits=BITS, w_bits=BITS, level="bitplane")
    ref, got = _both(dict(kw, epilogue=ep_j), dict(kw, epilogue=ep_t))
    np.testing.assert_allclose(t2n(got), np.asarray(ref).astype(np.float32), rtol=2**-7,
                               atol=2**-7 * 2**-6)


def test_unknown_tile_keyword_raises_type_error():
    ref, got = _both(dict(a_bits=BITS, w_bits=BITS, bq=8), dict(a_bits=BITS, w_bits=BITS, bq=8))
    assert isinstance(ref, TypeError) and isinstance(got, TypeError)
    assert str(got) == str(ref)


def test_deprecation_warnings_once_per_process():
    a, w = (torch.from_numpy(x) for x in _operands()[:2])
    _, ep_t = _epilogues("none")
    tplan._reset_deprecation_warnings()
    try:
        for kw in ("packed", "fused", "epilogue"):
            val = ep_t if kw == "epilogue" else False
            with pytest.warns(DeprecationWarning) as rec:
                tops.bitserial_matmul(a, w, a_bits=BITS, w_bits=BITS, level="bitplane",
                                      **{kw: val})
            msgs = [str(r.message) for r in rec if r.category is DeprecationWarning]
            assert msgs == [jplan._DEPRECATION_TEXT[kw].replace("repro.core", "repro_torch.core")]
            with warnings.catch_warnings():
                warnings.simplefilter("error", DeprecationWarning)
                tops.bitserial_matmul(a, w, a_bits=BITS, w_bits=BITS, level="bitplane",
                                      **{kw: val})  # once per process: no second warning
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            tops.bitserial_matmul(a, w, a_bits=BITS, w_bits=BITS)  # no legacy keyword
    finally:
        tplan._reset_deprecation_warnings()


# --------------------------------------------------------------------------
# quantized_matmul, plane_pass_count
# --------------------------------------------------------------------------


@pytest.mark.parametrize("level, mode, bits", [
    ("bitplane", "fully_serial", 4), ("digit", "fully_serial", 8),
    ("bitplane", "serial_parallel", 6), ("fused", "fully_serial", 8),
])
def test_quantized_matmul_equals_reference(level, mode, bits):
    rng = np.random.default_rng(7)
    lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
    a = rng.integers(lo, hi, (2, 3, 32)).astype(np.int8)
    w = rng.integers(lo, hi, (32, 16)).astype(np.int8)
    sa = rng.random((2, 3, 1)).astype(np.float32)
    sw = rng.random((16,)).astype(np.float32)
    kw = dict(a_bits=bits, w_bits=bits, level=level, mode=mode)
    ref = jbs.quantized_matmul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(sa), jnp.asarray(sw),
                               **kw)
    got = tcore.quantized_matmul(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(sa),
                                 torch.from_numpy(sw), **kw)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    half = tcore.quantized_matmul(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(sa),
                                  torch.from_numpy(sw), out_dtype=torch.bfloat16, **kw)
    np.testing.assert_array_equal(t2n(half), np.asarray(ref.astype(jnp.bfloat16)).astype(
        np.float32))


def test_plane_pass_count_equals_reference():
    for a, w, level, mode, radix in itertools.product(
            (1, 3, 8, 9, 16), (1, 4, 8, 12, 16), ("fused", "bitplane", "digit"),
            ("fully_serial", "serial_parallel"), (4, 8)):
        assert tcore.plane_pass_count(a, w, level, mode, radix) == \
            jbs.plane_pass_count(a, w, level, mode, radix), (a, w, level, mode, radix)
    for bad in (jbs.plane_pass_count, tcore.plane_pass_count):
        with pytest.raises(ValueError):
            bad(4, 4, "nibble", "fully_serial")


def test_core_exports_the_reference_front_door():
    import repro.core as jcore

    missing = set(jcore.__all__) - set(tcore.__all__)
    assert missing == set()
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None


# --------------------------------------------------------------------------
# value_bits on both engines
# --------------------------------------------------------------------------

ARCH = "granite-3-8b"
_S: dict = {}


def _params():
    if not _S:
        jc = jget(ARCH)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(1))
        _S.update(jp=jp, tp=params_from_numpy(tget(ARCH), to_numpy_tree(jp), device="cpu"))
    return _S["jp"], _S["tp"]


def _policy(cls):
    return cls.uniform(8, 8, level="bitplane")


def test_lockstep_engine_value_bits_equals_reference():
    jp, tp = _params()
    prompts = np.random.default_rng(2).integers(0, jget(ARCH).vocab_size, (2, 6)).astype(np.int32)
    je = jserve.Engine(jget(ARCH), jp, _policy(JPolicy), max_len=10, value_bits=4)
    te = serve.Engine(tget(ARCH), tp, _policy(TPolicy), max_len=10, value_bits=4, device="cpu")
    want, _ = je.generate(jnp.asarray(prompts), 4)
    got, _ = te.generate(prompts, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the narrow values changed the weights: 8-bit values give other tokens
    full = serve.Engine(tget(ARCH), tp, _policy(TPolicy), max_len=10, device="cpu")
    leaf = te.q_params["lm_head"]["head"]["w_q"]
    assert leaf.abs().max() <= 7 < full.q_params["lm_head"]["head"]["w_q"].abs().max()


def test_cb_engine_value_bits_equals_reference():
    jp, tp = _params()
    rng = np.random.default_rng(3)
    lens = (5, 9, 7)
    toks = [rng.integers(0, jget(ARCH).vocab_size, (s,)) for s in lens]

    def reqs(cls):
        return [cls(rid=i, tokens=t, max_new_tokens=4, arrival_step=i) for i, t in enumerate(toks)]

    je = jserve.ContinuousBatchingEngine(jget(ARCH), jp, _policy(JPolicy), n_slots=2,
                                         max_len=14, value_bits=4)
    te = serve.ContinuousBatchingEngine(tget(ARCH), tp, _policy(TPolicy), n_slots=2,
                                        max_len=14, value_bits=4, device="cpu")
    want, _ = je.run(reqs(JRequest))
    got, stats = te.run(reqs(TRequest))
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"rid {rid}")
    assert stats["plans"] == dict(te.plan_stats())
    assert (stats["plans"]["store_hits"], stats["plans"]["tunes"]) == (0, 0)


# --------------------------------------------------------------------------
# serve --autotune --plan-store on the host
# --------------------------------------------------------------------------

CLI = ["--reduced", "--bits", "8", "--level", "bitplane", "--prompt-lens", "5,9", "--gen", "3"]
PLANS = re.compile(r"plans: (\d+) resolved \(registry \d+ hits / \d+ misses\), store (\d+) "
                   r"hits / (\d+) misses, (\d+) tuned, host (\S+)")


def _rids(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("[serve] rid ")]


def _port_cli(capsys, argv) -> str:
    tplan.DEFAULT_REGISTRY.clear()
    tplan.DEFAULT_REGISTRY.attach_tuner(None)  # each run a process of its own
    try:
        serve.main(argv)
    finally:
        tplan.DEFAULT_REGISTRY.attach_tuner(None)
    return capsys.readouterr().out


def _ref_cli(capsys, monkeypatch, argv) -> str:
    jplan.DEFAULT_REGISTRY.clear()
    jplan.DEFAULT_REGISTRY.attach_tuner(None)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    try:
        jserve.main()
    finally:
        jplan.DEFAULT_REGISTRY.attach_tuner(None)
        jplan.DEFAULT_REGISTRY.clear()
    return capsys.readouterr().out


def test_cli_autotune_plan_store_matches_reference(capsys, monkeypatch, tmp_path):
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    plain = _port_cli(capsys, CLI + ["--device", "cpu"])
    cold = _port_cli(capsys, CLI + ["--device", "cpu", "--autotune", "--plan-store", path])
    warm = _port_cli(capsys, CLI + ["--device", "cpu", "--autotune", "--plan-store", path])
    ref = _ref_cli(capsys, monkeypatch, CLI + ["--autotune", "--plan-store", jpath])
    (c_res, c_hit, c_miss, c_tune, fp), = PLANS.findall(cold)
    (w_res, w_hit, w_miss, w_tune, _), = PLANS.findall(warm)
    (r_res, r_hit, r_miss, r_tune, _), = PLANS.findall(ref)
    assert (c_res, c_hit, c_miss, c_tune) == (r_res, r_hit, r_miss, r_tune)
    assert int(c_tune) > 0 and (c_hit, c_miss, c_tune) == ("0", c_res, c_res)
    assert (w_res, w_hit, w_miss, w_tune) == (c_res, c_tune, "0", "0")
    assert _rids(plain) and _rids(cold) == _rids(plain) == _rids(warm)
    assert "autotuned" in cold and "plans:" not in plain
    # the stores hold the same plans under the same key ids, backends mapped
    ours = PlanStore(path)._load()["hosts"][fp]
    theirs = next(iter(JPlanStore(jpath)._load()["hosts"].values()))
    assert {k.replace('"backend":"torch"', '"backend":"jnp"') for k in ours} == set(theirs)
    for kid, rec in ours.items():
        want = theirs[kid.replace('"backend":"torch"', '"backend":"jnp"')]
        assert (rec["kernel"], rec["source"], rec["candidates"]) == (
            want["kernel"], want["source"], want["candidates"])
        assert rec["k_split"] == 1


def test_plan_store_without_autotune_dies_with_the_reference_message():
    msgs = []
    for mod in (serve, jserve):
        args = mod.build_parser().parse_args(["--plan-store", "plans.json"])
        with pytest.raises(SystemExit) as exc:
            mod.validate_args(args)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert "--plan-store needs --autotune" in msgs[0]
    args = serve.build_parser().parse_args(["--autotune", "--plan-store", "plans.json"])
    serve.validate_args(args)  # accepted together


def test_engines_share_one_tuner_per_store_and_calibrate_from_the_port_report(
        tmp_path, monkeypatch):
    """Engines of one process on one store share the tuner (and its memo), a
    new store gets its own; the model's row is the engine device's builtin
    one unless BENCH_TORCH_KERNEL_JSON names a kernel report (the reference's
    BENCH_kernel.json is never read); plan_store_path needs autotune."""
    from repro_torch.core import autotune

    _, tp = _params()
    tc, pol = tget(ARCH), _policy(TPolicy)
    report = tmp_path / "report.json"
    report.write_text(
        '{"host": "unit", "benches": {"fused_linear": {"configs": [{"shape": [4, 256, 128], '
        '"mxu_passes": 2, "wall_us": {"cuda_fused": 10.0}, "bytes": {"fused_hbm_bytes": 9000}}]}}}')
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_kernel.json").write_text(report.read_text().replace("cuda_", "interpret_"))
    monkeypatch.delenv("BENCH_TORCH_KERNEL_JSON", raising=False)
    try:
        tplan.DEFAULT_REGISTRY.attach_tuner(None)
        a = serve.Engine(tc, tp, pol, max_len=8, device="cpu", autotune=True,
                         plan_store_path=str(tmp_path / "a.json"))
        b = serve.ContinuousBatchingEngine(tc, tp, pol, n_slots=2, max_len=8, device="cpu",
                                           autotune=True, plan_store_path=str(tmp_path / "a.json"))
        assert b.autotuner is a.autotuner is tplan.DEFAULT_REGISTRY.tuner
        assert a.autotuner.hw == autotune.hardware_model("cpu")
        monkeypatch.setenv("BENCH_TORCH_KERNEL_JSON", str(report))
        c = serve.Engine(tc, tp, pol, max_len=8, device="cpu", autotune=True,
                         plan_store_path=str(tmp_path / "c.json"))
        assert c.autotuner is not a.autotuner and tplan.DEFAULT_REGISTRY.tuner is c.autotuner
        assert c.autotuner.hw.source == "calibrated:unit"
        assert c.autotuner.hw.hbm_bw == pytest.approx(9000 / 10e-6)
        assert c.plan_stats()["hardware_source"] == "calibrated:unit"
    finally:
        tplan.DEFAULT_REGISTRY.attach_tuner(None)
    with pytest.raises(ValueError, match="plan_store_path requires autotune"):
        serve.Engine(tc, tp, pol, max_len=8, device="cpu", plan_store_path="p.json")
    untuned = serve.Engine(tc, tp, pol, max_len=8, device="cpu")
    assert untuned.autotuner is None
    assert {k: untuned.plan_stats()[k] for k in ("store_hits", "store_misses", "tunes")} == {
        "store_hits": 0, "store_misses": 0, "tunes": 0}


def test_an_untuned_engine_detaches_an_earlier_engines_tuner(tmp_path):
    """The engine built last decides: one built with autotune=False after a
    tuned one runs no tuned plan and reports no tuner's counters, with no
    cleanup by its caller; its tokens are the tuned engine's."""
    _, tp = _params()
    tc, pol = tget(ARCH), _policy(TPolicy)
    prompts = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 6)).astype(np.int32)
    tplan.DEFAULT_REGISTRY.clear()
    tuned = serve.Engine(tc, tp, pol, max_len=10, device="cpu", autotune=True,
                         plan_store_path=str(tmp_path / "p.json"))
    want, _ = tuned.generate(prompts, 3)
    assert tuned.plan_stats()["tunes"] > 0
    assert any(p.tuned for p in tplan.DEFAULT_REGISTRY.plans())
    plain = serve.Engine(tc, tp, pol, max_len=10, device="cpu")
    assert tplan.DEFAULT_REGISTRY.tuner is None
    assert not any(p.tuned for p in tplan.DEFAULT_REGISTRY.plans())
    got, _ = plain.generate(prompts, 3)
    assert not any(p.tuned for p in tplan.DEFAULT_REGISTRY.plans())
    assert {k: plain.plan_stats()[k] for k in ("store_hits", "store_misses", "tunes")} == {
        "store_hits": 0, "store_misses": 0, "tunes": 0}
    np.testing.assert_array_equal(got.numpy(), want.numpy())
