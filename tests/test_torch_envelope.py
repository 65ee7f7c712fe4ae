"""Port parity of the 1-16-bit envelope, on the CPU.

Beyond 8 bits the reference accumulates the plain bit-serial product in
float32 (``make_plan``'s accumulator rule) and serves every projection
from its oracle route, decomposing the weight on every call. Held against
the JAX package on the same seeded inputs:

* ``bitserial_matmul`` at (a_bits, w_bits) in {(9, 9), (12, 16), (16, 16)},
  both levels and variants, int32 and float32 accumulation, fully serial
  and serial-parallel — bit-equal (every pair product is exact at these
  widths, and the float32 sum runs in the reference's pair order);
* the plan's accumulator and route per width, and the oracle's output
  through the epilogue — equal;
* ``truncation_audit`` over registries of dialed plans (cached: ok;
  re-decomposing: not ok; none: not ok) and ``sparsity_stats`` — equal;
* ``dequantize``, ``dequantize_kv`` — bit-equal; ``quantization_error`` (a
  float32 mean, summed in another order) within 1e-6 relative;
* prefill logits at 12 and 16 bits at both levels — bit-equal; the
  continuous-batching engine's tokens at 12 and 16 bits, both levels, and
  at 8 bits with ``sparsity`` gate and compact and without the plane
  cache — equal to the reference engine's (the reference's sparsity modes
  and plane cache change no token, so its 8-bit engine is their yardstick).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core import bitplanes as jbp
from repro.core import bitserial as jbs
from repro.core import plan as jplan
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.core.quantize import dequantize as jdequantize
from repro.core.quantize import quantization_error as jquantization_error
from repro.core.quantize import quantize as jquantize
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models.cache import dequantize_kv as jdequantize_kv
from repro.models.cache import quantize_kv as jquantize_kv
from repro.models.quant import quantize_params as jquantize_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core import bitplanes as tbp
from repro_torch.core import bitserial as tbs
from repro_torch.core import plan as tplan
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.quantize import dequantize as tdequantize
from repro_torch.core.quantize import quantization_error as tquantization_error
from repro_torch.core.quantize import quantize as tquantize
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.cache import dequantize_kv as tdequantize_kv
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import t2n, to_numpy_tree, weight_planes_to_jax

ARCH = "granite-3-8b"
CPU = torch.device("cpu")
WIDTHS = ((9, 9), (12, 16), (16, 16))


def _ints(rng, bits, shape):
    lo, hi = jbp.signed_range(bits)
    return rng.integers(lo, hi + 1, shape).astype(np.int32)


# --------------------------------------------------------------------------
# bitserial_matmul
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fully_serial", "serial_parallel"])
@pytest.mark.parametrize("level, variant", [("bitplane", "booth"), ("bitplane", "sbmwc"),
                                            ("digit", "booth"), ("digit", "sbmwc")])
@pytest.mark.parametrize("bits", WIDTHS, ids=lambda b: f"a{b[0]}w{b[1]}")
def test_bitserial_matmul_equals_reference(bits, level, variant, mode):
    """Both accumulators; the extremes of each width ride in the operands.
    The serial-parallel digit case keeps K at 4: its products (a digit of at
    most 2^7 times a weight of at most 2^15, summed over K) are exact in
    float32 only while K * 2^22 <= 2^24, and only exact products are
    independent of the matmul's summation order."""
    a_bits, w_bits = bits
    rng = np.random.default_rng(a_bits * 100 + w_bits)
    k = 4 if (mode, level) == ("serial_parallel", "digit") else 40
    a = _ints(rng, a_bits, (3, 2, k))
    w = _ints(rng, w_bits, (k, 5))
    a[0, 0, :3] = jbp.signed_range(a_bits)[0], jbp.signed_range(a_bits)[1], 0
    w[:3, 0] = jbp.signed_range(w_bits)[0], jbp.signed_range(w_bits)[1], 0
    exact = (a.reshape(-1, k).astype(np.int64) @ w.astype(np.int64)).reshape(3, 2, 5)
    for jdt, tdt in ((jnp.int32, torch.int32), (jnp.float32, torch.float32)):
        kw = dict(a_bits=a_bits, w_bits=w_bits, variant=variant, level=level, mode=mode)
        got_j = np.asarray(jbs.bitserial_matmul(jnp.asarray(a), jnp.asarray(w),
                                                accum_dtype=jdt, **kw))
        got_t = tbs.bitserial_matmul(torch.from_numpy(a), torch.from_numpy(w),
                                     accum_dtype=tdt, **kw)
        assert got_t.dtype == tdt
        np.testing.assert_array_equal(got_j, t2n(got_t), err_msg=str(tdt))
        if tdt == torch.int32:  # modular: the true product mod 2^32
            np.testing.assert_array_equal(t2n(got_t), exact.astype(np.int32))


def test_fused_level_and_booth_third_digit_pair():
    """Level "fused" (one product), and Booth's redundant third digit pair at
    16 bits: weight 2^32, which vanishes in int32 and counts in float32 —
    the reference's behaviour per accumulator."""
    rng = np.random.default_rng(7)
    a = _ints(rng, 16, (4, 16))
    w = _ints(rng, 16, (16, 3))
    a[:, :] = np.where(rng.random(a.shape) < 0.5, -(1 << 15), (1 << 15) - 1)
    w[:, :] = -(1 << 15)
    for level, (jdt, tdt) in itertools.product(
            ("fused", "digit"), ((jnp.int32, torch.int32), (jnp.float32, torch.float32))):
        kw = dict(a_bits=16, w_bits=16, level=level)
        np.testing.assert_array_equal(
            np.asarray(jbs.bitserial_matmul(jnp.asarray(a), jnp.asarray(w), accum_dtype=jdt,
                                            **kw)),
            t2n(tbs.bitserial_matmul(torch.from_numpy(a), torch.from_numpy(w),
                                     accum_dtype=tdt, **kw)), err_msg=f"{level} {tdt}")


# --------------------------------------------------------------------------
# Plans: accumulator, route, audit, sparsity stats
# --------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["bitplane", "digit"])
def test_plan_accumulator_route_and_output_equal_reference(level):
    rng = np.random.default_rng(1)
    for bits in (4, 8, 9, 12, 16):
        jpol, tpol = (JPolicy.uniform(bits, bits, level=level),
                      TPolicy.uniform(bits, bits, level=level))
        jp = jplan.make_plan(jpol, "x", (4, 32, 6), "jnp", registry=jplan.PlanRegistry())
        tp = tplan.make_plan(tpol, "x", (4, 32, 6), "torch", device=CPU,
                             registry=tplan.PlanRegistry())
        assert (jp.kernel, jp.key.accum) == (tp.kernel, tp.key.accum), bits
        assert tp.key.accum == ("int32" if bits <= 8 else "float32")
        x = _ints(rng, bits, (4, 32))
        w = _ints(rng, bits, (32, 6))
        a_scale = rng.random((4, 1)).astype(np.float32)
        w_scale = rng.random((6,)).astype(np.float32)
        got_j = jp(jnp.asarray(x), jnp.asarray(w), epilogue=jops.Epilogue(
            a_scale=jnp.asarray(a_scale), w_scale=jnp.asarray(w_scale), out_dtype=jnp.float32))
        got_t = tp(torch.from_numpy(x), torch.from_numpy(w), epilogue=tops.Epilogue(
            a_scale=torch.from_numpy(a_scale), w_scale=torch.from_numpy(w_scale),
            out_dtype=torch.float32))
        np.testing.assert_array_equal(np.asarray(got_j), t2n(got_t), err_msg=str(bits))


def _registry_plans(mod, reg, cache, device_kw):
    for a, wb in ((8, 8), (6, 6), (4, 4)):
        mod.plan_for_operands((4, 64, 8), a_bits=a, w_bits=wb, a_in_bits=8, w_in_bits=8,
                              level="bitplane", backend="jnp" if mod is jplan else "torch",
                              has_epilogue=True, w_planes=cache, registry=reg, **device_kw)


def test_truncation_audit_equals_reference():
    rng = np.random.default_rng(2)
    w = rng.integers(-128, 128, (64, 8)).astype(np.int32)
    tw = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant="booth",
                                level="bitplane")
    jw = weight_planes_to_jax(tw)
    for cached in (True, False):
        jreg, treg = jplan.PlanRegistry(), tplan.PlanRegistry()
        _registry_plans(jplan, jreg, jw if cached else None, {})
        _registry_plans(tplan, treg, tw if cached else None, {"device": CPU})
        got_j, got_t = jplan.truncation_audit(jreg), tplan.truncation_audit(treg)
        assert got_j == got_t
        assert got_t["dialed_plans"] == 2 and got_t["truncated_ok"] is cached
    empty = tplan.truncation_audit(tplan.PlanRegistry())
    assert empty == jplan.truncation_audit(jplan.PlanRegistry())
    assert empty["truncated_ok"] is False


@pytest.mark.parametrize("compact", [False, True])
def test_sparsity_stats_equal_reference(compact):
    """A weight whose top planes are zero and whose K range is half empty:
    the passes skipped by compaction and by the occupancy gate, at the
    storage width and dialed to 6 bits."""
    rng = np.random.default_rng(3)
    w = rng.integers(-8, 8, (1024, 8)).astype(np.int32)
    w[512:] = 0
    tw = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant="booth",
                                level="bitplane")
    if compact:
        tw = tbp.compact_weight_planes(tw)
    jw = weight_planes_to_jax(tw)
    for a_bits, w_bits in ((8, 8), (6, 6)):
        kw = dict(a_bits=a_bits, w_bits=w_bits, a_in_bits=8, w_in_bits=8, level="bitplane",
                  has_epilogue=True, sparsity="compact" if compact else "gate")
        jp = jplan.plan_for_operands((4, 1024, 8), backend="pallas", w_planes=jw,
                                     registry=jplan.PlanRegistry(), **kw)
        tp = tplan.plan_for_operands((4, 1024, 8), backend="cuda", device=torch.device("cuda"),
                                     w_planes=tw, registry=tplan.PlanRegistry(), **kw)
        got_j, got_t = jp.sparsity_stats(jw), tp.sparsity_stats(tw)
        assert got_j == got_t
        assert got_t["pair_passes_skipped"] > 0
        assert tp.sparsity_stats()["kernel"] == jp.sparsity_stats()["kernel"]


# --------------------------------------------------------------------------
# Dequantization
# --------------------------------------------------------------------------


def test_dequantize_and_quantization_error_equal_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    for bits, axis in itertools.product((2, 4, 8, 12, 16), (None, 0, -1)):
        jq, tq = jquantize(jnp.asarray(x), bits, axis=axis), tquantize(torch.from_numpy(x), bits,
                                                                       axis=axis)
        np.testing.assert_array_equal(np.asarray(jdequantize(jq)), t2n(tdequantize(tq)))
        got_j = float(jquantization_error(jnp.asarray(x), bits, axis=axis))
        got_t = float(tquantization_error(torch.from_numpy(x), bits, axis=axis))
        assert got_t == pytest.approx(got_j, rel=1e-6), (bits, axis)
    # the same int8 KV and scales in both (the port's quantize_kv repeats the
    # reference's compiled scale, its eager one divides)
    kv = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    jqk, js = jquantize_kv(jnp.asarray(kv))
    tqk, ts = torch.from_numpy(np.asarray(jqk).copy()), torch.from_numpy(np.asarray(js).copy())
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            np.asarray(jdequantize_kv(jqk, js, dt_j).astype(jnp.float32)),
            t2n(tdequantize_kv(tqk, ts, dt_t)))


# --------------------------------------------------------------------------
# The model at 12 and 16 bits, and the 8-bit sparsity / cache modes
# --------------------------------------------------------------------------

_S: dict = {}


def _params():
    if "p" not in _S:
        jp = jax.jit(lambda k: jinit(jget(ARCH), k))(jax.random.PRNGKey(0))
        _S["p"] = (jp, params_from_numpy(tget(ARCH), to_numpy_tree(jp), device="cpu"))
    return _S["p"]


def _jquant(bits, level):
    """The reference's quantized tree, quantized once per configuration
    (beyond 8 bits it holds no planes, so one tree serves both levels)."""
    key = (bits, level if bits <= 8 else None)
    if key not in _S:
        _S[key] = jquantize_params(_params()[0], JPolicy.uniform(bits, bits, level=level),
                                   plane_cache=True)
    return _S[key]


ENVELOPE = [(bits, level) for bits in (12, 16) for level in ("bitplane", "digit")]


@pytest.mark.parametrize("bits, level", ENVELOPE)
def test_prefill_logits_equal_reference(bits, level):
    jp, tp = _params()
    jc, tc = jget(ARCH), tget(ARCH)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (1, 9)).astype(np.int32)
    jpol, tpol = (JPolicy.uniform(bits, bits, level=level),
                  TPolicy.uniform(bits, bits, level=level))
    lj, _, _ = jax.jit(lambda p, t: jforward(jc, p, {"tokens": t}, policy=jpol))(
        _jquant(bits, level), jnp.asarray(toks))
    tq = tquantize_params(tp, tpol, cfg=tc, plane_cache=True)
    assert "w_planes" not in tq["lm_head"]["head"]  # no cache beyond 8 bits
    lt, _ = make_prefill_step(tc, tpol)(tq, torch.from_numpy(toks))
    np.testing.assert_array_equal(np.asarray(lj[:, -1, :]).astype(np.float32), t2n(lt))


def _requests(cls, vocab):
    rng = np.random.default_rng(6)
    return [cls(rid=i, tokens=rng.integers(0, vocab, (6,)), max_new_tokens=4,
                arrival_step=i) for i in range(3)]


def _jax_tokens(bits, level):
    key = ("run", bits, level)
    if key not in _S:
        jp, _ = _params()
        tree = _jquant(bits, level)
        orig = jserve.quantize_params
        jserve.quantize_params = lambda *a, **k: tree
        try:
            eng = jserve.ContinuousBatchingEngine(
                jget(ARCH), jp, JPolicy.uniform(bits, bits, level=level), n_slots=2, max_len=10)
        finally:
            jserve.quantize_params = orig
        _S[key] = eng.run(_requests(JRequest, jget(ARCH).vocab_size))[0]
    return _S[key]


@pytest.mark.parametrize("bits, level, mode", [(b, lv, "plain") for b, lv in ENVELOPE] + [
    (8, "bitplane", "gate"), (8, "bitplane", "compact"), (8, "bitplane", "no_plane_cache")])
def test_engine_tokens_equal_reference(bits, level, mode):
    tc = tget(ARCH)
    tpol = TPolicy.uniform(bits, bits, level=level,
                           sparsity=mode if mode in ("gate", "compact") else "off")
    eng = TEngine(tc, _params()[1], tpol, n_slots=2, max_len=10, device="cpu",
                  plane_cache=mode != "no_plane_cache")
    got, stats = eng.run(_requests(TRequest, tc.vocab_size))
    want = _jax_tokens(bits, level)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"rid {rid}")
    routes = set(stats["route_calls"])
    assert routes == ({"oracle"} if bits > 8 or mode == "no_plane_cache" else {"cached_scan"})
