"""Port parity of the slice as a whole: the quantized weight tree, the
prefill logits, and the continuous-batching engine's greedy tokens, held
against the JAX reference on reduced granite-3-8b and yi-6b.

Logits of the quantized forward are bit-equal to the reference's compiled
forward: the port repeats its float32 operation order, including where
XLA keeps excess precision (the residual sum into the next norm's
statistics, the gate*up product into the down projection's quantizer)
and its scale ``amax * (1/qmax)``. The dense (unquantized) forward is held
within 4 bf16 steps: its bf16 matmuls sum in another order. The engines must emit the
same greedy tokens (temperature > 0 cannot match across PRNGs).

The reference quantizes its weights eagerly, op by op, which compiles
every primitive once per process; the tests that need its quantized tree
live in this one file so they share those compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.models.quant import quantize_params as jquantize_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import sampling, serve
from repro_torch.launch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import forward as tforward
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import t2n, to_numpy_tree

_PARAMS: dict = {}
_JQ: dict = {}


def _params(arch):
    """(JAX params, port params) from one JAX init per module."""
    if arch not in _PARAMS:
        jp = jax.jit(lambda k: jinit(jget(arch), k))(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_numpy(tget(arch), to_numpy_tree(jp), device="cpu"))
    return _PARAMS[arch]


def _jquant(arch, level):
    """The reference's quantized tree (eager, as its engines build it)."""
    if (arch, level) not in _JQ:
        _JQ[arch, level] = jquantize_params(
            _params(arch)[0], JPolicy.uniform(8, 8, level=level), plane_cache=True)
    return _JQ[arch, level]


@pytest.mark.parametrize("level", ["bitplane", "digit"])
def test_quantize_params_tree_equals_reference(level):
    jq = _jquant("granite-3-8b", level)
    tq = tquantize_params(_params("granite-3-8b")[1], TPolicy.uniform(8, 8, level=level),
                          cfg=tget("granite-3-8b"), plane_cache=True)
    pairs = [(jq["lm_head"]["head"], tq["lm_head"]["head"], None)]
    jb = jq["periods"]["b0_dense"]
    for i, blk in enumerate(tq["layers"]):
        for grp, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                           ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            pairs += [(jb[grp][nm], blk[grp][nm], i) for nm in names]
    for jl, tl, i in pairs:
        pick = (lambda a: a) if i is None else (lambda a, i=i: a[i])
        np.testing.assert_array_equal(np.asarray(pick(jl["w_q"])), t2n(tl["w_q"]))
        np.testing.assert_array_equal(np.asarray(pick(jl["w_scale"])), t2n(tl["w_scale"]))
        jw, tw = jl["w_planes"], tl["w_planes"]
        assert jw.weights == tw.weights and jw.level == tw.level
        np.testing.assert_array_equal(np.asarray(pick(jw.planes)), t2n(tw.planes))
        if level == "bitplane":
            assert jw.packed.block == tw.packed.block
            for a, b in ((jw.packed.mag, tw.packed.mag), (jw.packed.sign, tw.packed.sign),
                         (jw.packed.occupancy, tw.packed.occupancy)):
                np.testing.assert_array_equal(np.asarray(pick(a)), t2n(b))


@pytest.mark.parametrize("arch", ["granite-3-8b", "yi-6b"])
@pytest.mark.parametrize("level", ["bitplane", "digit", "dense"])
def test_prefill_logits_equal_reference(arch, level, rng):
    jp, tp = _params(arch)
    jc, tc = jget(arch), tget(arch)
    toks = rng.integers(0, jc.vocab_size, (1, 17)).astype(np.int32)
    if level == "dense":
        jpol, tpol, jpar, tpar = None, None, jp, tp
    else:
        jpol, tpol = JPolicy.uniform(8, 8, level=level), TPolicy.uniform(8, 8, level=level)
        jpar = _jquant(arch, level)
        tpar = tquantize_params(tp, tpol, cfg=tc, plane_cache=True)
    lj, _, _ = jax.jit(lambda p, t: jforward(jc, p, {"tokens": t}, policy=jpol))(
        jpar, jnp.asarray(toks))
    lt, _, _ = tforward(tc, tpar, {"tokens": torch.from_numpy(toks)}, policy=tpol)
    lj = np.asarray(lj).astype(np.float32)
    if level == "dense":
        # bf16 matmuls round their outputs after float32 sums taken in
        # another order: a flipped rounding moves a logit by one bf16 step
        # (2^-6 at |logit| in [2, 4)); held within 4 such steps
        np.testing.assert_allclose(lj, t2n(lt), atol=4 * 2.0**-6, rtol=0)
        assert (lj.argmax(-1) == t2n(lt).argmax(-1)).mean() >= 0.9
    else:
        np.testing.assert_array_equal(lj, t2n(lt))
        assert (lj.argmax(-1) == t2n(lt).argmax(-1)).all()


PROMPT_LENS = (5, 9, 17)
GEN = 6


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, (s,)) for s in PROMPT_LENS]


@pytest.mark.parametrize("arch", ["granite-3-8b", "yi-6b"])
@pytest.mark.parametrize("level", ["bitplane", "digit"])
def test_cb_engine_greedy_tokens_equal_reference(arch, level):
    """Staggered mixed-length requests through 2 slots with int8 KV: the
    port's engine (plain versions on the CPU) emits the reference engine's
    tokens; on granite at bitplane level across an 8 -> 4 bit switch at
    decode step 3 (the two earlier prompts prefill at 8 bits, the last at
    4; yi at bitplane level serves all at 8)."""
    jp, tp = _params(arch)
    jc, tc = jget(arch), tget(arch)
    prompts = _prompts(jc.vocab_size)
    sched = {3: 4} if (arch, level) == ("granite-3-8b", "bitplane") else None
    je = JEngine(jc, jp, JPolicy.uniform(8, 8, level=level), n_slots=2, max_len=24)
    te = TEngine(tc, tp, TPolicy.uniform(8, 8, level=level), n_slots=2, max_len=24,
                 device="cpu")
    rj, sj = je.run([JRequest(rid=i, tokens=p, max_new_tokens=GEN, arrival_step=2 * i)
                     for i, p in enumerate(prompts)], precision_schedule=sched)
    rt, st = te.run([TRequest(rid=i, tokens=p, max_new_tokens=GEN, arrival_step=2 * i)
                     for i, p in enumerate(prompts)], precision_schedule=sched)
    assert sorted(rj) == sorted(rt) == [0, 1, 2]
    for rid in rj:
        np.testing.assert_array_equal(rj[rid], rt[rid], err_msg=f"rid {rid} {sched}")
    assert sj["precision_switches"] == st["precision_switches"]
    assert len(st["precision_switches"]) == (1 if sched else 0)
    assert sj["decode_steps"] == st["decode_steps"]
    assert set(st["route_calls"]) == {"cached_scan"}  # the host route of both packages


def test_temperature_zero_rows_are_exactly_greedy():
    g = torch.Generator()
    g.manual_seed(3)
    logits = torch.randn((4, 50), generator=g)
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7])
    tok = sampling.sample_tokens(logits, temps, g)
    greedy = sampling.greedy(logits)
    assert tok[0] == greedy[0] and tok[2] == greedy[2]
    masked = sampling.mask_vocab(logits, 40)
    assert int(sampling.greedy(masked).max()) < 40


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """With no GPU and no explicit device the entry points raise instead of
    running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget("granite-3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(cfg, _params("granite-3-8b")[1], TPolicy.uniform(8, 8), n_slots=1,
                max_len=8)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--reduced", "--prompt-lens", "4", "--gen", "2"])


def test_cli_serves_on_the_host_when_asked(capsys):
    serve.main(["--reduced", "--bits", "8", "--level", "bitplane", "--n-slots", "2",
                "--prompt-lens", "4,7", "--gen", "3", "--precision-switch", "1:4",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2 requests" in out and "precision switch at decode step 1: -> (4, 4)" in out
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--level", "digit", "--precision", "4", "--device", "cpu"])
