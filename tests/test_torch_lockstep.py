"""Port parity of the lockstep engine and of the serving CLI, on the CPU.

On reduced granite-3-8b (layers unrolled, so one quantized tree, the
port's, serves both packages: the reference's engine is handed it in place
of its eager quantization, as in ``test_torch_scrub.py``):

* ``Engine.generate`` gives the reference's tokens at both levels, after an
  8 -> 4 dial, through a ``sample_fn`` hook (a deterministic sampler both
  packages can run), and with the plane cache on and off;
* under detect, one flipped weight bit gives the reference's
  ``last_alarms`` (prefill, audits and decode steps each count); under
  scrub the tokens equal the clean run's;
* the port's continuous batching with ``kv_quant=False`` equals a
  per-request lockstep run at mixed prompt lengths and staggered arrivals
  through fewer slots than requests (the reference's serving contract,
  ``tests/test_serving.py``);
* ``validate_args`` dies with the reference's message for every invalid
  combination of the flags the two share (``--model-parallel`` among
  them); ``--model-parallel 2`` on the host serves the ``--model-parallel
  1`` tokens from two spawned ranks.
"""

import contextlib
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
from repro.models.transformer import init_params as jinit
from repro_torch.configs import get_reduced as tget
from repro_torch.core import bitplanes as tbp
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import serve
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request

from _torch_parity import StubRunner, quantized_to_jax, t2n, to_numpy_tree

ARCH = "granite-3-8b"
GEN = 5

_S: dict = {}


def _setup():
    if not _S:
        jc = dataclasses.replace(jget(ARCH), scan_layers=False)
        tc = dataclasses.replace(tget(ARCH), scan_layers=False)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        _S.update(jc=jc, tc=tc, jp=jp, tp=params_from_numpy(tc, to_numpy_tree(jp), device="cpu"))
    return _S


@contextlib.contextmanager
def _given_tree(tree):
    orig = jserve.quantize_params
    jserve.quantize_params = lambda *a, **k: quantized_to_jax(tree)
    try:
        yield
    finally:
        jserve.quantize_params = orig


def _prompts(vocab, b=2, s=6, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _shifted_argmax_t(logits, gen=None):
    return ((torch.argmax(logits, dim=-1) + 1) % logits.shape[-1]).to(torch.int32)


def _shifted_argmax_j(logits, key=None):
    return ((jnp.argmax(logits, axis=-1) + 1) % logits.shape[-1]).astype(jnp.int32)


def _pair(level, plane_cache=True, integrity="off", sample=False, **kw):
    """A port engine and the reference's, on the port's quantized tree."""
    st = _setup()
    te = serve.Engine(st["tc"], st["tp"],
                      TPolicy.uniform(8, 8, level=level, integrity=integrity),
                      max_len=6 + GEN, plane_cache=plane_cache, device="cpu",
                      sample_fn=_shifted_argmax_t if sample else None, **kw)
    with _given_tree(te.q_params):
        je = jserve.Engine(st["jc"], st["jp"],
                           JPolicy.uniform(8, 8, level=level, integrity=integrity),
                           max_len=6 + GEN, plane_cache=plane_cache,
                           sample_fn=_shifted_argmax_j if sample else None, **kw)
    return te, je


CASES = {
    "bitplane": dict(level="bitplane"),
    "digit": dict(level="digit"),
    "bitplane-dial-8-4": dict(level="bitplane", dial=4),
    "bitplane-sample_fn": dict(level="bitplane", sample=True),
    "bitplane-no-plane-cache": dict(level="bitplane", plane_cache=False),
    "digit-no-plane-cache": dict(level="digit", plane_cache=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_equals_reference(case):
    kw = dict(CASES[case])
    dial = kw.pop("dial", None)
    te, je = _pair(**kw)
    prompts = _prompts(_setup()["tc"].vocab_size)
    if dial:
        # 8 bits, then the dialed width: the same engines serve both
        for eng in (te, je):
            eng.generate(prompts, GEN)
            eng.set_precision(dial)
    got, tps = te.generate(prompts, GEN)
    want, _ = je.generate(jnp.asarray(prompts), GEN)
    np.testing.assert_array_equal(np.asarray(want), t2n(got))
    assert got.shape == (2, GEN) and got.dtype == torch.int32 and tps > 0


def _flip(tree):
    """Flip one bit of a top-plane word of the first q projection, in place,
    and write the flipped plane into the cache's raw planes too: on the host
    the port's route reads those, the reference's the packed words, and
    both must consume the flipped value for the ABFT check to see it."""
    wp = tree["layers"][0]["attn"]["q_proj"]["w_planes"]
    wp.packed.mag[-1, 0, 0] ^= 1
    if wp.planes is not None:
        wp.planes.copy_(tbp.unpack_planes(wp.packed).to(wp.planes.dtype))


@pytest.mark.parametrize("audit_interval", [1, 0])
def test_detect_alarms_equal_reference(audit_interval):
    te, je = _pair("bitplane", integrity="detect", audit_interval=audit_interval)
    prompts = _prompts(_setup()["tc"].vocab_size)
    clean, _ = te.generate(prompts, GEN)
    je.generate(jnp.asarray(prompts), GEN)
    assert te.last_alarms == je.last_alarms == 0
    _flip(te.q_params)
    je.q_params = quantized_to_jax(te.q_params)
    got, _ = te.generate(prompts, GEN)
    want, _ = je.generate(jnp.asarray(prompts), GEN)
    np.testing.assert_array_equal(np.asarray(want), t2n(got))
    assert te.last_alarms == je.last_alarms >= 1


def test_scrub_keeps_tokens_and_addresses():
    """Scrub mode: the flipped bit is found (by the audit, or by ABFT with
    audits off, which retries the step from its pre-step state) and
    repaired in place; the tokens equal the clean run's, here and through
    the replayed-graph path (the stub runner)."""
    st = _setup()
    policy = TPolicy.uniform(8, 8, level="bitplane", integrity="scrub")
    prompts = _prompts(st["tc"].vocab_size)
    for audit_interval, runner in ((1, None), (0, None), (0, StubRunner)):
        te = serve.Engine(st["tc"], st["tp"], policy, max_len=6 + GEN, device="cpu",
                          audit_interval=audit_interval)
        if runner is not None:
            te._runner = runner
        clean, _ = te.generate(prompts, GEN)
        ptrs = [t.data_ptr() for t in serve.integrity._leaves(te.q_params)]
        _flip(te.q_params)
        got, _ = te.generate(prompts, GEN)
        np.testing.assert_array_equal(t2n(clean), t2n(got))
        assert te.last_alarms >= 1 and te._scrubs == 1
        assert ptrs == [t.data_ptr() for t in serve.integrity._leaves(te.q_params)]
        if runner is not None:
            assert set(te._compiled_graphs) == {None}


def test_graph_replay_equals_eager_generate():
    """The decode step through the stub graph runner (captured once per
    precision on the static state, replayed) gives the eager tokens."""
    st = _setup()
    policy = TPolicy.uniform(8, 8, level="bitplane")
    prompts = _prompts(st["tc"].vocab_size)
    eager = serve.Engine(st["tc"], st["tp"], policy, max_len=6 + GEN, device="cpu")
    graph = serve.Engine(st["tc"], st["tp"], policy, max_len=6 + GEN, device="cpu")
    graph._runner = StubRunner
    for prec in (None, 4):
        for eng in (eager, graph):
            eng.set_precision(prec)
        want, _ = eager.generate(prompts, GEN)
        got, _ = graph.generate(prompts, GEN)
        np.testing.assert_array_equal(t2n(want), t2n(got))
    assert set(graph._compiled_graphs) == {None, (4, 4)}
    # one replay per decode step of each generate
    assert sum(g.runner.replays for g in graph._compiled_graphs.values()) == 2 * (GEN - 1)


@pytest.mark.parametrize("level", ["bitplane", "digit"])
def test_cb_without_kv_quant_equals_lockstep_per_request(level):
    st = _setup()
    policy = TPolicy.uniform(8, 8, level=level)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, tokens=rng.integers(0, st["tc"].vocab_size, (s,)),
                    max_new_tokens=GEN, arrival_step=a)
            for i, (s, a) in enumerate(((4, 0), (9, 1), (6, 3), (12, 3)))]
    cb = serve.ContinuousBatchingEngine(st["tc"], st["tp"], policy, n_slots=2,
                                        max_len=12 + GEN, kv_quant=False, device="cpu")
    results, stats = cb.run(reqs)
    assert stats["admitted"] == len(reqs) and stats["peak_occupancy"] <= 2
    for req in reqs:
        lock = serve.Engine(st["tc"], st["tp"], policy, max_len=req.tokens.size + GEN,
                            device="cpu")
        toks, _ = lock.generate(req.tokens[None, :], GEN)
        np.testing.assert_array_equal(results[req.rid], t2n(toks[0]), err_msg=f"rid {req.rid}")


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

INVALID = [
    ["--bits", "17"],
    ["--mode", "lockstep", "--prompt-lens", "4,8"],
    ["--no-cb", "--precision-switch", "2:4", "--level", "bitplane"],
    ["--bits", "0", "--no-plane-cache"],
    ["--bits", "0", "--sparsity", "gate"],
    ["--integrity", "detect", "--level", "digit"],
    ["--integrity", "detect", "--level", "bitplane", "--no-plane-cache"],
    ["--mode", "lockstep", "--inject-faults", "planes@2"],
    ["--inject-faults", "warp@2"],
    ["--autopilot", "--mode", "lockstep"],
    ["--autopilot", "--bits", "0"],
    ["--autopilot", "--level", "digit"],
    ["--autopilot", "--level", "bitplane", "--no-plane-cache"],
    ["--sla-ms", "5"],
    ["--sla-queue-steps", "3"],
    ["--shadow-frac", "0.5"],
    ["--autopilot", "--level", "bitplane", "--sla-ms", "0"],
    ["--autopilot", "--level", "bitplane", "--sla-queue-steps", "0"],
    ["--autopilot", "--level", "bitplane", "--shadow-frac", "2"],
    ["--mode", "lockstep", "--deadline", "4"],
    ["--deadline", "0"],
    ["--kv-page-size", "-1"],
    ["--prefill-chunk", "-1"],
    ["--mode", "lockstep", "--kv-page-size", "8"],
    ["--kv-page-size", "8", "--no-kv-quant"],
    ["--kv-pages", "9"],
    ["--kv-page-size", "8", "--kv-pages", "1"],
    ["--mode", "lockstep", "--prefill-chunk", "8"],
    ["--share-prefixes"],
    ["--shared-prefix-len", "-1"],
    ["--audit-interval", "-1"],
    ["--sparsity", "gate", "--level", "digit"],
    ["--sparsity", "compact", "--level", "bitplane", "--no-plane-cache"],
    ["--level", "digit", "--variant", "sbmwc"],
    ["--precision", "4", "--level", "digit"],
    ["--precision", "4", "--level", "bitplane", "--no-plane-cache"],
    ["--precision", "9", "--level", "bitplane"],
    ["--precision-switch", "x", "--level", "bitplane"],
    ["--precision-switch", "2:9", "--level", "bitplane"],
    ["--precision-switch=-1:4", "--level", "bitplane"],
    ["--model-parallel", "0"],
    ["--model-parallel", "2", "--mode", "lockstep"],
    ["--model-parallel", "2", "--bits", "0"],
    ["--model-parallel", "2", "--bits", "12"],
]


def _message(mod, argv) -> str:
    args = mod.build_parser().parse_args(argv)
    with pytest.raises(SystemExit) as exc:
        mod.validate_args(args)
    return str(exc.value)


@pytest.mark.parametrize("argv", INVALID, ids=lambda a: " ".join(a))
def test_validate_args_dies_with_the_reference_message(argv):
    msg = _message(serve, argv)
    assert msg.startswith("[serve] invalid flags: ")
    if "--level" in argv and "sbmwc" in argv:
        # the reference names its TPU kernel; the rule is the same
        assert "--level digit --variant sbmwc has no" in msg
    else:
        assert msg == _message(jserve, argv)


def test_cli_serves_every_new_flag_on_the_host(capsys):
    base = ["--reduced", "--device", "cpu", "--gen", "3"]
    serve.main(base + ["--mode", "lockstep", "--batch", "2", "--prompt-len", "5",
                       "--bits", "12", "--level", "digit", "--temperature", "0.7"])
    out = capsys.readouterr().out
    assert "w12a12 digit" in out and "lockstep: generated (2, 3)" in out
    serve.main(base + ["--bits", "8", "--level", "bitplane", "--prompt-lens", "4,4,4,4,4,4",
                       "--stagger", "0", "--n-slots", "2", "--autopilot", "--sla-queue-steps",
                       "2", "--sla-ms", "1000", "--shadow-frac", "0.5", "--deadline", "20",
                       "--sparsity", "gate", "--no-kv-quant"])
    out = capsys.readouterr().out
    assert "[serve] autopilot: final tier" in out and "cb/bf16" in out
    serve.main(base + ["--bits", "16", "--level", "bitplane", "--prompt-lens", "4",
                       "--no-plane-cache"])
    out = capsys.readouterr().out
    assert "w16a16" in out and "'oracle'" in out


def test_cli_model_parallel_prints_the_single_device_tokens(capsys):
    """``--model-parallel 2 --device cpu`` spawns two gloo ranks; rank 0
    prints the tokens of ``--model-parallel 1`` under the ``tp=2`` tag."""
    base = ["--reduced", "--device", "cpu", "--bits", "8", "--level", "bitplane",
            "--prompt-lens", "5,9,7", "--gen", "4", "--n-slots", "2"]
    serve.main(base + ["--model-parallel", "1"])
    one = capsys.readouterr().out
    serve.main(base + ["--model-parallel", "2"])
    two = capsys.readouterr().out
    rids = [line for line in one.splitlines() if line.startswith("[serve] rid ")]
    assert len(rids) == 3 and " tp=" not in one
    assert " tp=2 cb/int8" in two
    assert [line for line in two.splitlines() if line.startswith("[serve] rid ")] == rids
