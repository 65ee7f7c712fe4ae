"""Port parity of training: the QAT projection and its VJP, the loss and
its gradients (dense, SSM and hybrid families, policy off and 8-bit QAT),
one train step (microbatches 1 and 4, compressed gradients), the QAT
forward against the bit-serial inference it trains for, and the port's
``TrainRun`` through the reference trainer's own tests.

Tolerances, measured on these seeds and stated here once:

* ``linear_apply(training=True)``: output and VJP bit-equal.
* ``loss_fn``: the value within 1e-4 relative; every gradient leaf
  within 3% relative L2 (measured up to 1.8%: bf16 gradients summed in
  another order; the norm scales' are the largest).
* one ``make_train_step`` step (8-bit QAT): the loss within 1e-6
  relative, the gradient norm within 1e-4; at least 97% of each updated
  bf16 leaf equal (measured 98.4%), the rest an update of the other sign
  (a gradient near zero) rounded to bf16; the
  AdamW moments within 5% relative L2 (measured 2.8%).
* QAT forward against bit-serial inference (the same policy and dense
  weights), the reference's and the port's alike: max|dlogit| at most
  ``QAT_GAP`` of the largest |logit| (measured 3.6-5.0% from d_model 128
  to 1024: the fake-quantized operands are rounded to bf16) and the
  greedy token equal at ``QAT_AGREE`` of the positions or more
  (measured 86-98%); ``chip_smoke.py`` holds its full-width run to the
  same bounds.
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
from repro.launch.steps import init_opt_state as jinit_opt, make_train_step as jmake_step
from repro.layers.linear import linear_apply as jlinear
from repro.models.transformer import forward as jforward, init_params as jinit
from repro.models.transformer import loss_fn as jloss_fn
from repro.optim import OptimConfig as JOptimConfig
from repro_torch.configs import get_reduced as tget
from repro_torch.core import tree as tr
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.launch.train import TrainRun
from repro_torch.layers.linear import linear_apply
from repro_torch.models.transformer import (
    forward,
    loss_fn,
    params_from_numpy,
    stack_layers,
    unstack_layers,
)
from repro_torch.optim import OptimConfig

from _torch_parity import j2t, t2n, to_numpy_tree

QAT_GAP = 0.1  # max|dlogit| / max|logit|, QAT forward against bit-serial inference
QAT_AGREE = 0.75  # greedy-token agreement, the same comparison

_PARAMS: dict = {}


def _params(arch):
    """(reference params, the same leaves as a port tree in the reference's
    layout), from one compiled reference init, shared per module."""
    if arch not in _PARAMS:
        jp = jax.jit(lambda k: jinit(jget(arch), k))(jax.random.PRNGKey(0))

        def conv(node):
            if isinstance(node, dict):
                return {k: conv(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [conv(v) for v in node]
            return j2t(np.asarray(node))

        _PARAMS[arch] = (jp, conv(jp))
    return _PARAMS[arch]


def _batch(vocab, b=2, s=32, seed=0):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok[:, :-1]), "targets": jnp.asarray(tok[:, 1:])},
            {"tokens": torch.from_numpy(tok[:, :-1]).long(),
             "targets": torch.from_numpy(tok[:, 1:]).long()})


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf).astype(np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


# -- the QAT projection -----------------------------------------------------


@pytest.mark.parametrize("bits", [(8, 8), (4, 8), (3, 5)])
def test_qat_linear_output_and_vjp_bit_equal(bits):
    """Fake-quantized weights (per output channel) and activations (per
    token) with the compiled step's reciprocal scales, a bf16 product:
    output and both cotangents equal to the reference's compiled VJP."""
    w_bits, a_bits = bits
    rng = np.random.default_rng(w_bits)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 48)) * 0.1, jnp.bfloat16)
    ct = jnp.asarray(rng.standard_normal((2, 5, 48)), jnp.bfloat16)

    def f(xx, ww):
        return jlinear({"w": ww}, xx, name="mlp/up_proj", policy=JPolicy.uniform(w_bits, a_bits),
                       training=True)

    out, vjp = jax.vjp(jax.jit(f), x, w)
    gx, gw = vjp(ct)
    xt, wt = j2t(np.asarray(x)).requires_grad_(), j2t(np.asarray(w)).requires_grad_()
    o = linear_apply({"w": wt}, xt, name="mlp/up_proj",
                     policy=PrecisionPolicy.uniform(w_bits, a_bits), training=True)
    o.backward(j2t(np.asarray(ct)))
    for a, b in ((out, o), (gx, xt.grad), (gw, wt.grad)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32), t2n(b))


# -- loss and gradients ------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-1.3b", "recurrentgemma-2b"])
@pytest.mark.parametrize("w_bits", [0, 8])
def test_loss_and_gradients_match_reference(arch, w_bits):
    """``loss_fn``'s value and every gradient leaf against
    ``jax.value_and_grad`` of the reference's (compiled), the port's
    gradients taken with respect to the reference's stacked leaves."""
    jp, tp = _params(arch)
    vocab = jget(arch).vocab_size
    jb, tb = _batch(vocab)
    jpol = JPolicy.uniform(w_bits, w_bits) if w_bits else JPolicy.off()
    tpol = PrecisionPolicy.uniform(w_bits, w_bits) if w_bits else PrecisionPolicy.off()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jget(arch), p, b, policy=jpol), has_aux=True))(jp, jb)
    leaves = [leaf.detach().requires_grad_() for leaf in tr.leaves(tp)]
    tl, metrics = loss_fn(tget(arch), tr.unflatten_like(tp, leaves), tb, policy=tpol)
    tg = torch.autograd.grad(tl, leaves)
    assert sorted(metrics) == ["aux_loss", "loss"]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    jflat = _jflat(jg)
    paths = [tr.path_key(p) for p, _ in tr.flatten_with_path(tp)]
    assert paths == list(jflat)  # the same leaves in the same (pytree) order
    for key, g in zip(paths, tg):
        assert tuple(g.shape) == jflat[key].shape, key
        assert _rel_l2(jflat[key], t2n(g)) <= 0.03, key


def test_cross_entropy_masks_padded_vocab_and_tokens():
    from repro.models.transformer import cross_entropy as jce
    from repro_torch.models.transformer import cross_entropy

    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 5, 16)) * 3).astype(np.float32)
    targets = rng.integers(0, 12, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        for n_valid in (None, 12):
            ref = jax.jit(lambda l, t: jce(l, t, None if m is None else jnp.asarray(m),
                                           n_valid))(jnp.asarray(logits), jnp.asarray(targets))
            got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets).long(),
                                None if m is None else torch.from_numpy(m), n_valid)
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_remat_groups_change_no_number():
    """Per-period checkpoints, two-level groups and the per-chunk attention
    recompute give the loss and gradients of the plain forward, bit for bit."""
    cfg = dataclasses.replace(tget("granite-3-8b"), n_layers=4, attn_chunk=8)
    gen = torch.Generator()
    gen.manual_seed(1)
    from repro_torch.models.transformer import init_params
    params = stack_layers(cfg, init_params(cfg, gen))
    _, tb = _batch(cfg.vocab_size, s=24)
    results = []
    for group in (1, 2):
        c = dataclasses.replace(cfg, remat_group=group)
        leaves = [leaf.detach().requires_grad_() for leaf in tr.leaves(params)]
        loss, _ = loss_fn(c, tr.unflatten_like(params, leaves), tb,
                          policy=PrecisionPolicy.uniform(8, 8))
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    # no checkpoint at all: the unrolled stack (the same leaves, unstacked)
    c = dataclasses.replace(cfg, scan_layers=False)
    leaves = [leaf.detach().requires_grad_() for leaf in tr.leaves(params)]
    loss, _ = loss_fn(c, unstack_layers(cfg, tr.unflatten_like(params, leaves)), tb,
                      policy=PrecisionPolicy.uniform(8, 8))
    results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        for a, b in zip(results[0][1], grads):
            assert torch.equal(a, b)


def test_layouts_round_trip():
    """``stack_layers`` of the port's layer list is the reference's tree
    (``params_from_numpy`` of it gives the list back), leaf for leaf."""
    jp, tp = _params("recurrentgemma-2b")  # 2 periods of (rec, rec, attn) and a tail
    cfg = tget("recurrentgemma-2b")
    port = params_from_numpy(cfg, to_numpy_tree(jp))
    stacked = stack_layers(cfg, port)
    assert [tr.path_key(p) for p, _ in tr.flatten_with_path(stacked)] == list(_jflat(jp))
    for a, b in zip(tr.leaves(stacked), tr.leaves(tp)):
        assert torch.equal(a, b)
    for a, b in zip(tr.leaves(unstack_layers(cfg, tp)), tr.leaves(port)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="without a cache"):
        forward(cfg, tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, training=True,
                cache={"step": torch.zeros(1)})


# -- one train step ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["single", "micro4", "compressed"])
def test_train_step_matches_reference(kind):
    arch = "granite-3-8b"
    jp, tp = _params(arch)
    jb, tb = _batch(jget(arch).vocab_size, b=4)
    mb = 4 if kind == "micro4" else 1
    comp = kind == "compressed"
    jcfg_o, tcfg_o = JOptimConfig(peak_lr=1e-3, total_steps=10), \
        OptimConfig(peak_lr=1e-3, total_steps=10)
    jstep = jax.jit(jmake_step(jget(arch), jcfg_o, policy=JPolicy.uniform(8, 8),
                               microbatches=mb, compress_grads=comp))
    tstep = make_train_step(tget(arch), tcfg_o, policy=PrecisionPolicy.uniform(8, 8),
                            microbatches=mb, compress_grads=comp)
    js = jinit_opt(jget(arch), jcfg_o, jp, comp)
    ts = init_opt_state(tget(arch), tcfg_o, tp, comp)
    assert sorted(ts) == sorted(js)
    jnew, js2, jm = jstep(jp, js, jb, jnp.int32(0))
    tnew, ts2, tm = tstep(tp, ts, tb, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    new = _jflat(jnew)
    for (path, t_new), t_old in zip(tr.flatten_with_path(tnew), tr.leaves(tp)):
        key = tr.path_key(path)
        assert t_new.dtype == t_old.dtype, key
        a, b = new[key], t2n(t_new)
        assert (a == b).mean() >= 0.97, key
        # an update of the other sign (step 0's Adam update is the learning
        # rate times about +-1) rounded to bf16 on either side
        lr0 = tcfg_o.peak_lr / tcfg_o.warmup_steps
        bound = 2 * lr0 + 2.0 ** -6 * np.maximum(np.abs(a), np.abs(b))
        assert (np.abs(a - b) <= bound).all(), key
    state = _jflat(js2)
    for path, leaf in tr.flatten_with_path(ts2):
        key = tr.path_key(path)
        if key.startswith("_gc_error"):
            # the residual of the int8 rounding is chaotic in gradients that
            # differ by bf16 roundings (the arithmetic itself is bit-equal:
            # test_torch_optim.py); both stay within the half step of
            # near-equal scales
            ref, got = np.abs(state[key]).max(), np.abs(t2n(leaf)).max()
            assert got <= 1.05 * ref and ref <= 1.05 * got, key
        else:
            assert _rel_l2(state[key], t2n(leaf)) <= 0.05, key
    assert sorted(ts2) == sorted(js2)
    assert all(not t.requires_grad for t in tr.leaves(tnew))
    # the step leaves its inputs as they were
    for a, b in zip(tr.leaves(tp), tr.leaves(_params(arch)[1])):
        assert a is b


# -- QAT forward against bit-serial inference --------------------------------


@pytest.mark.parametrize("d_model", [128, 512])
def test_qat_forward_against_bit_serial_inference(d_model):
    """The training forward (fake quant) against the inference it trains
    for (``training=False``, the same policy, dense weights: the on-the-fly
    bit-serial route), for the reference's two forwards and the port's:
    both gaps within the stated bounds, and within a quarter of the larger
    of each other."""
    arch = "granite-3-8b"
    wide = dict(d_model=512, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=1024, n_layers=4,
                vocab_size=2048)
    jcfg = jget(arch) if d_model == 128 else dataclasses.replace(jget(arch), **wide)
    tcfg = tget(arch) if d_model == 128 else dataclasses.replace(tget(arch), **wide)
    jp = jax.jit(lambda k: jinit(jcfg, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, to_numpy_tree(jp))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    jpol = JPolicy.uniform(8, 8, keep_dense=("lm_head", "embed"))
    tpol = PrecisionPolicy.uniform(8, 8, keep_dense=("lm_head", "embed"))
    gaps = []
    for training_fwd in (
            lambda tr_: np.asarray(jax.jit(lambda p, t: jforward(
                jcfg, p, {"tokens": t}, policy=jpol, training=tr_)[0])(jp, jnp.asarray(toks))),
            lambda tr_: t2n(forward(tcfg, tp, {"tokens": torch.from_numpy(toks).long()},
                                    policy=tpol, training=tr_)[0].detach())):
        qat, inf = (training_fwd(t).astype(np.float32)[..., :jcfg.vocab_size]
                    for t in (True, False))
        gap = np.abs(qat - inf).max() / np.abs(qat).max()
        agree = (qat.argmax(-1) == inf.argmax(-1)).mean()
        assert gap <= QAT_GAP and agree >= QAT_AGREE, (gap, agree)
        gaps.append(gap)
    assert abs(gaps[0] - gaps[1]) <= 0.25 * max(gaps), gaps


# -- the reference trainer's tests, on the port's TrainRun -------------------


def _run(**kw):
    base = dict(cfg=tget("granite-3-8b"), steps=12, global_batch=4, seq_len=32, peak_lr=1e-3,
                log_every=100, device="cpu")
    base.update(kw)
    return TrainRun(**base)


def test_loss_decreases():
    out = _run(steps=25).run()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    assert len(out["losses"]) == 25 and out["steps_per_s"] > 0


def test_checkpoint_resume_continues_exactly(tmp_path):
    """12 steps saving at step 5 (and the final step 11, deleted: a crash
    after the step-5 save); a fresh run resumes at step 6 and gives the
    uninterrupted run's losses bit for bit."""
    import shutil

    ck = tmp_path / "ck"
    full = _run(ckpt_dir=str(ck), ckpt_every=6).run()
    shutil.rmtree(ck / "step_11")
    resumed = _run(ckpt_dir=str(ck), ckpt_every=6).run(resume=True)
    assert len(resumed["losses"]) == 6  # steps 6..11
    assert resumed["losses"] == full["losses"][6:]
    assert resumed["final_loss"] == full["final_loss"]


def test_microbatched_matches_single_shot():
    a = _run(steps=3, global_batch=8, microbatches=1).run()
    b = _run(steps=3, global_batch=8, microbatches=4).run()
    np.testing.assert_allclose(a["losses"][0], b["losses"][0], rtol=1e-3)


def test_qat_training_runs():
    out = _run(steps=6, policy=PrecisionPolicy.uniform(8, 8)).run()
    assert np.isfinite(out["final_loss"])


def test_compressed_grads_still_learn():
    out = _run(steps=25, compress_grads=True).run()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])


def test_adafactor_variant():
    out = _run(steps=8, optimizer="adafactor").run()
    assert np.isfinite(out["final_loss"])


def test_families_train_on_the_host():
    """The SSM and hybrid stacks take the same trainer."""
    for arch in ("mamba2-1.3b", "recurrentgemma-2b"):
        out = _run(cfg=tget(arch), steps=4, policy=PrecisionPolicy.uniform(8, 8)).run()
        assert np.isfinite(out["losses"]).all()


def test_train_run_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainRun(cfg=tget("granite-3-8b"), steps=1).run()
