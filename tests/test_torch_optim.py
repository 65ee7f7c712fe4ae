"""Port parity of the training arithmetic that is not the model: the QAT
fake quantizer and its straight-through gradient, the optimizers and
schedule, gradient clipping, int8 error-feedback compression, the data
pipeline, and the trainer CLI's flags.

What is held bit for bit: ``fake_quant`` forward and gradient, AdamW's updates and state, the warmup schedule, the
compressed gradients and error buffers, every batch. Within stated
bounds, naming the operation: the cosine schedule (XLA's float32 ``cos``
is not correctly rounded: 1 ulp in the cosine, the rest bit-equal),
Adafactor (XLA's summation order in its means and its reciprocal-square-
root rewrite of the clip are not repeated; its elementwise arithmetic is
bit-equal) and the global norm (XLA's summation order)."""

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim  # noqa: F401  (the package, for its adamw module below)
from repro.core.quantize import fake_quant as jfake_quant
from repro.data import DataConfig as JDataConfig, DataPipeline as JDataPipeline
from repro.optim import compress as jgc
from repro_torch.core import tree as tr
from repro_torch.core.quantize import fake_quant
from repro_torch.data import DataConfig, DataPipeline, write_token_file
from repro_torch.launch import train as ttrain
from repro_torch.optim import compress as tgc

from _torch_parity import j2t, t2n

J = sys.modules["repro.optim.adamw"]  # the package re-exports `adamw` over the module
T = sys.modules["repro_torch.optim.adamw"]


def _ulps(a, b) -> np.ndarray:
    """Distance in float32 units in the last place, elementwise."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


# -- fake_quant ------------------------------------------------------------


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("axis", [None, 0, -1])
def test_fake_quant_forward_and_gradient_bit_equal(bits, axis):
    """Against ``jax.grad`` of the reference's ``fake_quant`` compiled, as
    its train step runs it (XLA computes the scale as ``amax * (1 /
    qmax)``; eager JAX divides, and rounds differently in some rows)."""
    rng = np.random.default_rng(bits * 7 + (axis or 3))
    x = (rng.standard_normal((17, 33)) * 3).astype(np.float32)
    g = rng.standard_normal((17, 33)).astype(np.float32)

    def jloss(v):
        return jnp.sum(jfake_quant(v, bits, axis) * g)

    jout, jgrad = jax.jit(lambda v: (jfake_quant(v, bits, axis), jax.grad(jloss)(v)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = fake_quant(xt, bits, axis)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(np.asarray(jout), out.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jgrad), xt.grad.numpy())


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_half_gradient_at_qmax(bits):
    """Each row's maximum lands on +qmax and gets half the gradient, as
    ``jnp.clip`` gives at a bound (``torch.clamp`` would give all of it);
    a row whose largest magnitude is negative lands on -qmax, inside the
    range, and keeps the whole gradient."""
    x = torch.tensor([[127.0, -128.0, 5.0, 200.0], [1.0, -2.0, 0.5, 3.0], [1.0, -3.0, 0.5, 2.0]])
    xt = x.clone().requires_grad_()
    fake_quant(xt, bits, axis=-1).sum().backward()
    jg = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jfake_quant(v, bits, -1))))(
        jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(jg, xt.grad.numpy())
    assert xt.grad[0, 3] == 0.5 and xt.grad[1, 3] == 0.5  # the row maxima
    assert (xt.grad[2] == 1.0).all()
    # the reference's clip, for the record: 0.5 at a bound, torch.clamp 1
    jc = jax.grad(lambda v: jnp.clip(v, -128.0, 127.0).sum())(jnp.asarray([127.0, -128, 5, 200]))
    np.testing.assert_array_equal(np.asarray(jc), [0.5, 0.5, 1.0, 0.0])


# -- schedules and optimizers ---------------------------------------------


def test_warmup_schedule_bit_equal_and_cosine_within_its_cos_ulp(monkeypatch):
    """Warmup: bit-equal. Cosine: bit-equal given XLA's own cos values;
    with the port's correctly rounded cos the learning rate moves by at
    most 4 ulps (the cos by 1)."""
    for peak, warm, total in ((1e-3, 3, 10), (3e-4, 100, 1500), (1e-3, 100, 12)):
        js = jax.jit(J.warmup_cosine(peak, warm, total))
        steps = np.arange(total + 5)
        ref = np.array([np.asarray(js(jnp.int32(s))) for s in steps], np.float32)
        port = np.array([T.warmup_cosine(peak, warm, total)(int(s)) for s in steps], np.float32)
        w = steps < warm
        np.testing.assert_array_equal(ref[w], port[w])
        assert _ulps(ref, port).max() <= 4
        if w.all():
            continue
        # the cosine's argument, as the schedule forms it, through XLA's cos
        t = np.clip((steps[~w].astype(np.float32) - np.float32(warm))
                    * (np.float32(1) / np.float32(max(total - warm, 1))), 0, 1).astype(np.float32)
        arg = (np.float32(np.pi) * t).astype(np.float32)
        xla_cos = dict(zip(arg.tolist(), np.asarray(jax.jit(jnp.cos)(jnp.asarray(arg))).tolist()))
        port_cos = np.array([np.float32(np.cos(np.float64(a))) for a in arg])
        assert _ulps(port_cos, np.array([xla_cos[a] for a in arg.tolist()], np.float32)).max() <= 1
        fake_math = type("M", (), {"pi": np.pi, "cos": staticmethod(lambda v: xla_cos[v])})
        monkeypatch.setattr(T, "math", fake_math)
        port_x = np.array([T.warmup_cosine(peak, warm, total)(int(s)) for s in steps], np.float32)
        monkeypatch.undo()
        np.testing.assert_array_equal(ref, port_x)


def _trees(rng, dtype):
    """Grads and params: a matrix, a stacked (layers, K, N) leaf and a vector."""
    def mk(scale):
        return {"w": (rng.standard_normal((48, 80)) * scale).astype(np.float32),
                "stack": (rng.standard_normal((3, 32, 40)) * scale).astype(np.float32),
                "b": (rng.standard_normal((40,)) * scale).astype(np.float32)}
    p, g = mk(1e-1), mk(1e-2)
    if dtype == "bf16":
        p = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in p.items()}
        g = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in g.items()}
    return p, g


def _run_both(jopt, topt, dtype, steps=5, seed=0):
    """Feed the same grads through both optimizers (each on its own state)
    for ``steps`` steps; yield (reference, port) updates and state leaves."""
    rng = np.random.default_rng(seed)
    p, _ = _trees(rng, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: j2t(v) for k, v in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jupd = jax.jit(jopt.update)
    for step in range(steps):
        _, g = _trees(rng, dtype)
        ju, js = jupd({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.int32(step))
        tu, ts = topt.update({k: j2t(v) for k, v in g.items()}, ts, tp, step)
        yield ({k: np.asarray(v).astype(np.float32) for k, v in ju.items()},
               {k: t2n(v) for k, v in tu.items()},
               [np.asarray(a).astype(np.float32) for a in jax.tree_util.tree_leaves(js)],
               [(t2n(b), b.dtype == torch.bfloat16) for b in tr.leaves(ts)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_updates_and_state_bit_equal(dtype):
    """The compiled reference's FMAs (m, v, weight decay), its single
    division ``m / (c1 * (sqrt(v / c2) + eps))`` and its correctly rounded
    sqrt, repeated: every update and state leaf equal, matrices (weight
    decay), stacked leaves and vectors."""
    sched = (1e-3, 2, 10)
    for ju, tu, js, ts in _run_both(J.adamw(J.warmup_cosine(*sched)),
                                    T.adamw(T.warmup_cosine(*sched)), dtype, steps=3):
        for k in ju:
            np.testing.assert_array_equal(ju[k], tu[k], err_msg=k)
        for a, (b, _) in zip(js, ts):
            np.testing.assert_array_equal(a, b)


def test_adam_bias_corrections_bit_equal():
    jc = jax.jit(lambda s: (1.0 - 0.9 ** (s.astype(jnp.float32) + 1),
                            1.0 - 0.95 ** (s.astype(jnp.float32) + 1)))
    for step in range(0, 400, 7):
        ref = [np.float32(np.asarray(c)) for c in jc(jnp.int32(step))]
        assert [np.float32(c) for c in T.adam_scalars(step, 0.9, 0.95)] == ref, step


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adafactor_within_stated_bounds(momentum, dtype):
    """The elementwise FMAs are the reference's (state bit-equal on
    one-element leaves, where no sum is reordered: the next test); its
    means sum in XLA's order and its clip goes through XLA's rsqrt, so
    each update and state leaf stays within 2e-6 of the leaf's largest
    magnitude (measured 6.7e-7). With momentum one element's float32
    difference can round its bf16 momentum the other way: then within one
    bf16 step, 4e-3 of the leaf's largest magnitude (measured 2.9e-3)."""
    bound = 4e-3 if momentum else 2e-6
    for ju, tu, js, ts in _run_both(
            J.adafactor(J.constant_lr(1e-3), momentum=momentum, weight_decay=0.1),
            T.adafactor(T.constant_lr(1e-3), momentum=momentum, weight_decay=0.1),
            dtype, steps=4):
        for k in ju:
            assert np.abs(ju[k] - tu[k]).max() <= bound * np.abs(ju[k]).max(), k
        for a, (b, _) in zip(js, ts):
            assert np.abs(a - b).max() <= bound * np.abs(a).max()


def test_adafactor_state_bit_equal_on_one_element_leaves():
    """Where no sum is reordered (one-element leaves) the state — every
    FMA of g², the row/column statistics and the momentum — is the
    reference's bit for bit."""
    rng = np.random.default_rng(3)
    p = {f"l{i:03d}": rng.standard_normal((1, 1)).astype(np.float32) for i in range(64)}
    for momentum in (False, True):
        jopt = J.adafactor(J.constant_lr(1e-3), momentum=momentum, weight_decay=0.1)
        topt = T.adafactor(T.constant_lr(1e-3), momentum=momentum, weight_decay=0.1)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: j2t(v) for k, v in p.items()}
        js, ts = jopt.init(jp), topt.init(tp)
        for step in range(3):
            g = {k: (rng.standard_normal((1, 1)) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
                 for k in p}
            _, js = jax.jit(jopt.update)({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                                         jnp.int32(step))
            _, ts = topt.update({k: j2t(v) for k, v in g.items()}, ts, tp, step)
            for a, b in zip(jax.tree_util.tree_leaves(js), tr.leaves(ts)):
                np.testing.assert_array_equal(np.asarray(a).astype(np.float32), t2n(b))


def test_adafactor_state_aligns_with_reference_leaf_order():
    """The state is a list over the parameters' leaves in pytree order
    (dict keys sorted), whatever the dict's insertion order."""
    shapes = {"z": (3, 5), "a": (7,), "m": (2, 4, 6)}
    jstate = J.adafactor(J.constant_lr(1e-3)).init({k: jnp.zeros(s) for k, s in shapes.items()})
    tstate = T.adafactor(T.constant_lr(1e-3)).init({k: torch.zeros(s) for k, s in shapes.items()})
    for a, b in zip(jstate["leaves"], tstate["leaves"]):
        assert sorted(a) == sorted(b)
        for key in a:
            assert tuple(a[key].shape) == tuple(b[key].shape)


@pytest.mark.parametrize("max_norm", [1.0, 1e-3])
def test_clip_by_global_norm(max_norm):
    """The norm within 2 float32 ulps (XLA's summation order), the clipped
    bf16 leaves within one bf16 step, f32 leaves within 2 ulps."""
    rng = np.random.default_rng(5)
    _, g = _trees(rng, "bf16")
    g["f"] = rng.standard_normal((6, 7)).astype(np.float32)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jc, jn = jax.jit(lambda t: J.clip_by_global_norm(t, max_norm))(jg)
    tc, tn = T.clip_by_global_norm({k: j2t(v) for k, v in g.items()}, max_norm)
    assert _ulps(np.asarray(jn), t2n(tn)).max() <= 2
    for k in g:
        bound = 2 if g[k].dtype == np.float32 else 1 << 16
        assert _ulps(np.asarray(jc[k]).astype(np.float32), t2n(tc[k])).max() <= bound, k
        assert tc[k].dtype == j2t(np.asarray(jc[k])).dtype


def test_optimizers_descend_on_a_quadratic():
    for make in (T.adamw, T.adafactor):
        params = {"a": torch.tensor([3.0, -2.0]), "w": torch.full((4, 4), 2.0)}
        opt = make(T.constant_lr(0.05), weight_decay=0.0)
        state = opt.init(params)

        def loss(p):
            return (p["a"] ** 2).sum() + (p["w"] ** 2).sum()

        l0 = float(loss(params))
        for step in range(50):
            grads = {k: 2 * v for k, v in params.items()}
            updates, state = opt.update(grads, state, params, step)
            params = T.apply_updates(params, updates)
        assert float(loss(params)) < 0.3 * l0


# -- gradient compression -------------------------------------------------


def test_compress_tree_and_error_feedback_bit_equal():
    rng = np.random.default_rng(11)
    shapes = {"w": (24, 40), "b": (40,), "s": (2, 8, 8)}
    jerr = jgc.init_error({k: jnp.zeros(s) for k, s in shapes.items()})
    terr = tgc.init_error({k: torch.zeros(s) for k, s in shapes.items()})
    comp = jax.jit(jgc.compress_tree)
    for _ in range(4):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
             for k, s in shapes.items()}
        jq, js, jerr = comp({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tq, ts, terr = tgc.compress_tree({k: j2t(v) for k, v in g.items()}, terr)
        jd, td = jgc.decompress_tree(jq, js), tgc.decompress_tree(tq, ts)
        for k in shapes:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(np.asarray(jq[k]), t2n(tq[k]))
            np.testing.assert_array_equal(np.asarray(js[k]), t2n(ts[k]))
            np.testing.assert_array_equal(np.asarray(jerr[k]), t2n(terr[k]))
            np.testing.assert_array_equal(np.asarray(jd[k]), t2n(td[k]))
    assert tgc.compressed_bytes(g) == jgc.compressed_bytes(g) == sum(
        int(np.prod(s)) for s in shapes.values())


# -- data pipeline --------------------------------------------------------


def _data_cfgs(tmp_path):
    corpus = np.random.default_rng(2).integers(0, 60000, 5000)
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, corpus)
    base = dict(seq_len=16, global_batch=8, vocab_size=1000, seed=7)
    return [dict(base), dict(base, source="memmap", path=path)]


@pytest.mark.parametrize("source", [0, 1], ids=["synthetic", "memmap"])
def test_data_pipeline_batches_bit_equal(tmp_path, source):
    kw = _data_cfgs(tmp_path)[source]
    for rank, size in ((0, 1), (1, 2), (3, 4)):
        jp = JDataPipeline(JDataConfig(**kw), rank, size)
        tp = DataPipeline(DataConfig(**kw), rank, size)
        for step in (0, 1, 5, 1000):
            jb, tb = jp.batch_at(step), tp.batch_at(step)
            assert sorted(jb) == sorted(tb) == ["targets", "tokens"]
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
        # the resumable iterator, with and without prefetch
        for prefetch in (0, 2):
            jit_, tit = jp.iterate(start_step=3, prefetch=prefetch), \
                tp.iterate(start_step=3, prefetch=prefetch)
            for _ in range(3):
                jb, tb = next(jit_), next(tit)
                np.testing.assert_array_equal(jb["tokens"], tb["tokens"])
            np.testing.assert_array_equal(tb["tokens"], tp.batch_at(5)["tokens"])


def test_data_pipeline_refusals_match(tmp_path):
    with pytest.raises(ValueError, match="global_batch"):
        DataPipeline(DataConfig(seq_len=4, global_batch=6, vocab_size=10), 0, 4)
    with pytest.raises(ValueError, match="memmap source needs"):
        DataPipeline(DataConfig(seq_len=4, global_batch=2, vocab_size=10, source="memmap"))


# -- the trainer's command line -------------------------------------------


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _reference_parser(monkeypatch):
    """The reference builds its parser inside ``main``: stop it at
    ``parse_args`` and keep the parser."""
    from repro.launch import train as jtrain

    def grab(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as got:
        jtrain.main()
    monkeypatch.undo()
    return got.value.parser


def test_train_cli_defaults_and_choices_are_the_references(monkeypatch):
    jparser = _reference_parser(monkeypatch)
    tparser = ttrain.build_parser()
    jdef = vars(jparser.parse_args([]))
    tdef = vars(tparser.parse_args([]))
    assert set(tdef) - set(jdef) == {"device"}  # the port's one addition
    assert set(jdef) == set(tdef) - {"device"}
    for k in jdef:
        assert tdef[k] == jdef[k], k
    choices = lambda p: {a.dest: a.choices for a in p._actions if a.choices}
    jc, tc = choices(jparser), choices(tparser)
    assert tc["optimizer"] == jc["optimizer"]
    # the families the port has: a subset of the reference's registry
    assert set(tc["arch"]) <= set(jc["arch"]) and "granite-3-8b" in tc["arch"]


def test_train_cli_model_axis_dies_naming_item_11():
    """``--model-axis 2 --device cpu`` trains on a (1, 2) mesh of two gloo
    ranks, and its losses equal ``TrainRun``'s on the
    same mesh, bit for bit; a model axis below 1 dies."""
    from repro_torch.configs import get_reduced

    out = ttrain.main(["--reduced", "--device", "cpu", "--model-axis", "2", "--steps", "2",
                       "--batch", "2", "--seq", "8"])
    run = ttrain.TrainRun(cfg=get_reduced("granite-3-8b"), model_axis=2, device="cpu",
                          steps=2, global_batch=2, seq_len=8)
    assert run.world() == 2
    ref = run.run()
    assert out["mesh"] == ref["mesh"] == {"data": 1, "model": 2}
    assert out["losses"] == ref["losses"] and len(out["losses"]) == 2
    assert out["params"] is None and ref["params"] is not None
    with pytest.raises(SystemExit, match="--model-axis 0"):
        ttrain.main(["--reduced", "--device", "cpu", "--model-axis", "0"])
