"""The encoder and VLM architectures and their layers against the
reference, on the CPU (reduced configs; every reference call compiled).

* hubert-xlarge: ``forward`` on frame ``features`` (its hidden state is
  float32: the front end's dense product keeps the features' dtype), the
  policy off and at w8a8 (uniform, the front end quantized too, and with
  the front end kept dense): every frame's logits within ``ENC_ATOL``
  (measured 1.7e-6: float32 sums in another order); ``make_prefill_step``
  gives the last frame's logits and no cache; both engines refuse it.
* internvl2-2b: ``make_prefill_step`` with ``patches`` (the positions count
  them), then decode steps through ``make_serve_step``: the prefill logits
  and every token equal to the reference's; the continuous-batching engine's
  tokens on text prompts equal to the reference engine's.
* ``loss_fn`` with patches (their positions carry no target): the value
  within 1e-5 relative, the gradients within 3% relative L2.
* ``layernorm_apply`` (within one bf16 step), ``attention_apply(use_rope=
  False, causal=False)`` and the plain GELU MLP (bit-equal), and
  ``make_batch`` (shapes, dtypes and values) against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro import configs as jconfigs
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import inputs as jinputs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.layers.attention import attention_apply as jattention, attention_init as jattn_init
from repro.layers.mlp import mlp_apply as jmlp, mlp_init as jmlp_init
from repro.layers.norms import layernorm_apply as jlayernorm
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro.models.transformer import loss_fn as jloss_fn
from repro.runtime.scheduler import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core import tree as tr
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import inputs, serve, steps
from repro_torch.layers.attention import attention_apply
from repro_torch.layers.mlp import mlp_apply
from repro_torch.layers.norms import layernorm_apply, layernorm_init
from repro_torch.models.quant import quantize_params
from repro_torch.models.transformer import forward, loss_fn, params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import j2t, j2t_tree, reference_layout, reference_quantizes_to, t2n
from _torch_parity import to_numpy_tree

ENC_ATOL = 1e-4
_P: dict = {}


def _setup(arch):
    if arch not in _P:
        jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        _P[arch] = (jc, tc, jp, params_from_numpy(tc, to_numpy_tree(jp), device="cpu"))
    return _P[arch]


def _batches(cfg, b, s, kind, seed=0):
    jb = jinputs.make_batch(cfg, b, s, kind, np.random.default_rng(seed))
    tb = inputs.make_batch(cfg, b, s, kind, np.random.default_rng(seed), device="cpu")
    return jb, tb


def _policy_pair(kind):
    if kind == "off":
        return JPolicy.off(), TPolicy.off()
    keep = ("frontend",) if kind == "w8-dense-frontend" else ()
    return (JPolicy.uniform(8, 8, level="bitplane", keep_dense=keep),
            TPolicy.uniform(8, 8, level="bitplane", keep_dense=keep))


@pytest.mark.parametrize("pol", ["off", "w8", "w8-dense-frontend"])
def test_hubert_encoder_forward_matches_reference(pol):
    jc, tc, jp, tp = _setup("hubert-xlarge")
    jpol, tpol = _policy_pair(pol)
    tree = tp if pol == "off" else quantize_params(tp, tpol, plane_cache=True, cfg=tc)
    jtree = jp if pol == "off" else reference_layout(tc, tree)
    jb, tb = _batches(tc, 2, 12, "prefill")
    lj, aj, cj = jax.jit(lambda p, b: jforward(jc, p, b, policy=jpol))(jtree, jb)
    lt, at, ct = forward(tc, tree, tb, policy=tpol)
    assert cj is None and ct is None and float(at) == 0.0
    assert lt.shape == (2, 12, tc.vocab_padded) and lt.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(lj), t2n(lt), atol=ENC_ATOL, rtol=0)
    last, cache = steps.make_prefill_step(tc, tpol)(tree, tb)
    assert cache is None
    np.testing.assert_array_equal(t2n(last), t2n(lt[:, -1]))


def test_encoder_has_no_decode_path():
    _, tc, _, tp = _setup("hubert-xlarge")
    for engine in (serve.ContinuousBatchingEngine, serve.Engine):
        with pytest.raises(ValueError, match="encoder-only"):
            engine(tc, tp, TPolicy.off(), device="cpu")
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu", "--gen", "2"])


def test_vlm_patch_prefill_and_decode_match_reference():
    jc, tc, jp, tp = _setup("internvl2-2b")
    jpol = JPolicy.uniform(8, 8, level="bitplane", keep_dense=("frontend", "router"))
    tpol = TPolicy.uniform(8, 8, level="bitplane", keep_dense=("frontend", "router"))
    tq = quantize_params(tp, tpol, plane_cache=True, cfg=tc)
    jq = reference_layout(tc, tq)
    jb, tb = _batches(tc, 2, 6 + tc.num_patches, "prefill", seed=3)
    assert tb["patches"].shape == (2, tc.num_patches, tc.frontend_dim)
    lj, cj = jax.jit(jsteps.make_prefill_step(jc, jpol, max_len=32, kv_quant=True))(jq, jb)
    lt, ct = steps.make_prefill_step(tc, tpol, max_len=32, kv_quant=True)(tq, tb)
    np.testing.assert_array_equal(np.asarray(lj).astype(np.float32), t2n(lt))
    # the patches' positions come first: decode continues after them
    assert ct["step"].tolist() == [6 + tc.num_patches] * 2 == np.asarray(cj["step"]).tolist()
    jstep, tstep = jax.jit(jsteps.make_serve_step(jc, jpol)), steps.make_serve_step(tc, tpol)
    tok = jnp.argmax(lj[:, :jc.vocab_size], -1)[:, None].astype(jnp.int32)
    ttok = torch.from_numpy(np.array(tok))
    for _ in range(4):
        tok, cj = jstep(jq, cj, tok)
        ttok, ct = tstep(tq, ct, ttok)
        np.testing.assert_array_equal(np.asarray(tok), ttok.numpy())
    # the engines serve the VLM on text, as the reference's do
    prompts = [np.random.default_rng(1).integers(0, jc.vocab_size, (s,)) for s in (5, 9, 3)]
    with reference_quantizes_to(lambda: jq):
        je = jserve.ContinuousBatchingEngine(jc, jp, jpol, n_slots=2, max_len=16)
    rj, _ = je.run([JRequest(rid=i, tokens=p, max_new_tokens=4, arrival_step=i)
                    for i, p in enumerate(prompts)])
    te = serve.ContinuousBatchingEngine(tc, tp, tpol, n_slots=2, max_len=16, device="cpu")
    rt, _ = te.run([TRequest(rid=i, tokens=p, max_new_tokens=4, arrival_step=i)
                    for i, p in enumerate(prompts)])
    for rid in rj:
        np.testing.assert_array_equal(np.asarray(rj[rid]), rt[rid], err_msg=f"rid {rid}")


def test_vlm_loss_drops_the_patch_positions():
    jc, tc, jp, tp = _setup("internvl2-2b")
    jb, tb = _batches(tc, 2, 6 + tc.num_patches, "train", seed=4)
    assert tb["targets"].shape == (2, 6)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jc, p, b, policy=JPolicy.off()), has_aux=True))(jp, jb)
    leaves = [leaf.detach().requires_grad_() for leaf in tr.leaves(tp)]
    tl, tm = loss_fn(tc, tr.unflatten_like(tp, leaves), tb, policy=TPolicy.off())
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    tflat = {tr.path_key(p): g for (p, _), g in zip(tr.flatten_with_path(tp), grads)}
    # the front end's projection, which only the patch positions reach, and
    # the norm of the whole gradient (the trees' layouts differ)
    fj = np.asarray(jg["frontend"]["proj"]["w"]).astype(np.float32)
    ft = t2n(tflat["frontend/proj/w"])
    assert np.linalg.norm(fj) > 0
    assert np.linalg.norm(fj - ft) <= 0.03 * np.linalg.norm(fj)
    nj = np.sqrt(sum(float(np.sum(np.asarray(g).astype(np.float32) ** 2))
                     for g in jax.tree_util.tree_leaves(jg)))
    nt = np.sqrt(sum(float(torch.sum(g.float() ** 2)) for g in grads))
    np.testing.assert_allclose(nt, nj, rtol=0.03)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((3, 7, 96)) * 3 + 1, jnp.bfloat16)
    params = layernorm_init(96)
    params["scale"] = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    params["bias"] = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    yj = np.asarray(jax.jit(jlayernorm)(jparams, x)).astype(np.float32)
    yt = layernorm_apply(params, j2t(x))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yj, t2n(yt), atol=0, rtol=2.0 ** -7)
    xf = jnp.asarray(rng.standard_normal((4, 33)), jnp.float32)
    p1 = layernorm_init(33)
    yj = np.asarray(jax.jit(jlayernorm)({k: jnp.asarray(v.numpy()) for k, v in p1.items()}, xf))
    np.testing.assert_allclose(yj, t2n(layernorm_apply(p1, j2t(xf))), atol=1e-6)


@pytest.mark.parametrize("pol", ["off", "w8"])
def test_attention_without_rope_and_gelu_mlp_match_reference(pol):
    """``use_rope=False`` and ``causal=False`` through the cache-free path;
    the plain GELU MLP (``act="gelu"``: the up projection with a GELU
    epilogue, then down) on bf16 activations: both bit-equal. At w8a8 the
    down projection's quantizer reads the GELU output rounded to bf16, as
    the reference's compiled graph does."""
    jpol, tpol = _policy_pair(pol)
    ap = jattn_init(jax.random.PRNGKey(1), 64, 4, 2, 16)
    x = jnp.asarray(np.random.default_rng(7).standard_normal((2, 9, 64)), jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(9, dtype=jnp.int32), (2, 9))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, causal=False, use_rope=False)
    oj, _ = jax.jit(lambda p, xx: jattention(p, xx, pos, policy=jpol, **kw))(ap, x)
    ot, _ = attention_apply(j2t_tree(ap), j2t(x), torch.from_numpy(np.array(pos)),
                            policy=tpol, **kw)
    np.testing.assert_array_equal(np.asarray(oj).astype(np.float32), t2n(ot))
    # use_rope matters: rotated, the output moves
    rot, _ = attention_apply(j2t_tree(ap), j2t(x), torch.from_numpy(np.array(pos)),
                             policy=tpol, **dict(kw, use_rope=True))
    assert not torch.equal(rot, ot)
    mp = jmlp_init(jax.random.PRNGKey(2), 64, 128, act="gelu")
    assert sorted(mp) == ["down_proj", "up_proj"]
    yj = jax.jit(lambda p, xx: jmlp(p, xx, act="gelu", policy=jpol))(mp, x)
    yt = mlp_apply(j2t_tree(mp), j2t(x), act="gelu", policy=tpol)
    np.testing.assert_array_equal(np.asarray(yj).astype(np.float32), t2n(yt))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b", "yi-6b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_matches_reference(arch, kind):
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    seq = 16 + jc.num_patches
    structs = jinputs.batch_struct(jc, 3, seq, kind)
    assert {k: (tuple(s.shape), np.dtype(s.dtype).name) for k, s in structs.items()} == \
        {k: (shape, str(dt).split(".")[1]) for k, (shape, dt) in
         inputs.batch_struct(tc, 3, seq, kind).items()}
    jb, tb = _batches(tc, 3, seq, kind, seed=8)
    assert list(jb) == list(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    if not torch.cuda.is_available():  # the card by default, never a quiet fall back
        with pytest.raises(RuntimeError, match="device='cpu'"):
            inputs.make_batch(tc, 1, seq, kind)


def test_float32_epilogue_takes_the_kernels_raw_accumulator(monkeypatch, rng):
    """The fused kernel's epilogue writes bf16 (its wrapper raises for
    another ``out_dtype``): on the card, the encoder's float32 projections
    take the kernel's raw int32 accumulator and the plain epilogue, which
    gives the plain route's float32 output bit for bit. Shown on the host
    with the kernel's wrapper replaced by a stub that refuses what the
    kernel refuses and returns the plain raw accumulator."""
    from repro_torch.core import bitplanes as tbp
    from repro_torch.kernels import ops, plane_mm_fused

    calls = []

    def kernel(x_q, packed_w, pair_w, *, a_scale=None, out_dtype=torch.bfloat16, bm=None,
               gate=False, k_split=None, **kw):
        if a_scale is not None and out_dtype != torch.bfloat16:
            raise ValueError(f"the kernel's epilogue writes bfloat16, got {out_dtype}")
        calls.append(a_scale is None)
        return plane_mm_fused.fused_plane_linear_plain(x_q, packed_w, pair_w, a_scale=a_scale,
                                                       out_dtype=out_dtype, **kw)

    x_q = torch.from_numpy(rng.integers(-128, 128, (5, 96)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-128, 128, (96, 40)).astype(np.int8))
    wp = tbp.make_weight_planes(w_q, w_bits=8, variant="booth", level="bitplane").packed
    ep = ops.Epilogue(a_scale=torch.from_numpy(rng.random((5, 1)).astype(np.float32)),
                      w_scale=torch.from_numpy(rng.random((1, 40)).astype(np.float32)),
                      activation="gelu", out_dtype=torch.float32)
    plain = ops.fused_linear(x_q, wp, ep, a_bits=8, variant="booth", backend="torch")
    monkeypatch.setattr(plane_mm_fused, "fused_plane_linear", kernel)
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device=None: "cuda")
    got = ops.fused_linear(x_q, wp, ep, a_bits=8, variant="booth")
    assert calls == [True] and got.dtype == torch.float32
    assert torch.equal(got, plain)
    ops.fused_linear(x_q, wp, ep._replace(out_dtype=torch.bfloat16), a_bits=8, variant="booth")
    assert calls == [True, False]  # bf16: the kernel's own epilogue
