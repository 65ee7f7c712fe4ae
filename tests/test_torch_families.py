"""The port's model registry and CLI against the reference's, on the CPU.

* The registry is the reference's ten architectures, and every config is
  the reference's, field for field, full and reduced (with
  ``param_count`` and ``active_param_count``).
* The two dense configs added with the SSM and hybrid families,
  llama3-405b and deepseek-coder-33b, at ``REDUCED``: w8a8 forward logits
  bit-equal and the continuous-batching engine's greedy tokens equal.
* The caches of the new families: the windowed ring of
  ``min(window, max_len)`` rows, the recurrent leaves, ``insert_slot`` /
  ``select_slots`` / ``quantize_scratch`` (recurrent leaves pass through),
  ``cache_kv_bytes`` (KV leaves only) and ``cache_slot_checksums`` value
  for value against the reference's.
* The serving CLI's defaults are the reference's for every flag the two
  parsers share (``--arch`` is yi-6b in both), and its ``--arch`` choices
  are the reference's ten; ``--bits`` on an MoE arch dies naming
  reference defect G (the CLI's uniform policy would quantize the router).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro import configs as jconfigs
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import serve as jserve
from repro.models import cache as jcache
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import serve
from repro_torch.models import cache as tcache
from repro_torch.models.config import ModelConfig
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import forward as tforward
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import j2t, reference_layout, reference_quantizes_to, t2n, to_numpy_tree

NEW_DENSE = ("llama3-405b", "deepseek-coder-33b")


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_registered_configs_are_the_references(arch):
    for getter in ("get_config", "get_reduced"):
        jc, tc = getattr(jconfigs, getter)(arch), getattr(tconfigs, getter)(arch)
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), (arch, getter, f.name)
        assert tc.layer_kinds() == jc.layer_kinds()
        assert (tc.has_attention, tc.supports_long_context) == \
            (jc.has_attention, jc.supports_long_context)


def test_registry_is_the_references():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for arch in tconfigs.ARCH_NAMES:
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        assert (tc.param_count(), tc.active_param_count()) == \
            (jc.param_count(), jc.active_param_count()), arch
    with pytest.raises(ValueError, match="unknown family"):
        ModelConfig(name="x", family="conv", n_layers=2, d_model=8, vocab_size=16).layer_kinds()


_P: dict = {}


def _params(arch):
    if arch not in _P:
        jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        _P[arch] = (jc, tc, jp, params_from_numpy(tc, to_numpy_tree(jp), device="cpu"))
    return _P[arch]


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_new_dense_configs_equal_reference(arch, rng):
    """The reference is handed the port's quantized tree in its (scanned)
    layout — the quantization itself is held equal on the dense family by
    test_torch_serving.py — which spares its eager quantization."""
    jc, tc, jp, tp = _params(arch)
    toks = rng.integers(0, jc.vocab_size, (1, 12)).astype(np.int32)
    jpol, tpol = JPolicy.uniform(8, 8, level="bitplane"), TPolicy.uniform(8, 8, level="bitplane")
    tq = tquantize_params(tp, tpol, plane_cache=True, cfg=tc)
    jq = reference_layout(tc, tq)
    lj = jax.jit(lambda p, t: jforward(jc, p, {"tokens": t}, policy=jpol)[0])(jq, jnp.asarray(toks))
    lt = tforward(tc, tq, {"tokens": torch.from_numpy(toks)}, policy=tpol)[0]
    np.testing.assert_array_equal(np.asarray(lj).astype(np.float32), t2n(lt))
    prompts = [np.random.default_rng(1).integers(0, jc.vocab_size, (s,)) for s in (5, 9)]
    with reference_quantizes_to(lambda: jq):
        je = jserve.ContinuousBatchingEngine(jc, jp, jpol, n_slots=2, max_len=16)
    te = serve.ContinuousBatchingEngine(tc, tp, tpol, n_slots=2, max_len=16, device="cpu")
    rj, _ = je.run([JRequest(rid=i, tokens=p, max_new_tokens=4, arrival_step=i)
                    for i, p in enumerate(prompts)])
    rt, _ = te.run([TRequest(rid=i, tokens=p, max_new_tokens=4, arrival_step=i)
                    for i, p in enumerate(prompts)])
    for rid in rj:
        np.testing.assert_array_equal(np.asarray(rj[rid]), rt[rid], err_msg=f"rid {rid}")


def _fill(tree, rng):
    """The same random values in a reference cache and the port's."""
    def one(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return jnp.asarray(rng.normal(size=a.shape), jnp.bfloat16)
        if a.dtype.kind == "f":
            return jnp.asarray(rng.normal(size=a.shape).astype(a.dtype))
        return jnp.asarray(rng.integers(-100, 100, a.shape).astype(a.dtype))
    return jax.tree_util.tree_map(one, tree)


def _port_cache(jtree):
    return {"step": j2t(jtree["step"]),
            "layers": [{k: j2t(v) for k, v in blk.items()} for blk in jtree["layers"]]}


@pytest.mark.parametrize("arch, max_len", [("mamba2-1.3b", 12), ("recurrentgemma-2b", 12),
                                           ("recurrentgemma-2b", 40)])
def test_new_caches_equal_reference(arch, max_len, rng):
    jc = dataclasses.replace(jconfigs.get_reduced(arch), scan_layers=False)
    tc = dataclasses.replace(tconfigs.get_reduced(arch), scan_layers=False)
    for quant in (False, True):
        jz = jcache.init_cache(jc, 3, max_len, kv_quant=quant)
        tz = tcache.init_cache(tc, 3, max_len, kv_quant=quant, device="cpu")
        assert [sorted(b) for b in jz["layers"]] == [sorted(b) for b in tz["layers"]]
        for jb, tb in zip(jz["layers"], tz["layers"]):
            for k in jb:
                assert tuple(jb[k].shape) == tuple(tb[k].shape), k
                assert t2n(tb[k]).dtype == np.asarray(jb[k]).astype(
                    np.float32 if jb[k].dtype == jnp.bfloat16 else jb[k].dtype).dtype
        if arch.startswith("recurrent"):  # the ring: min(window, max_len) rows
            assert tz["layers"][2]["k_q" if quant else "k"].shape[1] == min(16, max_len)
        assert tcache.cache_kv_bytes(tz) == jcache.cache_kv_bytes(jz)
    ja = _fill(jcache.init_cache(jc, 3, max_len, kv_quant=True), rng)
    jb = _fill(jcache.init_cache(jc, 3, max_len, kv_quant=True), rng)
    ta, tb = _port_cache(ja), _port_cache(jb)
    np.testing.assert_array_equal(np.asarray(jcache.cache_slot_checksums(ja)),
                                  t2n(tcache.cache_slot_checksums(ta)))
    take = np.array([True, False, True])
    sel_j = jcache.select_slots(ja, jb, take)
    sel_t = tcache.select_slots(ta, tb, take)
    for x, y in zip(jax.tree_util.tree_leaves(sel_j), jax.tree_util.tree_leaves(sel_t)):
        np.testing.assert_array_equal(np.asarray(x).astype(np.float32) if x.dtype == jnp.bfloat16
                                      else np.asarray(x), t2n(y))
    raw_j = _fill(jcache.init_cache(jc, 1, max_len), rng)
    seq_j = jax.jit(repro.models.paging.quantize_scratch)(raw_j)  # compiled, as served
    seq_t = tcache.quantize_scratch(_port_cache(raw_j))
    ins_j = jcache.insert_slot(ja, seq_j, 1)
    ins_t = tcache.insert_slot(ta, seq_t, 1)
    for x, y in zip(jax.tree_util.tree_leaves(ins_j), jax.tree_util.tree_leaves(ins_t)):
        np.testing.assert_array_equal(np.asarray(x).astype(np.float32) if x.dtype == jnp.bfloat16
                                      else np.asarray(x), t2n(y))


def test_cli_defaults_are_the_references():
    jargs = vars(jserve.build_parser().parse_args([]))
    targs = vars(serve.build_parser().parse_args([]))
    shared = sorted(set(jargs) & set(targs))
    assert "arch" in shared and len(shared) > 20
    for k in shared:
        assert targs[k] == jargs[k], k
    assert targs["arch"] == "yi-6b"
    tchoices = next(a.choices for a in serve.build_parser()._actions if a.dest == "arch")
    jchoices = next(a.choices for a in jserve.build_parser()._actions if a.dest == "arch")
    assert tuple(tchoices) == tuple(jchoices) == jconfigs.ARCH_NAMES
    for arch in ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"):
        with pytest.raises(SystemExit, match="defect G"):
            serve.validate_args(serve.build_parser().parse_args(["--arch", arch, "--bits", "8"]))
        serve.validate_args(serve.build_parser().parse_args(["--arch", arch, "--bits", "0"]))


@pytest.mark.parametrize("variant", ["booth", "sbmwc"])
def test_wide_weight_decomposes_in_column_chunks(variant, monkeypatch, rng):
    """A weight wider than the decomposition's chunk (a vocabulary-wide head)
    is decomposed in column chunks: words, planes, occupancy and checksums
    equal the one-piece decomposition's; unpacking in column chunks gives
    the planes back."""
    from repro_torch.core import bitplanes as bp

    w = torch.from_numpy(rng.integers(-128, 128, (200, 300)).astype(np.int32))
    w[:, 7] = 0  # an all-zero column
    kw = dict(w_bits=8, variant=variant, level="bitplane", checksum=True)
    whole = bp.make_weight_planes(w, **kw)
    monkeypatch.setattr(bp, "_DECOMPOSE_WEIGHTS", 200 * 64)
    parts = bp.make_weight_planes(w, **kw)
    for field in ("mag", "sign", "occupancy", "checksum"):
        a, b = getattr(whole.packed, field), getattr(parts.packed, field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert torch.equal(whole.planes, parts.planes)
    assert torch.equal(bp.unpack_planes(parts.packed), whole.planes.to(torch.int8))
    assert (whole.packed.k, whole.packed.block, whole.packed.weights) == \
        (parts.packed.k, parts.packed.block, parts.packed.weights)
