"""MoE serving parity on the CPU: reduced qwen3-moe-235b-a22b (128 -> 8
experts, top-2) and llama4-scout-17b-a16e (4 experts, top-1), both with
the configs' capacity factor 2.0, against the reference.

* ``forward`` logits with the policy off and at w8a8 with the router kept
  dense (``keep_dense=("router",)``, the reference's serving policy): at
  w8a8 bit-equal; off, within ``OFF_ATOL`` with 99% of the logits equal
  (measured: one logit in 12288 a bf16 step apart — a float32 product
  summed in another order).
* Both engines (continuous batching with staggered arrivals into 2 slots,
  and lockstep) give the reference engines' greedy tokens, at w8a8 with
  the router dense. The reference is handed the port's quantized tree
  (its eager quantization costs seconds; the trees are held equal by
  ``tests/test_torch_serving.py``, and the expert stacks are not
  quantized at load).
* One decode step in which a free slot's copy takes a live slot's place:
  at 2 slots an expert holds one decode copy (``int(2 * 2 * 1 / 4)``), and
  the free slot 0 comes first in the flat (token, k) order. The live
  slot's logits move with the free slot's token, and equal the
  reference's step on the same cache.
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
from repro.launch import steps as jsteps
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import serve, steps
from repro_torch.layers import moe as tmoe
from repro_torch.models import cache as tcache
from repro_torch.models.quant import quantize_params
from repro_torch.models.transformer import forward as tforward
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import j2t, reference_layout, reference_quantizes_to, t2n, to_numpy_tree

MOE = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
OFF_ATOL = 0.02  # a few bf16 steps at |logit| < 4
KEEP = ("router",)

_P: dict = {}


def _setup(arch, scan_layers=True):
    key = (arch, scan_layers)
    if key not in _P:
        jc = dataclasses.replace(jconfigs.get_reduced(arch), scan_layers=scan_layers)
        tc = dataclasses.replace(tconfigs.get_reduced(arch), scan_layers=scan_layers)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        tp = params_from_numpy(tc, to_numpy_tree(jp), device="cpu")
        tpol = TPolicy.uniform(8, 8, level="bitplane", keep_dense=KEEP)
        tq = quantize_params(tp, tpol, plane_cache=True, cfg=tc)
        _P[key] = (jc, tc, jp, tp, tq, reference_layout(tc, tq))
    return _P[key]


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_match_reference(arch, rng):
    jc, tc, jp, tp, tq, jq = _setup(arch)
    toks = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    jpol = JPolicy.uniform(8, 8, level="bitplane", keep_dense=KEEP)
    tpol = TPolicy.uniform(8, 8, level="bitplane", keep_dense=KEEP)
    for jtree, ttree, jpo, tpo in ((jp, tp, JPolicy.off(), TPolicy.off()), (jq, tq, jpol, tpol)):
        lj, aj, _ = jax.jit(lambda p, t: jforward(jc, p, {"tokens": t}, policy=jpo))(
            jtree, jnp.asarray(toks))
        lt, at, _ = tforward(tc, ttree, {"tokens": torch.from_numpy(toks)}, policy=tpo)
        a, b = np.asarray(lj).astype(np.float32), t2n(lt)
        if tpo.default.active:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=OFF_ATOL, rtol=0)
            assert (a == b).mean() >= 0.99
        np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
        assert float(at) > 0  # the layers' load-balancing losses, summed


@pytest.mark.parametrize("arch", MOE)
def test_engines_match_reference_engines(arch):
    jc, tc, jp, tp, tq, jq = _setup(arch)
    jpol = JPolicy.uniform(8, 8, level="bitplane", keep_dense=KEEP)
    tpol = TPolicy.uniform(8, 8, level="bitplane", keep_dense=KEEP)
    prompts = [np.random.default_rng(1).integers(0, jc.vocab_size, (s,)) for s in (5, 9, 7, 3)]
    with reference_quantizes_to(lambda: jq):
        je = jserve.ContinuousBatchingEngine(jc, jp, jpol, n_slots=2, max_len=24)
        jl = jserve.Engine(jc, jp, jpol, max_len=16)
    te = serve.ContinuousBatchingEngine(tc, tp, tpol, n_slots=2, max_len=24, device="cpu")
    rj, _ = je.run([JRequest(rid=i, tokens=p, max_new_tokens=6, arrival_step=i)
                    for i, p in enumerate(prompts)])
    rt, _ = te.run([TRequest(rid=i, tokens=p, max_new_tokens=6, arrival_step=i)
                    for i, p in enumerate(prompts)])
    assert sorted(rt) == sorted(rj)
    for rid in rj:
        np.testing.assert_array_equal(np.asarray(rj[rid]), rt[rid], err_msg=f"rid {rid}")
    batch = np.stack([prompts[0][:3], prompts[1][:3]]).astype(np.int32)
    lj, _ = jl.generate(jnp.asarray(batch), 5)
    lt, _ = serve.Engine(tc, tp, tpol, max_len=16, device="cpu").generate(batch, 5)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())


def test_free_slot_copy_takes_a_live_slots_place():
    arch = "llama4-scout-17b-a16e"
    jc, tc, jp, tp, tq, jq = _setup(arch, scan_layers=False)
    assert tmoe._capacity_for(2, tc.top_k, tc.n_experts, tc.n_experts,
                              tc.moe_capacity_factor) == 1
    jpol = JPolicy.uniform(8, 8, level="bitplane", keep_dense=KEEP)
    tpol = TPolicy.uniform(8, 8, level="bitplane", keep_dense=KEEP)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, tc.vocab_size, (1, 6)))
    logits, seq = steps.make_prefill_step(tc, tpol, max_len=16, kv_quant=True)(
        tq, prompt.to(torch.int32))
    live_tok = int(torch.argmax(logits[0, :tc.vocab_size]))
    decode = steps.make_decode_step(tc, tpol)
    jdecode = jax.jit(jsteps.make_decode_step(jc, jpol))

    def step(free_tok):
        cache = tcache.insert_slot(tcache.init_cache(tc, 2, 16, kv_quant=True, device="cpu"),
                                   seq, 1)  # slot 0 free: length 0
        # copies: the port's step updates its cache in place
        jcache = {"step": jnp.array(t2n(cache["step"]), copy=True),
                  "layers": [{k: jnp.array(t2n(v), copy=True) for k, v in blk.items()}
                             for blk in cache["layers"]]}
        toks = torch.tensor([[free_tok], [live_tok]], dtype=torch.int32)
        with tmoe.record_drops() as log:
            lt, _ = decode(tq, cache, toks)
        lj, _ = jdecode(jq, jcache, {"tokens": jnp.asarray(toks.numpy())})
        np.testing.assert_array_equal(np.asarray(lj).astype(np.float32), t2n(lt))
        return lt[1], sum(int(d) for _, _, d in log)

    results = {t: step(t) for t in range(12)}
    dropped = [t for t, (_, n) in results.items() if n]
    kept = [t for t, (_, n) in results.items() if not n]
    assert dropped and kept, results
    # with cap 1 the free slot's copy (first in flat order) wins its
    # expert: the live slot's copy is dropped and its logits move
    assert not torch.equal(results[dropped[0]][0], results[kept[0]][0])
    # without a drop the live slot's logits do not depend on the free slot
    assert all(torch.equal(results[t][0], results[kept[0]][0]) for t in kept)
