"""Port parity of tensor-parallel serving (``sharding/tp.py``), on the CPU.

The ranks are processes spawned by ``launch/mesh.spawn_tp`` over gloo
(FileStore rendezvous in ``tmp_path``), one spawn per world size, each
running every case of its size (``_torch_tp_ranks.py``). On the reference
test's setup (reduced granite-3-8b with 4 KV heads, prompts 5/9/13/7/11,
6 new tokens, 2 slots: requests are evicted and readmitted), with weights
carried from the JAX package through numpy:

* ``tp_role`` and ``quantize(amax=)`` equal the reference's;
* ``shard_quantized_all`` at P=2 and 4 (integrity off and detect, sparsity
  compact) equals ``repro.sharding.tp.shard_quantized``'s stacked leaves,
  shard for shard, and ``plane_cache_device_bytes`` the reference's; under
  compaction the kept planes are those alive in any shard; each rank's
  ``shard_quantized`` is its element of ``shard_quantized_all``;
* the decode attention over one rank's heads gives the whole's bits;
* row-, column- and vocab-parallel ``linear_apply`` at P=2 is bit-equal
  to the single-device call (the row one also through ``x_f32``);
* the engine's greedy tokens at P=2 and 4 equal the port's single-device
  engine's and the JAX engine's; at P=2 also with chunked prefill, paged
  KV and ``integrity="detect"`` (no alarm, the single-device ABFT check
  count), and one flipped plane bit on rank 1 alarms on both ranks;
* tensor-parallel plans key on local shapes and their role, row plans
  without an epilogue; the engine refuses what the reference refuses, with
  its messages, and what is ROADMAP item 11b.
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
from repro.core.quantize import quantize as jquantize
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.models import quant as jquant_mod
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro.sharding import tp as jtp
from repro_torch.configs import get_reduced as tget
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.quantize import quantize
from repro_torch.launch.mesh import spawn_tp
from repro_torch.launch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.models.quant import map_linears
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import params_from_numpy
from repro_torch.sharding import tp as ttp

import _torch_tp_ranks as ranks
from _torch_parity import (reference_layout, reference_quantizes_to, t2n, to_numpy_tree,
                           weight_planes_to_jax)

DENSE_ARCHS = ("granite-3-8b", "yi-6b", "llama3-405b", "deepseek-coder-33b")


@pytest.fixture(scope="module")
def weights():
    """The JAX package's weights of the setup, as numpy (the ranks' input)
    and as the port's tree."""
    jcfg = dataclasses.replace(jget(ranks.ARCH), n_kv_heads=4)
    jp = jax.jit(lambda k: jinit(jcfg, k))(jax.random.PRNGKey(0))
    tree = to_numpy_tree(jp)
    return jcfg, jp, tree, params_from_numpy(ranks.config(), tree, device="cpu")


@pytest.fixture(scope="module")
def single(weights):
    """The port's single-device engine in every case."""
    cfg, params = ranks.config(), weights[3]
    return {case: ranks.serve(cfg, params, case) for case in ranks.CASES}


@pytest.fixture(scope="module")
def p2(weights, tmp_path_factory):
    """Every rank's results at P=2 (one spawn)."""
    return spawn_tp(ranks.rank_p2, 2, device="cpu", args=(weights[2],),
                    store_dir=str(tmp_path_factory.mktemp("tp2")))


@pytest.fixture(scope="module")
def p4(weights, tmp_path_factory):
    """Every rank's results at P=4 (one spawn)."""
    return spawn_tp(ranks.rank_p4, 4, device="cpu", args=(weights[2],),
                    store_dir=str(tmp_path_factory.mktemp("tp4")))


def _linear_paths(cfg) -> list:
    paths = []
    gen = torch.Generator().manual_seed(0)
    map_linears(tinit(cfg, gen), cfg, lambda node, path: paths.append(path) or node)
    return paths


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_tp_role_equals_reference(arch):
    paths = _linear_paths(tget(arch))
    assert paths
    names = paths + ["lm_head", "layers/dense/attn/o_proj", "embed"]
    assert [ttp.tp_role(p) for p in names] == [jtp.tp_role(p) for p in names]
    assert {ttp.tp_role(p) for p in paths} == {"col", "row", "vocab"}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_with_amax_equals_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    # the maximum over the row's other slices: at least the local one
    amax = np.maximum(np.abs(x).max(-1, keepdims=True),
                      np.abs(rng.standard_normal((3, 5, 1)) * 3)).astype(np.float32)
    ref = jax.jit(lambda a, m: jquantize(a, bits, axis=-1, amax=m))(x, amax)
    got = quantize(torch.from_numpy(x), bits, axis=-1, reciprocal_scale=True,
                   amax=torch.from_numpy(amax))
    np.testing.assert_array_equal(t2n(got.values), np.asarray(ref.values))
    np.testing.assert_array_equal(t2n(got.scale), np.asarray(ref.scale))


def _assert_equal(got, want):
    def host(a):
        return np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a)

    np.testing.assert_array_equal(host(got), host(want))


def _assert_shards_equal(cfg, shards, ref, specs):
    """Rank ``r``'s tree (in the reference's layout) against the
    reference's: its stacked leaves at index ``r``, its replicated ones
    whole."""
    want, wdef = jax.tree_util.tree_flatten(ref)
    spec_leaves = [sp for _, sp in jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]]
    assert len(spec_leaves) == len(want)
    for r, shard in enumerate(shards):
        got, gdef = jax.tree_util.tree_flatten(reference_layout(cfg, shard))
        assert gdef == wdef
        for g, w, sp in zip(got, want, spec_leaves):
            _assert_equal(g, w[r] if len(sp) and sp[0] is not None else w)


@contextlib.contextmanager
def _reference_quantizes_to(make):
    """``repro.sharding.tp.shard_quantized`` takes ``make()`` as the result
    of its global quantization."""
    orig = jquant_mod.quantize_params
    jquant_mod.quantize_params = lambda *a, **k: make()
    try:
        yield
    finally:
        jquant_mod.quantize_params = orig


POLICIES = {"off": {}, "detect": {"integrity": "detect"}, "compact": {"sparsity": "compact"}}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("mode", list(POLICIES))
def test_shard_quantized_equals_reference(weights, size, mode):
    """Each rank's shard equals the reference's stacked leaves, shard for
    shard. Compact runs at value_bits=4 (a narrow checkpoint in the 8-bit
    cache), whose top planes are dead in every layer and shard."""
    jcfg, jp, _, tparams = weights
    cfg = ranks.config()
    vb = 4 if mode == "compact" else None
    kw = dict(level="bitplane", variant="booth", **POLICIES[mode])
    tpol = TPolicy.uniform(8, 8, **kw)
    shards = ttp.shard_quantized_all(tparams, tpol, size, cfg=cfg, value_bits=vb)
    # the reference slices and decomposes per shard the global quantization
    # it is handed: the port's, in its layout (held equal to the
    # reference's own by test_torch_serving.py; its eager quantization
    # compiles op by op for seconds)
    whole = tquantize_params(tparams, tpol, cfg=cfg, plane_cache=True, value_bits=vb)
    with _reference_quantizes_to(lambda: reference_layout(cfg, whole)):
        ref, specs = jtp.shard_quantized(jp, JPolicy.uniform(8, 8, **kw),
                                         jtp.TPContext(mesh=None, size=size), value_bits=vb)
    _assert_shards_equal(cfg, shards, ref, specs)
    for s in shards:
        assert ttp.plane_cache_device_bytes(s) == jtp.plane_cache_device_bytes(
            ref, specs, n_shards=size)


def test_compaction_keeps_the_planes_alive_in_any_shard():
    """Shard 0's columns of a weight are all zero (every plane dead there):
    it keeps the planes alive in shard 1, as the reference's stacked pack
    does, not one inert plane."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 32)).astype(np.float32) * 0.1
    w[:, :16] = 0.0
    kw = dict(level="bitplane", variant="booth", sparsity="compact")
    shards = ttp.shard_quantized_all({"mlp": {"gate_proj": {"w": torch.from_numpy(w)}}},
                                     TPolicy.uniform(8, 8, **kw), 2, cfg=None)
    ref, _ = jtp.shard_quantized({"mlp": {"gate_proj": {"w": jnp.asarray(w)}}},
                                 JPolicy.uniform(8, 8, **kw), jtp.TPContext(mesh=None, size=2))
    wps = [s["mlp"]["gate_proj"]["w_planes"] for s in shards]
    assert wps[0].weights == wps[1].weights == ref["mlp"]["gate_proj"]["w_planes"].weights
    assert len(wps[0].weights) > 1
    want = jax.tree_util.tree_leaves(ref["mlp"]["gate_proj"]["w_planes"])
    for r, wp in enumerate(wps):
        got = jax.tree_util.tree_leaves(weight_planes_to_jax(wp))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w[r])


def test_each_rank_builds_its_element_of_shard_quantized_all(p2):
    """Each rank's ``shard_quantized`` (its row slices quantized with the
    column maxima all-reduced, compaction's kept planes all-reduced) is
    ``shard_quantized_all``'s element for that rank, leaf for leaf."""
    for rank in p2:
        assert rank["own_shards"] == {"off": True, "compact": True}, f"rank {rank['rank']}"


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_decode_attention_over_head_slices_is_bit_equal(size, kv):
    """The decode attention over one rank's heads gives the whole heads'
    bits for those heads (each KV head is attended on its own), with an
    int8 cache and its scales or a raw bf16 cache."""
    from repro_torch.layers.attention import _decode_gqa

    gen = torch.Generator().manual_seed(size)
    b, s, hq, hkv, d = 3, 40, 16, 8, 64
    q = torch.randn((b, 1, hq, d), generator=gen).to(torch.bfloat16)
    valid = torch.arange(s)[None, :] < torch.tensor([[1], [17], [40]])
    if kv == "int8":
        k, v = (torch.randint(-127, 128, (b, s, hkv, d), generator=gen, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand((b, s, hkv), generator=gen) * 0.01 for _ in range(2))
    else:
        k, v = (torch.randn((b, s, hkv, d), generator=gen).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    whole = _decode_gqa(q, k, v, valid, ks, vs)
    hs, kh = hq // size, hkv // size
    for r in range(size):
        sl = slice(r * kh, (r + 1) * kh)
        part = _decode_gqa(q[:, :, r * hs:(r + 1) * hs], k[:, :, sl], v[:, :, sl], valid,
                           None if ks is None else ks[:, :, sl],
                           None if vs is None else vs[:, :, sl])
        assert torch.equal(part, whole[:, :, r * hs:(r + 1) * hs]), f"rank {r}"


def test_linear_roles_bit_equal_single_device(p2):
    for rank in p2:
        assert len(rank["linear"]) == 4
        for case, (got, want) in rank["linear"].items():
            assert got == want, f"rank {rank['rank']}: {case}"


def test_tp_prefill_and_chunk_steps_equal_single_device(p2):
    """The tensor-parallel prefill step, and two chunks through the chunk
    step, give the single-device prefill's last logits bit for bit."""
    for rank in p2:
        single, whole, chunked = rank["prefills"]
        assert whole == single and chunked == single, f"rank {rank['rank']}"


def _jax_tokens(weights) -> dict:
    """The JAX engine's tokens, its weights quantized by the port (held
    equal to its own quantization by test_torch_serving.py)."""
    jcfg, jp, _, tparams = weights
    cfg = ranks.config()
    whole = tquantize_params(tparams, ranks.policy(), cfg=cfg, plane_cache=True)
    with reference_quantizes_to(lambda: reference_layout(cfg, whole)):
        engine = JEngine(jcfg, jp, JPolicy.uniform(8, 8, level="bitplane", variant="booth"),
                         n_slots=ranks.N_SLOTS, max_len=ranks.MAX_LEN)
    results, _ = engine.run(ranks.requests(jcfg, JRequest))
    return {rid: np.asarray(t).tolist() for rid, t in results.items()}


def test_engine_tokens_equal_single_device_and_reference(weights, single, p2, p4):
    base = single["dense"]
    assert not base["failed"] and sorted(base["tokens"]) == list(range(len(ranks.LENS)))
    assert base["tokens"] == _jax_tokens(weights)
    for every in (p2, [r["dense"] for r in p4]):
        for rank in every:
            res = rank["cases"]["dense"] if "cases" in rank else rank
            assert res["tokens"] == base["tokens"]
            # each rank holds ~1/P of the plane bytes
            assert res["plane_bytes"] <= 0.6 * base["plane_bytes"] * 2 / len(every)


@pytest.mark.parametrize("case", ["chunked", "paged", "detect"])
def test_engine_cases_at_p2(single, p2, case):
    for rank in p2:
        got = rank["cases"][case]
        assert got["tokens"] == single[case]["tokens"], f"rank {rank['rank']}"
        if case == "detect":
            ig, ig1 = got["integrity"], single["detect"]["integrity"]
            assert ig["abft_alarms"] == ig["audit_alarms"] == ig["kv_alarms"] == 0
            assert ig["abft_checks"] == ig1["abft_checks"] > 0


def test_flipped_bit_on_one_rank_alarms_on_every_rank(p2):
    for rank in p2:
        ig = rank["flipped"]["integrity"]
        assert ig["abft_alarms"] >= 1 and ig["audit_alarms"] >= 1, f"rank {rank['rank']}: {ig}"


def test_shard_plan_keys(p2):
    cfg = ranks.config()
    for rank in p2:
        sharded = [k for k in rank["plan_keys"] if k[3] is not None]
        assert sharded
        assert all(k[3][:2] == ("model", 2) for k in sharded)
        assert {k[3][2] for k in sharded} == {"col", "row", "vocab"}
        unsharded = {k for k in rank["plan_keys"] if k[3] is None}
        for m, k, n, shard, has_epilogue in sharded:
            role = shard[2]
            if role == "row":
                assert not has_epilogue and k in (cfg.d_model // 2, cfg.d_ff // 2)
            else:
                assert has_epilogue
                assert n in (cfg.n_heads * cfg.head_dim // 2, cfg.n_kv_heads * cfg.head_dim // 2,
                             cfg.d_ff // 2, cfg.vocab_padded // 2)
            assert (m, k, n, None, has_epilogue) not in unsharded or role != "row"


def test_tp_validation(weights):
    cfg, params = ranks.config(), weights[3]
    pol = ranks.policy()
    jcfg, jp = weights[0], weights[1]
    with pytest.raises(ValueError, match="active quantization") as t_err:
        TEngine(cfg, params, TPolicy.off(), device="cpu", model_parallel=2)
    with pytest.raises(ValueError) as j_err:
        JEngine(jcfg, jp, JPolicy.off(), model_parallel=2)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="<= 8-bit") as t_err:
        TEngine(cfg, params, TPolicy.uniform(12, 12, level="digit"), device="cpu",
                model_parallel=2)
    with pytest.raises(ValueError) as j_err:
        JEngine(jcfg, jp, JPolicy.uniform(12, 12, level="digit"), model_parallel=2)
    assert str(t_err.value) == str(j_err.value)
    # the stock reduced config has 2 KV heads: indivisible at 4
    with pytest.raises(ValueError, match="divide") as t_err:
        TEngine(tget(ranks.ARCH), params, pol, device="cpu", model_parallel=4)
    assert str(t_err.value) == ("model_parallel=4 must divide n_heads=8 and n_kv_heads=2 "
                                "(head-parallel attention + head-parallel KV cache)")
    with pytest.raises(ValueError, match="initialised default process group"):
        TEngine(cfg, params, pol, device="cpu", model_parallel=2)


@pytest.mark.parametrize("what, kw", [
    ("integrity='scrub'", dict(policy=dict(integrity="scrub"))),
    ("the autopilot", dict(autopilot=True)),
    ("the tile autotuner", dict(autotune=True)),
    ("the ssm family", dict(arch="mamba2-1.3b")),
])
def test_later_items_refused_naming_11b(weights, what, kw):
    from repro_torch.runtime.autopilot import AutopilotPolicy

    cfg = tget(kw["arch"]) if "arch" in kw else ranks.config()
    params = weights[3] if "arch" not in kw else tinit(cfg, torch.Generator().manual_seed(0))
    eng_kw = {}
    if kw.get("autopilot"):
        eng_kw["autopilot"] = AutopilotPolicy(sla_queue_steps=2)
    if kw.get("autotune"):
        eng_kw["autotune"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP item 11b") as err:
        TEngine(cfg, params, ranks.policy(**kw.get("policy", {})), device="cpu",
                model_parallel=2, **eng_kw)
    assert what in str(err.value)


def test_cache_specs_name_the_head_axes():
    from repro_torch.models import paging
    from repro_torch.models.cache import init_cache

    cfg = ranks.config()
    tp = ttp.TPContext(size=2)
    dense = tp.cache_specs(init_cache(cfg, 2, 8, cfg.dtype, kv_quant=True))
    blk = dense["layers"][0]
    assert (blk["k_q"], blk["v_q"], blk["k_scale"], blk["v_scale"], blk["len"]) == (2, 2, 2, 2,
                                                                                  None)
    assert dense["step"] is None
    paged = tp.cache_specs(paging.paged_init_cache(cfg, 2, 8, 4, 5))
    pblk = paged["layers"][0]
    assert pblk["k_q"] == 2 and pblk["k_scale"] == 2 and pblk["block_table"] is None
    with pytest.raises(ValueError, match="does not divide"):
        ttp.TPContext(size=3).cache_specs(init_cache(cfg, 2, 8, cfg.dtype, kv_quant=True))
