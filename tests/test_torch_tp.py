"""Port parity of tensor-parallel serving (``sharding/tp.py``), on the CPU.

The ranks are processes spawned by ``launch/mesh.spawn_ranks`` over gloo
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
* so do they at P=2 and 4 under ``integrity="scrub"`` with a plane bit
  flipped on rank 1 (found on every rank, one scrub each, the load-time
  fingerprint restored, each rank's retained source only its own slices),
  under the autopilot (a burst that mixes two tiers: the same switches and
  tiers on every rank), under the tile autotuner (cold on a fresh store,
  warm from it; every rank plans the same tiles, rank 0 alone keeps the
  one store) and with the vocab head kept dense (replicated);
* the layer-by-layer loader (``load_shard``) at P=2 and 4 gives each
  rank's element of ``shard_quantized_all`` of the whole tree, leaf for
  leaf, for granite and deepseek-coder-33b, compaction on and off, and the
  scrub's rebuild from its source gives it again;
* tensor-parallel plans key on local shapes and their role, row plans
  without an epilogue; the engine refuses what the reference refuses, with
  its messages (an encoder, heads that do not divide), and a dense column-
  or row-parallel projection (reference defect I: the reference's engine
  crashes on it, measured in a subprocess with 2 XLA host devices).
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

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
from repro_torch.launch.mesh import spawn_ranks
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
def single(weights, tmp_path_factory):
    """The port's single-device engine in every case."""
    cfg, params = ranks.config(), weights[3]
    store = str(tmp_path_factory.mktemp("plans1"))
    return {case: ranks.serve(cfg, params, case, store_dir=store) for case in ranks.CASES}


def _spawn(body, size, weights, tmp_path_factory):
    plans = str(tmp_path_factory.mktemp(f"plans{size}"))
    return spawn_ranks(body, size, device="cpu", args=(weights[2], plans),
                    store_dir=str(tmp_path_factory.mktemp(f"tp{size}")))


@pytest.fixture(scope="module")
def p2(weights, tmp_path_factory):
    """Every rank's results at P=2 (one spawn)."""
    return _spawn(ranks.rank_p2, 2, weights, tmp_path_factory)


@pytest.fixture(scope="module")
def p4(weights, tmp_path_factory):
    """Every rank's results at P=4 (one spawn)."""
    return _spawn(ranks.rank_p4, 4, weights, tmp_path_factory)


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


def _jax_tokens(weights, case="dense", store_dir=None) -> dict:
    """The JAX engine's tokens in engine case ``case``, its weights
    quantized by the port (held equal to its own quantization by
    test_torch_serving.py)."""
    from repro.runtime.autopilot import AutopilotPolicy as JAutopilotPolicy

    jcfg, jp, _, tparams = weights
    cfg = ranks.config()
    pol_kw, eng_kw = ranks.CASES[case]
    eng_kw = {k: (JAutopilotPolicy(**dataclasses.asdict(v)) if k == "autopilot" else v)
              for k, v in eng_kw.items()}
    if case == "autotune":
        eng_kw["plan_store_path"] = os.path.join(store_dir, "plans.json")
    whole = tquantize_params(tparams, ranks.policy(**pol_kw), cfg=cfg, plane_cache=True)
    with reference_quantizes_to(lambda: reference_layout(cfg, whole)):
        engine = JEngine(jcfg, jp, JPolicy.uniform(8, 8, level="bitplane", variant="booth",
                                                   **pol_kw),
                         n_slots=ranks.N_SLOTS, max_len=ranks.MAX_LEN, **eng_kw)
    results, _ = engine.run(ranks.requests(jcfg, JRequest, burst=case == "autopilot"))
    return {rid: np.asarray(t).tolist() for rid, t in results.items()}


def test_engine_tokens_equal_single_device_and_reference(weights, single, p2, p4):
    base = single["dense"]
    assert not base["failed"] and sorted(base["tokens"]) == list(range(len(ranks.LENS)))
    assert base["tokens"] == _jax_tokens(weights)
    for every in (p2, p4):
        for rank in every:
            res = rank["cases"]["dense"]
            assert res["tokens"] == base["tokens"]
            # each rank holds ~1/P of the plane bytes
            assert res["plane_bytes"] <= 0.6 * base["plane_bytes"] * 2 / len(every)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("case", ["scrub", "autopilot", "autotune", "head"])
def test_later_engine_cases_equal_single_device_and_reference(weights, single, p2, p4, case,
                                                              size, tmp_path):
    """Scrub, the autopilot, the tile autotuner and a dense vocab head at
    P=2 and 4: every rank's tokens are the port's single-device engine's
    and the JAX engine's, and each case's own record holds on every rank."""
    one = single[case]
    assert not one["failed"] and sorted(one["tokens"]) == list(range(len(ranks.LENS)))
    assert one["tokens"] == _jax_tokens(weights, case, str(tmp_path))
    every = p2 if size == 2 else p4
    for rank in every:
        got, tag = rank["cases"][case], f"rank {rank['rank']}"
        assert got["tokens"] == one["tokens"] and not got["failed"], tag
        if case == "scrub":
            # rank 1's flip is found on every rank before the first step
            # it would touch; each rank scrubs once and serves its intact
            # shard again
            ig = got["integrity"]
            assert ig["audit_alarms"] >= 1 and ig["scrubs"] == 1, (tag, ig)
            assert one["integrity"]["audit_alarms"] == one["integrity"]["scrubs"] == 0
            assert got["fingerprint_restored"], tag
            assert got["source_bytes"] == rank["source_bytes_wanted"], tag
        if case == "autopilot":
            assert got["autopilot"] == one["autopilot"], tag
            assert one["autopilot"]["mixed_steps"] > 0 and one["autopilot"]["shadow_probes"] > 0
            assert len(set(one["autopilot"]["request_tiers"].values())) == 2
        if case == "autotune":
            cold, warm = got["plans"], got["warm"]["plans"]
            assert cold["tunes"] > 0 and cold["store_hits"] == 0, (tag, cold)
            assert warm["tunes"] == 0 and warm["store_hits"] == cold["tunes"], (tag, warm)
            assert got["warm"]["tokens"] == one["tokens"], tag
            assert got["tiles"] == every[0]["cases"][case]["tiles"] and got["tiles"], tag
            assert got["warm_tiles"] == got["tiles"], tag
            assert got["keeps_store"] == (rank["rank"] == 0), tag
            assert got["store_files"] == ["plans.json"], tag


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("arch", ranks.LOADER_ARCHS)
@pytest.mark.parametrize("compact", [False, True])
def test_layer_by_layer_load_equals_sharding_the_whole_tree(p2, p4, size, arch, compact):
    for rank in p2 if size == 2 else p4:
        assert rank["loader"][f"{arch} compact={compact}"] == {"loaded": True, "rebuilt": True}


#: the reference's tensor-parallel engine with one projection kept dense,
#: on 2 XLA host devices (a process of its own: a test worker's JAX has
#: made its devices before this module can ask for more): for each
#: projection named on the command line, the exception its run raises
_DEFECT_I_PROG = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses, json, sys
    import jax
    import repro.models  # noqa: F401
    from repro.configs import get_reduced
    from repro.core.precision import PrecisionPolicy
    from repro.launch.serve import ContinuousBatchingEngine
    from repro.models import quant
    from repro.models.transformer import init_params
    from repro.runtime.scheduler import Request
    from repro_torch.core.precision import PrecisionPolicy as TPolicy
    from repro_torch.models.quant import quantize_params
    from repro_torch.models.transformer import params_from_numpy
    import _torch_tp_ranks as ranks
    from _torch_parity import reference_layout, to_numpy_tree

    jcfg = dataclasses.replace(get_reduced(ranks.ARCH), n_kv_heads=4)
    jp = jax.jit(lambda k: init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = params_from_numpy(ranks.config(), to_numpy_tree(jp), device="cpu")
    out = {}
    for name in sys.argv[1:]:
        kw = dict(level="bitplane", variant="booth", keep_dense=(name,))
        # the port's quantization in the reference's layout, in place of
        # the reference's eager one (held equal by test_torch_serving.py)
        whole = quantize_params(tparams, TPolicy.uniform(8, 8, **kw), cfg=ranks.config(),
                                plane_cache=True)
        quant.quantize_params = lambda *a, **k: reference_layout(ranks.config(), whole)
        engine = ContinuousBatchingEngine(jcfg, jp, PrecisionPolicy.uniform(8, 8, **kw),
                                          n_slots=ranks.N_SLOTS, max_len=ranks.MAX_LEN,
                                          model_parallel=2)
        try:
            engine.run(ranks.requests(jcfg, Request))
            out[name] = None
        except (TypeError, ValueError) as err:
            out[name] = [type(err).__name__, str(err)]
    print("RESULT" + json.dumps(out))
    """
)
DEFECT_I = {"q_proj": "cannot reshape", "gate_proj": "broadcast", "o_proj": "dot_general"}


@pytest.fixture(scope="module")
def reference_defect_i():
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([src, here, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _DEFECT_I_PROG, *DEFECT_I], env=env,
                          capture_output=True, text=True, timeout=600)
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT")]
    assert proc.returncode == 0 and line, proc.stderr[-3000:]
    return json.loads(line[0][len("RESULT"):])


@pytest.mark.parametrize("name", list(DEFECT_I))
def test_dense_sharded_projection_defect_i(weights, p2, reference_defect_i, name):
    """Reference defect I: the reference's tensor-parallel engine with a
    dense (kept) column- or row-parallel projection replicates the weight
    whole while its local config halves the heads, and crashes on a shape;
    the port refuses it at load, on every rank, naming the defect."""
    crash = reference_defect_i[name]
    assert crash is not None and crash[0] == "TypeError" and DEFECT_I[name] in crash[1], crash
    for rank in p2:
        msg = rank["defect_i"][name]
        assert msg is not None and "reference defect I" in msg and name in msg
    kw = dict(level="bitplane", variant="booth", keep_dense=(name,))
    with pytest.raises(ValueError, match="reference defect I"):
        ttp.shard_quantized_all(weights[3], TPolicy.uniform(8, 8, **kw), 2, cfg=ranks.config())


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


@pytest.mark.parametrize("arch", ["hubert-xlarge", "recurrentgemma-2b"])
def test_refusals_are_the_references(arch):
    """The encoder (no decode path) and full-width recurrentgemma-2b (one
    KV head: the heads do not divide over 2 ranks) are refused at P=2 with
    the reference's messages."""
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config as tget_config

    pol = dict(level="bitplane", variant="booth")
    with pytest.raises(ValueError) as t_err:
        TEngine(tget_config(arch), None, TPolicy.uniform(8, 8, **pol), device="cpu",
                model_parallel=2)
    with pytest.raises(ValueError) as j_err:
        if arch == "hubert-xlarge":
            JEngine(jget_config(arch), None, JPolicy.uniform(8, 8, **pol), model_parallel=2)
        else:  # the engine's head check (it first makes a mesh of 2 devices)
            jtp.TPContext(mesh=None, size=2).local_config(jget_config(arch))
    assert str(t_err.value) == str(j_err.value)
    assert ("encoder-only" if arch == "hubert-xlarge" else "must divide") in str(t_err.value)


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
