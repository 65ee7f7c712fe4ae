"""Port parity of tensor-parallel serving of the families, on the CPU.

Reduced configs, the reference's weights carried through numpy, one
``spawn_ranks`` per world size over gloo (rank bodies in
``_torch_tp_ranks.py``), 2 slots, 6 new tokens:

* mamba2-1.3b (prompts 8/16/8/16/8: the SSD scan takes multiples of 8; it
  has no attention heads and a tied head, so every layer replicates),
  recurrentgemma-2b with 2 KV heads (its ring attention and MLP shard, the
  RG-LRU replicates), qwen3-moe-235b-a22b and llama4-scout-17b-a16e (the
  reference's serving policy, ``keep_dense=("frontend", "router")``: the
  attention shards, the router and the experts replicate) and internvl2-2b
  on text (prompts 5/9/13/7/11, arrivals two steps apart): the engine's
  greedy tokens at P=2 equal the port's single-device engine's and the JAX
  engine's, whose single-device tokens are the reference's at P=2; at P=4,
  where the heads divide (mamba2), too;
* internvl2-2b with its image prefix (the dense front end replicated): the
  tensor-parallel prefill's last logits equal the single-device prefill's
  and the reference's bit for bit, and 4 greedy decode steps give their
  tokens;
* ``TPContext.cache_specs`` shards the KV leaves of the hybrid's ring on
  their head axis and replicates the RG-LRU and SSD state and the conv
  tails, leaf for leaf as the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import steps as jsteps
from repro.launch.inputs import make_batch as jmake_batch
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.models.cache import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro.sharding import tp as jtp
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.cache import init_cache as tinit_cache
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import params_from_numpy
from repro_torch.sharding import tp as ttp

import _torch_tp_ranks as ranks
from _torch_parity import reference_layout, reference_quantizes_to, to_numpy_tree


def _jax_config(name: str):
    arch, changes, _, _ = ranks.FAMILIES[name]
    return dataclasses.replace(jget(arch), **changes)


def _jax_policy(name: str):
    return JPolicy.uniform(8, 8, level="bitplane", variant="booth", **ranks.FAMILIES[name][2])


@pytest.fixture(scope="module")
def trees():
    """Each family's reference weights as numpy, and as the port's tree."""
    out = {}
    for name in ranks.FAMILIES:
        jc = _jax_config(name)
        jp = jax.jit(lambda k, jc=jc: jinit(jc, k))(jax.random.PRNGKey(0))
        tree = to_numpy_tree(jp)
        out[name] = (jp, tree, params_from_numpy(ranks.family_config(name), tree, device="cpu"))
    return out


@pytest.fixture(scope="module")
def p2(trees, tmp_path_factory):
    return spawn_ranks(ranks.rank_families, 2, device="cpu",
                    args=({n: t[1] for n, t in trees.items()},),
                    store_dir=str(tmp_path_factory.mktemp("fam2")))


@pytest.fixture(scope="module")
def p4(trees, tmp_path_factory):
    return spawn_ranks(ranks.rank_families, 4, device="cpu",
                    args=({n: trees[n][1] for n in ranks.FAMILIES_P4},),
                    store_dir=str(tmp_path_factory.mktemp("fam4")))


def _jax_tokens(name, jp, tparams) -> dict:
    """The JAX engine's tokens, its weights quantized by the port (held
    equal to its own quantization by the family tests)."""
    jc, cfg = _jax_config(name), ranks.family_config(name)
    whole = tquantize_params(tparams, ranks.family_policy(name), cfg=cfg, plane_cache=True)
    with reference_quantizes_to(lambda: reference_layout(cfg, whole)):
        engine = JEngine(jc, jp, _jax_policy(name), n_slots=ranks.N_SLOTS,
                         max_len=max(ranks.FAMILIES[name][3]) + ranks.GEN)
    results, stats = engine.run(ranks.family_requests(name, jc.vocab_size, JRequest))
    assert not stats["failed"]
    return {rid: np.asarray(t).tolist() for rid, t in results.items()}


@pytest.mark.parametrize("name, size", [(n, 2) for n in ranks.FAMILIES]
                         + [(n, 4) for n in ranks.FAMILIES_P4])
def test_family_tokens_equal_single_device_and_reference(trees, p2, p4, name, size):
    jp, _, tparams = trees[name]
    single = ranks.serve_family(name, tparams)
    assert sorted(single) == list(range(len(ranks.FAMILIES[name][3])))
    assert single == _jax_tokens(name, jp, tparams)
    for rank in p2 if size == 2 else p4:
        assert rank["tokens"][name] == single, f"rank {rank['rank']}"


def test_vlm_image_prefix_equals_single_device_and_reference(trees, p2):
    jp, _, tparams = trees["internvl2"]
    jc, cfg = _jax_config("internvl2"), ranks.family_config("internvl2")
    single = ranks.vlm_prefix(tparams)
    # the reference's prefill and serve steps on the port's quantized tree
    jpol = _jax_policy("internvl2")
    jq = reference_layout(cfg, tquantize_params(tparams, ranks.family_policy("internvl2"),
                                                cfg=cfg, plane_cache=True))
    batch = jmake_batch(jc, ranks.VLM_BATCH, jc.num_patches + ranks.VLM_TEXT, "prefill",
                        np.random.default_rng(ranks.VLM_SEED))
    max_len = jc.num_patches + ranks.VLM_TEXT + ranks.VLM_STEPS + 1
    logits, cache = jax.jit(jsteps.make_prefill_step(jc, jpol, max_len=max_len,
                                                     kv_quant=True))(jq, batch)
    want_logits = np.asarray(logits).view(np.int16).tolist()
    tok = jnp.argmax(logits[:, :jc.vocab_size], -1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok[:, 0]).tolist()]
    step = jax.jit(jsteps.make_serve_step(jc, jpol))
    for _ in range(ranks.VLM_STEPS):
        tok, cache = step(jq, cache, tok)
        toks.append(np.asarray(tok[:, 0]).tolist())
    assert single == {"logits": want_logits, "tokens": toks}
    for rank in p2:
        assert rank["vlm"] == single, f"rank {rank['rank']}"


def _port_sharded(node, name=None, out=None) -> dict:
    """Leaf name -> whether ``TPContext.cache_specs`` shards it, over the
    port's spec tree (an axis or None per leaf)."""
    out = {} if out is None else out
    if isinstance(node, dict):
        for k, v in node.items():
            _port_sharded(v, k, out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _port_sharded(v, name, out)
    else:
        out.setdefault(name, set()).add(node is not None)
    return out


@pytest.mark.parametrize("name", ["rgemma", "mamba2"])
def test_cache_specs_of_the_families_equal_the_references(name):
    """Which cache leaves shard on a head axis (the hybrid ring's KV) and
    which replicate (lengths, the RG-LRU and SSD state, conv tails), leaf
    for leaf by name, as the reference's specs."""
    jc, cfg = _jax_config(name), ranks.family_config(name)
    jcache = jinit_cache(jc, 2, 32, kv_quant=True)
    jspecs = jtp.TPContext(mesh=None, size=2).cache_specs(jcache)
    want = {}
    for (path, _), spec in zip(jax.tree_util.tree_flatten_with_path(jcache)[0],
                               jax.tree_util.tree_leaves(
                                   jspecs, is_leaf=lambda s: isinstance(
                                       s, jax.sharding.PartitionSpec))):
        want.setdefault(path[-1].key, set()).add(len(spec) > 0)
    got = _port_sharded(ttp.TPContext(size=2).cache_specs(
        tinit_cache(cfg, 2, 32, kv_quant=True, device="cpu")))
    assert got == want
    assert ({True} in got.values()) == (name == "rgemma")
