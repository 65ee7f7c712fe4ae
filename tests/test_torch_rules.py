"""The port's sharding rules (``sharding/rules.py``), optimizer-state
specs and rank meshes (``launch/mesh.py``) against the reference's.

* ``tree_param_specs`` equals the reference's, leaf for leaf, for every
  architecture's reduced tree on meshes (1,1), (2,2), (4,2) and (1,8),
  and for granite-3-8b's full-width shapes (its 49155-token vocab padded
  to 49408, which the model axis divides); ``state_specs`` (AdamW and
  Adafactor), ``batch_specs`` and the decode cache's specs likewise. The
  reference runs in a subprocess on 8 forced host devices (as
  ``tests/test_distribution.py`` does); exact equality.
* A mesh of gloo ranks lays rank ``r`` at ``(r // model, r % model)``,
  with one group per row, per column and for the whole; a mesh larger
  than the world raises the reference's error.
* ``shard_leaf`` / ``gather_leaf`` / ``ElasticMesh.reshard`` put a tree
  back together bit for bit.
"""

import itertools
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.core import tree as tr
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh, spawn_ranks
from repro_torch.models.transformer import init_params, stack_layers
from repro_torch.optim import state_specs
from repro_torch.runtime import ElasticMesh
from repro_torch.sharding import rules as sh

import _torch_mesh_ranks as ranks

MESHES = ((1, 1), (2, 2), (4, 2), (1, 8))

_REF_PROG = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.models  # noqa: F401
    from repro.configs import ARCH_NAMES, get_config, get_reduced
    from repro.launch.mesh import make_mesh
    from repro.models.cache import init_cache
    from repro.models.transformer import init_params
    from repro.optim.adamw import OptimConfig, state_specs
    from repro.sharding import rules as sh
    from jax.sharding import PartitionSpec as P

    def path_str(path):
        return sh._path_str(path)

    def flat(tree, is_leaf=None):
        return {path_str(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}

    def spec_list(s):
        return [list(e) if isinstance(e, tuple) else e for e in s]

    out = {"specs": {}, "shapes": {}, "state": {}, "batch": {}, "cache": {}}
    trees = {a: jax.eval_shape(lambda k, a=a: init_params(get_reduced(a), k),
                               jax.random.PRNGKey(0)) for a in ARCH_NAMES}
    trees["granite-3-8b/full"] = jax.eval_shape(
        lambda k: init_params(get_config("granite-3-8b"), k), jax.random.PRNGKey(0))
    for name, tree in trees.items():
        out["shapes"][name] = {k: list(v.shape) for k, v in flat(tree).items()}
    isp = lambda x: isinstance(x, P)
    for shape in %r:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        m = str(tuple(shape))
        with sh.use_rules(sh.rules_for_mesh(mesh)):
            for name, tree in trees.items():
                specs = sh.tree_param_specs(tree)
                out["specs"].setdefault(name, {})[m] = {
                    k: spec_list(v) for k, v in flat(specs, isp).items()}
            tree = trees["granite-3-8b"]
            specs = sh.tree_param_specs(tree)
            for kind in ("adamw", "adafactor"):
                st = state_specs(kind, tree, specs)
                out["state"].setdefault(kind, {})[m] = {
                    k: spec_list(v) for k, v in flat(st, isp).items()}
            batch = {"tokens": jnp.zeros((8, 16), jnp.int32),
                     "targets": jnp.zeros((8, 16), jnp.int32),
                     "patches": jnp.zeros((4, 3, 5)), "other": jnp.zeros((6, 2))}
            out["batch"][m] = {k: spec_list(v) for k, v in
                               flat(sh.batch_specs(batch), isp).items()}
            for a in ("granite-3-8b", "mamba2-1.3b", "recurrentgemma-2b"):
                cache = jax.eval_shape(lambda a=a: init_cache(get_reduced(a), 8, 32,
                                                              kv_quant=True))
                out["cache"].setdefault(a, {})[m] = {
                    k: [list(v.shape), spec_list(sh.cache_spec(k, v))]
                    for k, v in flat(cache).items()}
    print("RESULT" + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def ref():
    res = subprocess.run(
        [sys.executable, "-c", _REF_PROG % ([list(m) for m in MESHES],)],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH="src"),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads([ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")][0][6:])


def _described(shape) -> Mesh:
    """A mesh of ``shape`` as a layout alone (no process group): what the
    rules read."""
    return Mesh(devices=np.arange(int(np.prod(shape))).reshape(shape),
                axis_names=("data", "model"))


def _as_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _shapes(named):
    """A tree of shape-only leaves."""
    tree = {}
    for key, shape in named.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = types.SimpleNamespace(shape=tuple(shape), ndim=len(shape))
    return tree


def _flat_specs(tree):
    return {tr.path_key(p): _as_list(s) for p, s in tr.flatten_with_path(tree)}


def _port_tree(arch):
    cfg = get_reduced(arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    return stack_layers(cfg, init_params(cfg, gen))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(ref, arch):
    tree = _port_tree(arch)
    shapes = {tr.path_key(p): list(t.shape) for p, t in tr.flatten_with_path(tree)}
    # the tree the reference trains, leaf for leaf (list indices as keys)
    assert shapes == {k: v for k, v in ref["shapes"][arch].items()}
    for m in MESHES:
        with sh.use_rules(sh.rules_for_mesh(_described(m))):
            got = _flat_specs(sh.tree_param_specs(tree))
        assert got == ref["specs"][arch][str(m)], (arch, m)


def test_full_width_granite_specs_equal_the_reference(ref):
    """granite-3-8b at full width (shapes only): the 49155-token vocab is
    padded to 49408, which every model axis here divides, so ``embed`` and
    ``lm_head`` shard the vocab over model and d_model over data."""
    shapes = ref["shapes"]["granite-3-8b/full"]
    assert shapes["embed/embedding"] == [get_config("granite-3-8b").vocab_padded, 4096]
    tree = _shapes(shapes)
    for m in MESHES:
        with sh.use_rules(sh.rules_for_mesh(_described(m))):
            got = _flat_specs(sh.tree_param_specs(tree))
        assert got == ref["specs"]["granite-3-8b/full"][str(m)], m
    assert ref["specs"]["granite-3-8b/full"]["(2, 2)"]["embed/embedding"] == ["model", "data"]


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_state_specs_equal_the_reference(ref, kind):
    tree = _port_tree("granite-3-8b")
    for m in MESHES:
        with sh.use_rules(sh.rules_for_mesh(_described(m))):
            specs = sh.tree_param_specs(tree)
        assert _flat_specs(state_specs(kind, tree, specs)) == ref["state"][kind][str(m)], m


def test_batch_and_cache_specs_equal_the_reference(ref):
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "targets": torch.zeros((8, 16), dtype=torch.int32),
             "patches": torch.zeros((4, 3, 5)), "other": torch.zeros((6, 2))}
    for m in MESHES:
        with sh.use_rules(sh.rules_for_mesh(_described(m))):
            assert _flat_specs(sh.batch_specs(batch)) == ref["batch"][str(m)], m
            for arch, leaves in ref["cache"].items():
                for key, (shape, want) in leaves[str(m)].items():
                    leaf = types.SimpleNamespace(shape=tuple(shape), ndim=len(shape))
                    assert _as_list(sh.cache_spec(key, leaf)) == want, (arch, key, m)
    with sh.use_rules(None):
        assert sh.param_spec("attn/q_proj/w", torch.zeros(4, 4)) == sh.P()


def test_rank_layout_and_groups():
    """Rank r at (r // model, r % model); each rank's data group spans
    its column, its model group its row, the pair the world; its index
    in each is its coordinate. A mesh larger than the world raises."""
    got = spawn_ranks(ranks.rank_world, 4, device="cpu", args=((2, 2),))
    for r, row in enumerate(got["rows"]):
        rank, d, m, dn, di, mn, mi, wn, wi = row
        assert (rank, d, m) == (r, r // 2, r % 2)
        assert (dn, di, mn, mi, wn, wi) == (2, d, 2, m, 4, r)
    assert "mesh (4, 2) needs 8 devices, found 4" in got["too_big"]
    with pytest.raises(RuntimeError, match=r"mesh \(2, 1\) needs 2 devices, found 1"):
        make_mesh((2, 1), ("data", "model"))
    one = make_host_mesh(model=1)
    assert one.shape == {"data": 1, "model": 1} and one.group("data") is None


def test_shards_gather_back_and_reshard():
    """Every rank's block of every leaf, put back together, is the whole
    tree bit for bit, on each mesh; ``ElasticMesh.reshard`` cuts a whole
    tree for a rank of the new mesh."""
    tree = _port_tree("qwen3-moe-235b-a22b")
    for m in MESHES[1:]:
        mesh = _described(m)
        with sh.use_rules(sh.rules_for_mesh(mesh)):
            specs = sh.tree_param_specs(tree)
        for path, leaf, spec in zip([p for p, _ in tr.flatten_with_path(tree)],
                                    tr.leaves(tree), tr.leaves(specs)):
            blocks = {}
            for r in range(mesh.size):
                view = Mesh(devices=mesh.devices, axis_names=mesh.axis_names, rank=r)
                blocks[r] = sh.shard_leaf(leaf, spec, view)
            # reassemble along each sharded dim in coordinate order
            grid = np.empty(mesh.devices.shape, dtype=object)
            for r, b in blocks.items():
                grid[np.unravel_index(r, mesh.devices.shape)] = b
            whole = _assemble(grid, spec, mesh)
            assert torch.equal(whole, leaf), tr.path_key(path)
        elastic = ElasticMesh(model_axis=m[1])
        view = Mesh(devices=mesh.devices, axis_names=mesh.axis_names, rank=mesh.size - 1)
        placed = elastic.reshard(tree, specs, view)
        for a, b, s in zip(tr.leaves(placed), tr.leaves(tree), tr.leaves(specs)):
            assert torch.equal(a, sh.shard_leaf(b, s, view))


def _assemble(grid, spec, mesh):
    """The whole leaf from the grid of every rank's block: concatenated
    over each axis that shards a dim, innermost axis first (every other
    coordinate holds a copy)."""
    axes = mesh.axis_names
    dims = {a: i for i, e in enumerate(spec) for a in ((e,) if isinstance(e, str) else
                                                      (e or ()))}
    idx = [range(mesh.shape[a]) if a in dims else [0] for a in axes]
    rows = {coords: grid[coords] for coords in itertools.product(*idx)}
    for ai in reversed(range(len(axes))):
        a = axes[ai]
        if a not in dims:
            continue
        merged = {}
        for coords, t in rows.items():
            key = coords[:ai] + (0,) + coords[ai + 1:]
            merged.setdefault(key, []).append((coords[ai], t))
        rows = {k: torch.cat([t for _, t in sorted(v, key=lambda x: x[0])], dim=dims[a])
                for k, v in merged.items()}
    (out,) = rows.values()
    return out
