"""The port's expert-parallel MoE dispatch (``layers/moe.moe_apply_gshard``
with a mesh) on gloo ranks, against the reference's.

* Dropless (``capacity_factor=0``) on meshes (2,2), (1,4) and (4,1), the
  sequence whole or sharded over the model row: the output and the
  gradients of ``mean(out^2) + 0.01 * aux`` with respect to x and every
  expert weight stay within the reference test's bounds of the
  ``global_sort`` oracle (``tests/test_moe_ep.py``: 0.05 on the output;
  atol 0.02 + rtol 0.1 on the gradients). The aux loss is the
  reference's on a mesh, within 1e-5: each data rank's own over its rows,
  averaged over the data axis (with several data ranks it is not the
  oracle's whole-batch value).
* At ``capacity_factor=2.0`` the dropped copies depend on the mesh (the
  capacity follows each data rank's rows): on (2,2) the port's kept
  copies equal those of the reference's dispatch on the same row blocks,
  and its output equals the reference's ``shard_map`` program on a (2,2)
  mesh of 4 forced host devices within ``OUT_ATOL``; at data 1 the kept
  copies equal one device's.

The one-rank mesh and the refusal of experts that do not divide the
model axis: ``tests/test_torch_moe.py``.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.layers import moe as jmoe
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.layers import moe as tmoe

import _torch_mesh_ranks as ranks
from _torch_parity import j2t, j2t_tree, to_numpy_tree

E, K, D, F = 8, 2, 32, 48
B, S = 4, 16
ORACLE_ATOL = 0.05
GRAD_ATOL, GRAD_RTOL = 0.02, 0.1
OUT_ATOL = 2e-3  # one bf16 step of the output's magnitude, a float32 sum reordered
SKEW = 1.5  # added to expert 0's router column so that cf 2.0 drops copies


def _layer(skew=0.0):
    p = jmoe.moe_init(jax.random.PRNGKey(0), D, F, E)
    if skew:
        p["router"]["w"] = p["router"]["w"].at[:, 0].add(skew)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, D), jnp.bfloat16)
    return p, x


def _oracle(p, x):
    """The reference's global-sort output and the gradients of the test's
    loss, on one device."""
    pol = JPolicy.off()

    def loss(pp, xx):
        o, a = jmoe.moe_apply(pp, xx, n_experts=E, top_k=K, policy=pol, impl="global_sort")
        return jnp.mean(o.astype(jnp.float32) ** 2) + 0.01 * a, (o, a)

    (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                       has_aux=True))(p, x)
    return o, a, gp, gx


def _aux_over_rows(p, x, data):
    """The reference's aux loss on a mesh: each data rank's own over its
    rows, averaged over the data axis (``pmean``)."""
    pol = JPolicy.off()
    f = jax.jit(lambda pp, xx: jmoe.moe_apply(pp, xx, n_experts=E, top_k=K, policy=pol,
                                               impl="global_sort")[1])
    return float(np.mean([float(f(p, xb)) for xb in jnp.split(x, data)]))


def _f32(a):
    a = np.asarray(a)
    return a.view(jnp.bfloat16).astype(np.float32) if a.dtype == np.uint16 else \
        a.astype(np.float32)


def _run(shape, p, x, cf, seq_sharded, w_bits=0):
    return spawn_ranks(ranks.rank_moe, shape[0] * shape[1], device="cpu",
                       args=(shape, to_numpy_tree(p), np.asarray(x).view(np.uint16), E, K,
                             cf, seq_sharded, w_bits))


@pytest.mark.parametrize("shape, seq_sharded", [((2, 2), False), ((1, 4), True),
                                                ((4, 1), False), ((2, 2), True)])
def test_ep_matches_oracle_across_meshes(shape, seq_sharded):
    p, x = _layer()
    o, a, gp, gx = _oracle(p, x)
    got = _run(shape, p, x, 0.0, seq_sharded)
    np.testing.assert_allclose(_f32(got["out"]), np.asarray(o, np.float32), atol=ORACLE_ATOL,
                               rtol=ORACLE_ATOL)
    assert got["aux"] == pytest.approx(_aux_over_rows(p, x, shape[0]), rel=1e-5)
    assert got["kept"] == B * S * K  # dropless
    np.testing.assert_allclose(_f32(got["g_x"]), np.asarray(gx, np.float32), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    for k in ("gate", "up", "down"):
        np.testing.assert_allclose(_f32(got["g_params"][k]), np.asarray(gp[k], np.float32),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
    np.testing.assert_allclose(_f32(got["g_params"]["router"]["w"]),
                               np.asarray(gp["router"]["w"], np.float32), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


def _reference_kept(p, x, cf, data):
    """The copies the reference's ``_ep_block`` keeps with ``data`` row
    blocks: each block routes its rows with the capacity of its rows (the
    reference's own functions, compiled)."""
    kept = 0
    for xb in np.split(np.asarray(x), data):
        xb = jnp.asarray(xb)
        t = xb.shape[0] * xb.shape[1]
        cap = jmoe._capacity_for(t, K, E, E, cf)
        _, _, ids = jax.jit(lambda xx, w: jmoe._route(xx, w, E, K))(
            xb.reshape(t, D), p["router"]["w"])
        flat = np.asarray(ids).reshape(-1)
        counts = np.zeros(E, np.int64)
        for e in flat:
            kept += counts[e] < cap
            counts[e] += 1
    return int(kept)


_REF_PROG = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.models  # noqa: F401
    from repro.layers.moe import moe_init, moe_apply
    from repro.core.precision import PrecisionPolicy
    from repro.launch.mesh import make_mesh
    from repro.sharding import rules as sh

    E, K, D, F, B, S, SKEW = %d, %d, %d, %d, %d, %d, %r
    p = moe_init(jax.random.PRNGKey(0), D, F, E)
    p["router"]["w"] = p["router"]["w"].at[:, 0].add(SKEW)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, D), jnp.bfloat16)
    mesh = make_mesh((2, 2), ("data", "model"))
    with sh.use_rules(sh.rules_for_mesh(mesh)):
        o, a = jax.jit(lambda pp, xx: moe_apply(pp, xx, n_experts=E, top_k=K,
            policy=PrecisionPolicy.off(), capacity_factor=2.0))(p, x)
    print("RESULT" + json.dumps({"out": np.asarray(o, np.float32).tolist(),
                                 "aux": float(a)}))
    """
)


def test_capacity_follows_the_mesh_as_the_reference():
    p, x = _layer(SKEW)
    res = subprocess.run(
        [sys.executable, "-c", _REF_PROG % (E, K, D, F, B, S, SKEW)], capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH="src"),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads([ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")][0][6:])
    got = _run((2, 2), p, x, 2.0, True)
    want_kept = _reference_kept(p, x, 2.0, 2)
    assert got["kept"] == want_kept < B * S * K  # copies were dropped
    np.testing.assert_allclose(_f32(got["out"]), np.asarray(ref["out"], np.float32),
                               atol=OUT_ATOL, rtol=0)
    assert got["aux"] == pytest.approx(ref["aux"], rel=1e-5)
    # at data 1 the capacity is one device's: the same copies kept
    one = _reference_kept(p, x, 2.0, 1)
    assert one != want_kept
    assert _run((1, 2), p, x, 2.0, False)["kept"] == one
    with tmoe.record_drops() as log:
        tmoe.moe_apply_gshard(j2t_tree(p), j2t(x), n_experts=E, top_k=K,
                              policy=TPolicy.off(), capacity_factor=2.0)
    assert B * S * K - int(log[0][2]) == one
