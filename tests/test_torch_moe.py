"""The port's mixture-of-experts layer against the reference's, on the CPU.

Every reference call is compiled (``jax.jit``), as the reference's serving
and training steps run it. Tolerances, measured on these seeds and stated
here once:

* routing and dispatch (``top_ids``, ``keep``, ``dst``, the capacity):
  bit-equal, drops included;
* the layer's output (``gshard_ep`` at cf 0, 2.0 and 0.5, the
  ``global_sort`` oracle), off and at w8a8 with the router dense: within
  ``OUT_ATOL`` (measured 0 on most seeds; one bf16 step of a float32
  product summed in another order elsewhere);
* ``probs``, ``top_p`` and the load-balancing loss: within 1e-6 relative
  (the softmax's exp and the means' summation order);
* the port's ``gshard_ep`` at cf 0 against its own ``global_sort``: within
  the reference test's 0.05 (the oracle rounds its products to bf16);
* QAT gradients (``training=True``) with respect to x, the router and the
  experts: within ``GRAD_RTOL`` relative L2 of ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.layers import moe as jmoe
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.layers import moe as tmoe
from repro_torch.models.quant import quantize_params

from _torch_parity import j2t, j2t_tree, t2n

OUT_ATOL = 2e-3
GRAD_RTOL = 0.02
E, K, D, F = 8, 2, 64, 32


def _layer(seed=0, e=E, d=D, f=F):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), d, f, e)
    return p, j2t_tree(p)


def _x(shape, seed=0):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.bfloat16)
    return x, j2t(x)


def _policies(kind):
    if kind == "off":
        return JPolicy.off(), TPolicy.off()
    return (JPolicy.uniform(8, 8, keep_dense=("router",)),
            TPolicy.uniform(8, 8, keep_dense=("router",)))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a).astype(np.float32), t2n(b), atol=atol, rtol=0)


def test_route_aux_and_capacity_match_reference():
    p, tp = _layer()
    x, xt = _x((12, D))
    jp_, jtp, jids = jax.jit(lambda xx, w: jmoe._route(xx, w, E, K))(x, p["router"]["w"])
    tp_, ttp, tids = tmoe._route(xt, tp["router"]["w"], E, K)
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    np.testing.assert_allclose(np.asarray(jp_), t2n(tp_), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jtp), t2n(ttp), rtol=1e-6)
    ja = jax.jit(lambda pr, ids: jmoe._aux_loss(pr, ids, E))(jp_, jids)
    np.testing.assert_allclose(float(tmoe._aux_loss(tp_, tids, E)), float(ja), rtol=1e-6)
    for t_row, k, e, cf in ((4, 8, 128, 2.0), (4, 1, 16, 2.0), (256, 8, 128, 2.0),
                            (7, 2, 8, 0.0), (3, 2, 4, 0.5), (1, 1, 2, 1e-3)):
        assert tmoe._capacity_for(t_row, k, e, e, cf) == jmoe._capacity_for(t_row, k, e, e, cf)


def _reference_dispatch(top_ids, capacity):
    """``keep`` and ``dst`` of the reference's ``_ep_block`` (no mesh: the
    local expert range is all of them), compiled."""
    def f(ids):
        flat = ids.reshape(-1)
        onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1)
        keep = pos < capacity
        return keep, jnp.where(keep, flat * capacity + pos, E * capacity)
    return jax.jit(f)(top_ids)


@pytest.mark.parametrize("cf", [0.0, 2.0, 0.5])
@pytest.mark.parametrize("pol", ["off", "w8"])
def test_gshard_matches_reference(cf, pol):
    """The single-device capacity dispatch: routing and dispatch bit-equal,
    the output within ``OUT_ATOL``; at cf 0.5 copies are dropped."""
    p, tp = _layer(seed=1)
    x, xt = _x((2, 9, D), seed=1)
    jpol, tpol = _policies(pol)
    jo, ja = jax.jit(lambda pp, xx: jmoe.moe_apply(
        pp, xx, n_experts=E, top_k=K, policy=jpol, capacity_factor=cf))(p, x)
    with tmoe.record_drops() as log:
        to, ta = tmoe.moe_apply(tp, xt, n_experts=E, top_k=K, policy=tpol, capacity_factor=cf)
    assert to.dtype == torch.bfloat16 and to.shape == (2, 9, D)
    _close(jo, to, OUT_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # the dispatch itself
    cap = tmoe._capacity_for(18, K, E, E, cf)
    _, _, ids = tmoe._route(xt.reshape(18, D), tp["router"]["w"], E, K)
    keep, dst = tmoe._dispatch(ids, E, cap)
    jkeep, jdst = _reference_dispatch(jnp.asarray(ids.numpy()), cap)
    np.testing.assert_array_equal(np.asarray(jkeep), keep.numpy())
    np.testing.assert_array_equal(np.asarray(jdst), dst.numpy())
    [(s, n, dropped)] = log
    assert (s, n, int(dropped)) == (9, 18 * K, int((~keep).sum()))
    assert (int(dropped) > 0) == (cf == 0.5)


@pytest.mark.parametrize("pol", ["off", "w8"])
def test_global_sort_matches_reference_and_gshard(pol):
    p, tp = _layer(seed=2)
    x, xt = _x((3, 5, D), seed=2)
    jpol, tpol = _policies(pol)
    jo, _ = jax.jit(lambda pp, xx: jmoe.moe_apply(
        pp, xx, n_experts=E, top_k=K, policy=jpol, impl="global_sort"))(p, x)
    to, _ = tmoe.moe_apply(tp, xt, n_experts=E, top_k=K, policy=tpol, impl="global_sort")
    _close(jo, to, OUT_ATOL)
    go, _ = tmoe.moe_apply(tp, xt, n_experts=E, top_k=K, policy=tpol, capacity_factor=0.0)
    np.testing.assert_allclose(t2n(go), t2n(to), atol=0.05, rtol=0.05)


def test_qat_gradients_match_reference():
    """``training=True`` at w8a8 (router dense): the gradients of a scalar
    of the output with respect to x, the router and the three expert
    stacks, through the fake quantizers' straight-through estimator."""
    p, tp = _layer(seed=3)
    x, xt = _x((2, 6, D), seed=3)
    jpol, tpol = _policies("w8")
    ct = np.random.default_rng(4).standard_normal((2, 6, D)).astype(np.float32)

    def jloss(pp, xx):
        out, aux = jmoe.moe_apply(pp, xx, n_experts=E, top_k=K, policy=jpol, training=True,
                                  capacity_factor=2.0)
        return jnp.sum(out.astype(jnp.float32) * ct) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    leaves = {"router": tp["router"]["w"], "gate": tp["gate"], "up": tp["up"],
              "down": tp["down"], "x": xt}
    leaves = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    tparams = {"router": {"w": leaves["router"]}, "gate": leaves["gate"], "up": leaves["up"],
               "down": leaves["down"]}
    out, aux = tmoe.moe_apply(tparams, leaves["x"], n_experts=E, top_k=K, policy=tpol,
                              training=True, capacity_factor=2.0)
    (torch.sum(out.float() * torch.from_numpy(ct)) + aux).backward()
    ref = {"router": jgp["router"]["w"], "gate": jgp["gate"], "up": jgp["up"],
           "down": jgp["down"], "x": jgx}
    for k, g in ref.items():
        a, b = np.asarray(g).astype(np.float32), t2n(leaves[k].grad)
        assert np.linalg.norm(a - b) <= GRAD_RTOL * np.linalg.norm(a), k


def test_router_tie_goes_to_the_lower_expert():
    """Two experts with identical router columns tie on every token:
    ``lax.top_k`` puts the lower id first, and so does the port."""
    p, tp = _layer(seed=5, e=4)
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 1] = w[:, 3] = 3.0 * np.abs(w).max(axis=1)
    x = jnp.abs(_x((6, D), seed=5)[0])  # positive: experts 1 and 3 lead every token
    xt = j2t(x)
    for k in (1, 2):
        _, _, jids = jax.jit(lambda xx, ww: jmoe._route(xx, ww, 4, k))(x, jnp.asarray(w))
        _, _, tids = tmoe._route(xt, torch.from_numpy(w), 4, k)
        np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
        assert (tids[:, 0] == 1).all() and (k == 1 or (tids[:, 1] == 3).all())


def test_router_quantizing_policy_is_refused_naming_defect_g():
    """The uniform policy quantizes the router: the reference's layer then
    fails on ``router['w']`` (``KeyError``); the port refuses the policy at
    load, naming the defect, and serves it with the router kept dense."""
    p, tp = _layer()
    qrouter = {"w_q": jnp.zeros((D, E), jnp.int8), "w_scale": jnp.ones((1, E), jnp.float32)}
    with pytest.raises(KeyError):
        jmoe.moe_apply(dict(p, router=qrouter), _x((1, 2, D))[0], n_experts=E, top_k=K,
                       policy=JPolicy.uniform(8, 8))
    tree = {"layers": [{"moe": tp}]}

    class Cfg:
        @staticmethod
        def param_path(i):
            return f"/layers/{i}"

    with pytest.raises(ValueError, match="defect G"):
        quantize_params(tree, TPolicy.uniform(8, 8), cfg=Cfg)
    kept = quantize_params(tree, TPolicy.uniform(8, 8, keep_dense=("router",)), cfg=Cfg)
    assert kept["layers"][0]["moe"]["router"] is tp["router"]
    assert kept["layers"][0]["moe"]["gate"] is tp["gate"]  # (E, d, f): fake-quantized per call
    with pytest.raises(ValueError, match="defect G"):
        tmoe.moe_apply({**tp, "router": {"w_q": None}}, _x((1, 2, D))[1], n_experts=E,
                       top_k=K, policy=TPolicy.off())


def test_mesh_branch_raises_naming_item_11():
    """The mesh branch runs. On a one-rank mesh (no process group: its
    collectives are the identity) it gives the
    single-device dispatch's output and aux bit for bit, at cf 0 and 2.0,
    and its gradients; experts that do not divide the model axis raise the
    reference's message. (The branch on gloo ranks:
    tests/test_torch_moe_ep.py.)"""
    from repro_torch.launch.mesh import Mesh, make_mesh

    _, tp = _layer()
    x = _x((2, 6, D))[1]
    mesh = make_mesh((1, 1), ("data", "model"))
    for cf in (0.0, 2.0):
        ref = tmoe.moe_apply_gshard(tp, x, n_experts=E, top_k=K, policy=TPolicy.off(),
                                    capacity_factor=cf)
        got = tmoe.moe_apply_gshard(tp, x, n_experts=E, top_k=K, policy=TPolicy.off(),
                                    capacity_factor=cf, mesh=mesh)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    xs = [x.clone().requires_grad_() for _ in range(2)]
    outs = [tmoe.moe_apply_gshard(tp, xi, n_experts=E, top_k=K, policy=TPolicy.off(),
                                  mesh=m)[0] for xi, m in zip(xs, (None, mesh))]
    for o in outs:
        o.float().square().sum().backward()
    assert torch.equal(xs[0].grad, xs[1].grad)
    three = Mesh(devices=np.arange(3).reshape(1, 3), axis_names=("data", "model"))
    with pytest.raises(ValueError, match=r"n_experts=8 must divide over model axis \(3\)"):
        tmoe.moe_apply_gshard(tp, x, n_experts=E, top_k=K, policy=TPolicy.off(), mesh=three)


def test_decode_step_reads_nothing_back():
    """The capacity path a captured decode step runs: no host read-back
    (``_local_scalar_dense``) and no tensor built from host data
    (``lift_fresh``), at w8a8 (the per-call fake quantizers included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.__name__)
            return func(*args, **(kwargs or {}))

    _, tp = _layer()
    xt = _x((4, 1, D))[1]
    with torch.no_grad(), Ops() as ops:
        tmoe.moe_apply(tp, xt, n_experts=E, top_k=K, policy=_policies("w8")[1],
                       capacity_factor=2.0)
    assert not {n for n in ops.names if "local_scalar" in n or "lift_fresh" in n}, ops.names
