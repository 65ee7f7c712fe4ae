"""Port parity of the execution plans: the same keys resolve to the same
routes (backend ``pallas`` <-> ``cuda``, ``jnp`` <-> ``torch``), and every
route the host can run gives the reference's int32 accumulators and
epilogue outputs bit for bit, including the runtime precision dial."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.core import plan as jplan
from repro.kernels import ops as jops
from repro_torch.core import bitplanes as tbp
from repro_torch.core import plan as tplan
from repro_torch.kernels import ops as tops

from _torch_parity import t2n

BACKENDS = (("pallas", "cuda"), ("jnp", "torch"))
CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def _caches(w):
    """(JAX, port) weight-plane caches for each cache layout a key can name."""
    out = {"none": (None, None)}
    for name, level, block in (("blocked", "bitplane", 512), ("planar", "bitplane", None),
                               ("digit", "digit", 512)):
        for variant in ("sbmwc", "booth"):
            if level == "digit" and variant == "sbmwc":
                continue
            out[f"{name}-{variant}"] = (
                jbp.make_weight_planes(jnp.asarray(w), w_bits=8, variant=variant,
                                       level=level, block=block, store="both"),
                tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant=variant,
                                       level=level, block=block),
            )
    return out


def _resolve(mod, registry, backend, device, cache, **kw):
    try:
        extra = {} if mod is jplan else {"device": device}
        p = mod.plan_for_operands((4, 64, 8), backend=backend, w_planes=cache,
                                  registry=registry, **kw, **extra)
    except ValueError:
        return "ValueError"
    return (p.kernel, p.requant_w, p.trunc_cache, p.gate, p.check, p.a_shift, p.w_shift,
            p.scale_mult)


def test_routes_equal_reference_for_the_same_keys(rng):
    w = rng.integers(-128, 128, (64, 8)).astype(np.int32)
    caches = _caches(w)
    jreg, treg = jplan.PlanRegistry(), tplan.PlanRegistry()
    seen = set()
    for (jb, tb), cname, level, variant, has_ep, fused, packed, (a_bits, w_bits), sparsity, integ in itertools.product(
        BACKENDS, caches, ("bitplane", "digit"), ("sbmwc", "booth"), (True, False),
        (None, False, True), (None, True), ((8, 8), (4, 4), (8, 4)), ("off", "gate"),
        ("off", "detect"),
    ):
        jc, tc = caches[cname]
        kw = dict(a_bits=a_bits, w_bits=w_bits, a_in_bits=8, w_in_bits=8, variant=variant,
                  level=level, has_epilogue=has_ep, fused=fused, packed=packed,
                  sparsity=sparsity, integrity=integ)
        got_j = _resolve(jplan, jreg, jb, None, jc, **kw)
        got_t = _resolve(tplan, treg, tb, CUDA if tb == "cuda" else CPU, tc, **kw)
        assert got_j == got_t, (jb, cname, kw)
        seen.add(got_t[0] if got_t != "ValueError" else got_t)
    assert {"fused_cached", "fused_repack", "cached_planes", "cached_packed", "cached_scan",
            "staged", "staged_packed", "oracle", "ValueError"} <= seen


def test_registry_interning_and_dial(rng):
    reg = tplan.PlanRegistry()
    kw = dict(a_bits=8, w_bits=8, level="bitplane", has_epilogue=True, registry=reg,
              device=CPU)
    p1 = tplan.plan_for_operands((4, 64, 8), **kw)
    assert tplan.plan_for_operands((4, 64, 8), **kw) is p1 and reg.hits == 1
    p4 = p1.with_precision(4, 4)
    assert p4 is p1.with_precision(4, 4) and p4.key.w_bits == 4 and p4.scale_mult == 256.0
    assert p1.with_precision() is p1
    with pytest.raises(ValueError):
        p1.with_precision(9, 8)


def _jax_call(plan, x, w, wp, ep):
    if ep is None:
        return jax.jit(lambda x, w, wp: plan(x, w, w_planes=wp))(x, w, wp)
    act, dt = ep.activation, ep.out_dtype
    return jax.jit(lambda x, w, wp, a, s: plan(
        x, w, w_planes=wp, epilogue=jops.Epilogue(a, s, None, act, dt)))(
        x, w, wp, ep.a_scale, ep.w_scale)


@pytest.mark.parametrize("level,variant,dial", [
    ("bitplane", "booth", None), ("bitplane", "booth", (4, 4)),
    ("bitplane", "sbmwc", None), ("bitplane", "sbmwc", (6, 4)), ("digit", "booth", None),
])
def test_route_outputs_equal_reference(level, variant, dial, rng):
    """Each route the port runs — the host routes (cached_scan, oracle) and
    the kernel routes' executors on their plain versions — gives the
    reference's outputs: int32 raw and bf16 with the epilogue."""
    m, k, n = 5, 96, 12
    x = rng.integers(-128, 128, (1, m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    a_scale = (rng.random((1, m, 1)) * 1e-2 + 1e-3).astype(np.float32)
    w_scale = (rng.random((1, n)) * 1e-3 + 1e-4).astype(np.float32)
    wj = jbp.make_weight_planes(jnp.asarray(w), w_bits=8, variant=variant, level=level,
                                store="both")
    wt = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant=variant, level=level)
    xa, wa = jnp.asarray(x), jnp.asarray(w)
    xt, wtq = torch.from_numpy(x), torch.from_numpy(w)
    for cached, has_ep in itertools.product((True, False), (True, False)):
        kw = dict(a_bits=8, w_bits=8, variant=variant, level=level, has_epilogue=has_ep)
        jp = jplan.plan_for_operands(((1, m, k), (k, n)), backend="jnp",
                                     w_planes=wj if cached else None,
                                     registry=jplan.PlanRegistry(), **kw)
        tp = tplan.plan_for_operands(((1, m, k), (k, n)), backend="torch", device=CPU,
                                     w_planes=wt if cached else None,
                                     registry=tplan.PlanRegistry(), **kw)
        if dial:
            jp, tp = jp.with_precision(*dial), tp.with_precision(*dial)
        assert jp.kernel == tp.kernel
        ep_j = jops.Epilogue(jnp.asarray(a_scale), jnp.asarray(w_scale)) if has_ep else None
        ep_t = tops.Epilogue(torch.from_numpy(a_scale), torch.from_numpy(w_scale)) if has_ep else None
        want = np.asarray(_jax_call(jp, xa, wa, wj if cached else None, ep_j))
        routes = [tp.kernel]
        if cached and has_ep and level == "bitplane":
            routes += ["fused_cached", "fused_repack", "cached_planes"]
        elif cached and level == "digit":
            routes += ["cached_planes"]
        elif not cached:
            routes += ["staged"] + (["fused_repack"] if has_ep and level == "bitplane" else [])
        for route in routes:
            # a kernel route's executor, run on the plain versions (backend torch)
            shifted = tp.w_shift > 0
            plan = dataclasses.replace(
                tp, kernel=route,
                requant_w=shifted and route in ("fused_repack", "staged", "oracle"),
                trunc_cache=shifted and route.startswith(("cached", "fused_cached")),
            )
            got = plan(xt, wtq, w_planes=wt if cached else None, epilogue=ep_t)
            np.testing.assert_array_equal(want.astype(np.float32), t2n(got).astype(np.float32),
                                          err_msg=f"route {route}")


def test_packed_host_refusal_checked_plan_and_sharded_key(rng):
    """A CUDA-backend packed plan given host tensors raises instead of
    falling back to the plain version; a checked host plan returns the
    exact product; a tensor-parallel plan runs on its local shapes under a
    key no unsharded plan shares."""
    w = rng.integers(-8, 8, (64, 8)).astype(np.int8)
    x = rng.integers(-8, 8, (4, 64)).astype(np.int8)
    wt = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant="booth",
                                level="bitplane", checksum=True)
    p = tplan.plan_for_operands((4, 64, 8), a_bits=8, w_bits=8, level="bitplane",
                                backend="cuda", device=CUDA, w_planes=wt, fused=False,
                                registry=tplan.PlanRegistry())
    assert p.kernel == "cached_packed"
    with pytest.raises(ValueError, match="CUDA tensors"):
        p(torch.from_numpy(x), w_planes=wt)
    chk = tplan.plan_for_operands((4, 64, 8), a_bits=8, w_bits=8, level="bitplane",
                                  backend="torch", device=CPU, integrity="detect",
                                  registry=tplan.PlanRegistry())
    got = chk(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(t2n(got), x.astype(np.int64) @ w)
    tp_plan = tplan.plan_for_operands((4, 64, 8), a_bits=8, w_bits=8, level="bitplane",
                                      backend="torch", device=CPU, shard=("model", 2, "col"),
                                      registry=tplan.PlanRegistry())
    np.testing.assert_array_equal(t2n(tp_plan(torch.from_numpy(x), torch.from_numpy(w))),
                                  x.astype(np.int64) @ w)
    assert tp_plan.key != dataclasses.replace(tp_plan.key, shard=None)
