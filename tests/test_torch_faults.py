"""Port parity of the seeded SEU injector, the paged KV checksums and the
recovery helpers (``runtime/faults.py``, ``models/paging.paged_checksums``,
``kernels/fold.page_folds``' plain path, ``runtime/recovery.py``).

Tolerance: exact throughout. ``FaultSpec`` accepts and rejects the
reference's grammar cases with the same shots and seed. On the same
quantized tree (reduced granite-3-8b with unrolled layers, carried across
through numpy) and the same KV caches, the port's injector records the
reference's ``FaultEvent``s — the same leaf path, byte and bit — for every
site, and leaves the same bytes behind, flipped in place: the leaf keeps
its ``data_ptr``. ``paged_checksums`` and ``page_folds`` on the host equal
the reference's ``paged_checksums`` on carried pools, the null page
included.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.models import paging as jpaging
from repro.models.cache import init_cache as jinit_cache
from repro.models.quant import quantize_params as jquantize
from repro.models.transformer import init_params as jinit
from repro.runtime.faults import FaultInjector as JInjector
from repro.runtime.faults import FaultSpec as JSpec
from repro_torch.configs import get_reduced as tget
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels import fold
from repro_torch.models import paging as tpaging
from repro_torch.models.cache import init_cache as tinit_cache
from repro_torch.models.quant import quantize_params as tquantize
from repro_torch.models.transformer import init_params, params_from_numpy
from repro_torch.runtime import recovery
from repro_torch.runtime.faults import FAULT_SITES, FaultInjector, FaultSpec, flip_bit

from _torch_parity import j2t, t2n, to_numpy_tree

ARCH = "granite-3-8b"
PARAM_SITES = ("planes", "sign", "occupancy", "checksum", "scale")

_TREES: dict = {}


def _trees():
    """(JAX quantized tree, port quantized tree) of reduced granite with
    unrolled layers, scrub-mode policy (checksummed caches), built once."""
    if not _TREES:
        jc = dataclasses.replace(jget(ARCH), scan_layers=False)
        tc = dataclasses.replace(tget(ARCH), scan_layers=False)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        pol = dict(level="bitplane", integrity="scrub")
        _TREES["j"] = jquantize(jp, JPolicy.uniform(8, 8, **pol), plane_cache=True)
        tp = params_from_numpy(tc, to_numpy_tree(jp), device="cpu")
        _TREES["t"] = tquantize(tp, TPolicy.uniform(8, 8, **pol), cfg=tc, plane_cache=True)
    return _TREES["j"], _TREES["t"]


def _containers(tree):
    """A copy of the tree's dicts and lists (the arrays shared): the
    reference's injector swaps leaves in its containers."""
    if isinstance(tree, dict):
        return {k: _containers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_containers(v) for v in tree]
    return tree


def _leaf(tree, path: str):
    """The array at an event's path: ``/a/0/b``, then for a plane cache
    ``.planes`` (its raw planes) or ``.<field>`` (a packed-words field)."""
    path, _, field = path.partition(".")
    node = tree
    for part in path.strip("/").split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    if field:
        node = node.planes if field == "planes" else getattr(node.packed, field)
    return node


def _events(inj):
    return [(e.site, e.step, e.leaf, e.byte, e.bit, e.category) for e in inj.events]


# -- FaultSpec grammar (the reference's cases) --------------------------------


@pytest.mark.parametrize("spec,shots,seed", [
    ("planes@2,kv@5x3;seed=7", (("planes", 2, 1), ("kv", 5, 3)), 7),
    ("scale@0", (("scale", 0, 1),), 0),
    (" sign@1 , checksum@4x2 ; seed=3", (("sign", 1, 1), ("checksum", 4, 2)), 3),
])
def test_fault_spec_parses_like_the_reference(spec, shots, seed):
    got = FaultSpec.parse(spec)
    assert got.shots == shots == JSpec.parse(spec).shots
    assert got.seed == seed == JSpec.parse(spec).seed


@pytest.mark.parametrize("bad", [
    "", "planes", "warp@2", "planes@2x0", "planes@2;sd=1", "planes@2;seed=x",
])
def test_fault_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        JSpec.parse(bad)
    with pytest.raises(ValueError):
        FaultSpec.parse(bad)


def test_fault_sites_are_the_reference_sites():
    from repro.runtime.faults import FAULT_SITES as JSITES

    assert FAULT_SITES == JSITES


# -- the injector on the same trees --------------------------------------------


@pytest.mark.parametrize("site", PARAM_SITES)
def test_param_flips_equal_the_reference_in_place(site):
    """Three shots at one site on both trees: the same events, the same
    flipped bytes, and every port leaf keeps its address."""
    jq, tq = _trees()
    spec = f"{site}@1x3;seed=5"
    ji, ti = JInjector(spec), FaultInjector(spec)
    jq2, _ = ji.apply(1, _containers(jq))
    paths = [e.leaf for e in ji.events]
    before = {p: np.array(t2n(_leaf(tq, p))) for p in paths}
    ptrs = {p: _leaf(tq, p).data_ptr() for p in paths}
    tq2, cache = ti.apply(1, tq)
    assert tq2 is tq and cache is None
    assert _events(ti) == _events(ji)
    for e in ti.events:
        leaf = _leaf(tq, e.leaf)
        assert leaf.data_ptr() == ptrs[e.leaf]
        np.testing.assert_array_equal(t2n(leaf), np.asarray(_leaf(jq2, e.leaf)))
    # put the port tree back for the other cases (flips are involutions)
    for e in reversed(ti.events):
        flip_bit(_leaf(tq, e.leaf), e.byte, e.bit)
    for p in paths:
        np.testing.assert_array_equal(t2n(_leaf(tq, p)), before[p])


def test_kv_flips_equal_the_reference_in_place(rng):
    """kv and kv_scale shots on equal dense caches (random contents): the
    same events and bytes, in place."""
    jc = dataclasses.replace(jget(ARCH), scan_layers=False)
    tc = dataclasses.replace(tget(ARCH), scan_layers=False)
    jcache = jinit_cache(jc, 2, 8, kv_quant=True)
    tcache = tinit_cache(tc, 2, 8, kv_quant=True, device="cpu")
    for jb, tb in zip(jcache["layers"], tcache["layers"]):
        for key, leaf in tb.items():
            vals = (rng.standard_normal(leaf.shape).astype(np.float32)
                    if leaf.dtype == torch.float32
                    else rng.integers(-100, 100, leaf.shape).astype(t2n(leaf).dtype))
            jb[key] = jnp.asarray(vals)
            leaf.copy_(torch.from_numpy(vals))
    spec = "kv@4x3,kv_scale@4x2;seed=9"
    ji, ti = JInjector(spec), FaultInjector(spec)
    _, jcache = ji.apply(4, {}, jcache)
    ptrs = [leaf.data_ptr() for tb in tcache["layers"] for leaf in tb.values()]
    params, tcache2 = ti.apply(4, {}, tcache)
    assert params == {} and tcache2 is tcache
    assert _events(ti) == _events(ji)
    assert {e.category for e in ti.events} == {"kv"}
    assert ptrs == [leaf.data_ptr() for tb in tcache["layers"] for leaf in tb.values()]
    for jb, tb in zip(jcache["layers"], tcache["layers"]):
        for key in tb:
            np.testing.assert_array_equal(t2n(tb[key]), np.asarray(jb[key]), err_msg=key)


def test_injector_bookkeeping_and_refusals():
    """due / pending_after / mark_detected / undetected as the reference's;
    a KV site without a cache and a site with no candidate are loud."""
    _, tq = _trees()
    tc = tinit_cache(dataclasses.replace(tget(ARCH), scan_layers=False), 1, 8,
                     kv_quant=True, device="cpu")
    inj = FaultInjector("planes@0,kv@0,scale@5;seed=4")
    assert inj.due(0) == [("planes", 1), ("kv", 1)] and inj.due(1) == []
    assert inj.pending_after(5) and not inj.pending_after(6)
    inj.apply(0, tq, tc)
    assert [e.site for e in inj.undetected] == ["planes", "kv"]
    assert [e.site for e in inj.mark_detected("params", 0)] == ["planes"]
    assert [e.site for e in inj.undetected] == ["kv"]
    assert inj.mark_detected("kv", 0)[0].site == "kv" and not inj.undetected
    for e in reversed(inj.events):
        flip_bit(_leaf(tq if e.category == "params" else tc, e.leaf), e.byte, e.bit)
    with pytest.raises(ValueError, match="needs a KV cache"):
        FaultInjector("kv@0").apply(0, tq)
    gen = torch.Generator().manual_seed(0)
    sbmwc = tquantize(init_params(tget(ARCH), gen, device="cpu"),
                      TPolicy.uniform(8, 8, variant="sbmwc", level="bitplane",
                                      integrity="detect"), cfg=tget(ARCH), plane_cache=True)
    with pytest.raises(ValueError, match="no injection candidates"):
        FaultInjector("sign@0").apply(0, sbmwc)
    with pytest.raises(ValueError, match="contiguous"):
        flip_bit(torch.zeros(4, 4).t(), 0, 0)


# -- paged checksums ---------------------------------------------------------


def test_paged_checksums_equal_the_reference(rng):
    """Random pools (null page included), lengths and tables on both
    sides: page and slot sums equal the reference's; one flipped bit in a
    page moves that page's sum alone, one in a table that slot's alone."""
    jc = dataclasses.replace(jget(ARCH), scan_layers=False)
    tc = dataclasses.replace(tget(ARCH), scan_layers=False)
    jcache = jpaging.paged_init_cache(jc, 3, 16, 4, 9)
    tcache = tpaging.paged_init_cache(tc, 3, 16, 4, 9, device="cpu")

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return rng.standard_normal(a.shape).astype(np.float32)
        info = np.iinfo(a.dtype)
        return rng.integers(info.min, info.max, a.shape, endpoint=True).astype(a.dtype)

    jcache = jax.tree_util.tree_map(fill, jcache)
    tcache["step"].copy_(j2t(jcache["step"]))
    for jb, tb in zip(jcache["layers"], tcache["layers"]):
        for key, leaf in tb.items():
            leaf.copy_(j2t(jb[key]))
    jp, js = jpaging.paged_checksums(jax.tree_util.tree_map(jnp.asarray, jcache))
    for got_p, got_s in (tpaging.paged_checksums(tcache), fold.page_folds(tcache)):
        np.testing.assert_array_equal(t2n(got_p), np.asarray(jp).astype(np.int64))
        np.testing.assert_array_equal(t2n(got_s), np.asarray(js).astype(np.int64))
    base_p, base_s = tpaging.paged_checksums(tcache)
    flip_bit(tcache["layers"][1]["v_scale"][5], 3, 6)  # page 5's scales
    flip_bit(tcache["layers"][0]["block_table"][2], 1, 0)  # slot 2's table
    now_p, now_s = tpaging.paged_checksums(tcache)
    assert (now_p != base_p).nonzero().flatten().tolist() == [5]
    assert (now_s != base_s).nonzero().flatten().tolist() == [2]


# -- recovery helpers --------------------------------------------------------


def test_retry_step_retries_runtime_errors_then_escalates():
    calls, seen = [], []

    def flaky(n):
        calls.append(n)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return n * 2

    assert recovery.retry_step(flaky, 21, backoff_s=0.0,
                               on_retry=lambda a, e: seen.append(a)) == 42
    assert len(calls) == 3 and seen == [1, 2]

    def always():
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        recovery.retry_step(always, max_retries=2, backoff_s=0.0)
    with pytest.raises(ValueError):  # not retriable: raised at once
        recovery.retry_step(lambda: (_ for _ in ()).throw(ValueError("x")), backoff_s=0.0)


def test_straggler_detector_and_health_monitor():
    det = recovery.StragglerDetector(window=20, k=6.0, min_samples=10)
    for i in range(15):
        assert not det.record(1.0 + 0.01 * (i % 3))
    assert det.record(5.0) and det.flagged[-1] == (16, 5.0)
    assert abs(det.median - 1.01) < 0.02
    mon = recovery.HealthMonitor(timeout_s=10.0)
    mon.beat("a", t=0.0)
    mon.beat("b", t=8.0)
    assert mon.dead_workers(now=15.0) == ["a"]


def test_fault_shim_warns_and_forwards():
    import importlib
    import sys

    sys.modules.pop("repro_torch.runtime.fault", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shim = importlib.import_module("repro_torch.runtime.fault")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert shim.retry_step is recovery.retry_step
    from repro_torch import runtime

    assert runtime.StragglerDetector is recovery.StragglerDetector
    assert runtime.HealthMonitor is recovery.HealthMonitor
