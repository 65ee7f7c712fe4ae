"""Port parity of the paged KV cache (``models/paging.py``).

The host bookkeeping — :class:`PageAllocator`, :class:`SlotPager` and
:class:`PrefixRegistry` — is driven by the same seeded operation traces in
both packages and must end every step in the same state: free list,
refcounts, peak, quarantine, and a raise on exhaustion that leaves the
refcounts untouched. The device helpers, on seeded numpy inputs, must give
pools bit-equal to the reference's (the reference stacks scanned layers on
a leading axis; the port keeps a list of layers, compared layer by layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_reduced as jget
from repro.models import paging as jpg
from repro.models.cache import init_cache as jinit_cache
from repro_torch.configs import get_reduced as tget
from repro_torch.models import paging as tpg
from repro_torch.models.cache import init_cache as tinit_cache

from _torch_parity import t2n

ARCH = "granite-3-8b"


def _alloc_state(a):
    return (list(a._free), dict(a._ref), set(a._quarantined), a.peak_used, a.free_pages,
            a.used_pages, a.quarantined_pages)


def _apply(obj, op, *args):
    """Run one operation; returns ("ok", result) or ("raise", error type name)."""
    try:
        return "ok", getattr(obj, op)(*args)
    except (jpg.PagingError, tpg.PagingError) as e:
        return "raise", type(e).__name__


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_allocator_traces_end_in_equal_states(data):
    n_pages = data.draw(st.integers(2, 10), label="n_pages")
    ja, ta = jpg.PageAllocator(n_pages, 4), tpg.PageAllocator(n_pages, 4)
    for _ in range(data.draw(st.integers(5, 60), label="trace_len")):
        op = data.draw(st.sampled_from(["alloc", "retain", "release", "fork", "quarantine"]))
        args = () if op == "alloc" else (data.draw(st.integers(0, n_pages), label="pid"),)
        before = _alloc_state(ta)
        rj, rt = _apply(ja, op, *args), _apply(ta, op, *args)
        assert rj == rt, (op, args)
        assert _alloc_state(ja) == _alloc_state(ta), (op, args)
        if rt[0] == "raise":  # a refused operation leaves the counts as they were
            assert _alloc_state(ta)[1] == before[1]


def test_exhaustion_raises_with_refcounts_untouched():
    for mod in (jpg, tpg):
        a = mod.PageAllocator(3, 4)
        p1, p2 = a.alloc(), a.alloc()
        a.retain(p1)
        with pytest.raises(mod.PagingError, match="exhausted"):
            a.fork(p1)  # shared: needs a fresh page, and there is none
        assert (a.refcount(p1), a.refcount(p2), a.free_pages) == (2, 1, 0)
        with pytest.raises(mod.PagingError, match="null page"):
            mod.PageAllocator(1, 4)


@settings(max_examples=15, deadline=None)
@given(st.data())
def test_slot_pager_and_registry_traces_end_in_equal_states(data):
    n_pages, n_slots, per_slot = 12, 3, 4
    sides = []
    for mod in (jpg, tpg):
        a = mod.PageAllocator(n_pages, 4)
        sides.append((mod, a, mod.SlotPager(a, n_slots, per_slot), mod.PrefixRegistry(a, capacity=2)))
    for _ in range(data.draw(st.integers(3, 25), label="trace_len")):
        op = data.draw(st.sampled_from(["assign", "release", "register", "lookup", "evict"]))
        slot = data.draw(st.integers(0, n_slots - 1), label="slot")
        n_total = data.draw(st.integers(0, per_slot), label="n_total")
        toks = np.arange(data.draw(st.integers(1, 3), label="prefix")) + slot
        outs = []
        for mod, a, pager, reg in sides:
            try:
                if op == "assign":
                    shared = pager.owned_pages((slot + 1) % n_slots)[:n_total]
                    table, mask = pager.assign(slot, shared, n_total)
                    res = (table.tolist(), mask.tolist())
                elif op == "release":
                    res = pager.release(slot)
                elif op == "register":
                    res = reg.register(toks, pager.pages(slot), scratch=None, tag=(8, 8))
                elif op == "lookup":
                    e = reg.lookup(toks, tag=(8, 8))
                    res = None if e is None else (e.page_ids, e.hits, e.length)
                else:
                    res = reg.evict_oldest()
            except mod.PagingError as e:
                res = ("raise", str(e))
            outs.append((res, _alloc_state(a), {s: pager.pages(s) for s in range(n_slots)},
                         {s: pager.owned_pages(s) for s in range(n_slots)}, len(reg),
                         reg.evictions))
        assert outs[0] == outs[1], op


def _pools_equal(jcache, tcache):
    """Every leaf of every layer bit-equal, the null page's garbage too
    (the reference's stacked ``periods`` unstacked layer by layer)."""
    jblk = jcache["periods"]["b0_dense"]
    np.testing.assert_array_equal(np.asarray(jcache["step"]), t2n(tcache["step"]))
    for i, tblk in enumerate(tcache["layers"]):
        assert set(tblk) == set(jblk)
        for key in tblk:
            np.testing.assert_array_equal(np.asarray(jblk[key][i]), t2n(tblk[key]),
                                          err_msg=f"layer {i} {key}")


def _scratch_pair(rng, max_len, length):
    """A raw batch-1 scratch holding ``length`` positions in both packages."""
    jc, tc = jget(ARCH), tget(ARCH)
    js = jinit_cache(jc, 1, max_len, jnp.bfloat16, kv_quant=False)
    ts = tinit_cache(tc, 1, max_len, torch.bfloat16, kv_quant=False)
    jl = []
    for tblk in ts["layers"]:
        k = rng.standard_normal(tblk["k"].shape).astype(np.float32)
        v = rng.standard_normal(tblk["v"].shape).astype(np.float32)
        k[:, length:] = v[:, length:] = 0
        tblk["k"] = torch.from_numpy(k).to(torch.bfloat16)
        tblk["v"] = torch.from_numpy(v).to(torch.bfloat16)
        tblk["len"][:] = length
        jl.append((jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)))
    per = js["periods"]["b0_dense"]
    per["k"] = jnp.stack([k for k, _ in jl])
    per["v"] = jnp.stack([v for _, v in jl])
    per["len"] = jnp.full(per["len"].shape, length, jnp.int32)
    js["step"] = jnp.full((1,), length, jnp.int32)
    ts["step"][:] = length
    return js, ts


def test_device_helpers_give_the_reference_pools(rng):
    """The reference's engine runs its helpers compiled (its KV scale is
    then ``amax * (1/127)``, the form the port's quantize_kv repeats)."""
    jc, tc = jget(ARCH), tget(ARCH)
    jcommit = jax.jit(jpg.paged_commit)
    n_slots, max_len, ps, n_pages = 3, 32, 8, 11
    jcache = jpg.paged_init_cache(jc, n_slots, max_len, ps, n_pages)
    tcache = tpg.paged_init_cache(tc, n_slots, max_len, ps, n_pages)
    _pools_equal(jcache, tcache)
    assert jpg.page_nbytes(jcache) == tpg.page_nbytes(tcache)
    with pytest.raises(ValueError, match="divisible"):
        tpg.paged_init_cache(tc, n_slots, 30, ps, n_pages)
    with pytest.raises(ValueError, match="null page"):
        tpg.paged_init_cache(tc, n_slots, max_len, ps, 4)

    # two commits: the second shares the first's full prefix page (mask
    # False there), so only owned pages may change
    table_a = np.array([3, 7, 1, 0], np.int32)
    mask_a = np.array([True, True, True, False])
    table_b = np.array([3, 9, 0, 0], np.int32)
    mask_b = np.array([False, True, False, False])
    for slot, table, mask, length in ((0, table_a, mask_a, 21), (2, table_b, mask_b, 13)):
        js, ts = _scratch_pair(rng, max_len, length)
        before = {i: {k: v.clone() for k, v in blk.items()} for i, blk in enumerate(tcache["layers"])}
        jcache = jcommit(jcache, js, jnp.int32(slot), jnp.asarray(table),
                                  jnp.asarray(mask), jnp.int32(length))
        tcache = tpg.paged_commit(tcache, ts, slot, table, mask, length)
        _pools_equal(jcache, tcache)
        owned = set(table[mask].tolist()) | {0}
        for i, blk in enumerate(tcache["layers"]):
            for key in ("k_q", "k_scale", "v_q", "v_scale"):
                changed = (blk[key] != before[i][key]).reshape(n_pages, -1).any(dim=1)
                assert set(torch.nonzero(changed)[:, 0].tolist()) <= owned, key

    jcache = jax.jit(jpg.clear_slot)(jcache, jnp.int32(0))
    tcache = tpg.clear_slot(tcache, 0)
    _pools_equal(jcache, tcache)

    # select_paged: slot metadata per slot, pools per physical page
    other_j = jpg.paged_init_cache(jc, n_slots, max_len, ps, n_pages)
    other_t = tpg.paged_init_cache(tc, n_slots, max_len, ps, n_pages)
    js, ts = _scratch_pair(rng, max_len, 30)
    other_j = jcommit(other_j, js, jnp.int32(1), jnp.asarray(np.array([2, 4, 5, 6], np.int32)),
                               jnp.asarray(np.ones(4, bool)), jnp.int32(30))
    other_t = tpg.paged_commit(other_t, ts, 1, np.array([2, 4, 5, 6], np.int32), np.ones(4, bool), 30)
    take_slots = np.array([False, True, False])
    take_pages = np.zeros(n_pages, bool)
    take_pages[[2, 4, 5, 6, 9]] = True
    _pools_equal(jax.jit(jpg.select_paged)(jcache, other_j, take_slots, take_pages),
                 tpg.select_paged(tcache, other_t, take_slots, take_pages))
