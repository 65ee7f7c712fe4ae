"""Paged KV cache: fixed-size pages, free-list allocation, copy-on-write
sharing.

Every attention layer's KV lives in a **page pool** of ``n_pages`` pages of
``page_size`` positions (int8 values plus the per-(position, head) float32
scales paging along with them). A logical page id indexes the same
physical page in every layer's pool, so one block-table row per slot
serves the whole stack; decode finds the write and read pages by
``pos // page_size``. Pages are refcounted: requests that declare a shared
prompt prefix map its full pages read-only, and the divergence page is
committed from the request's own scratch (the engine forks eagerly at
commit; :meth:`PageAllocator.fork` is the general copy-on-write rule).
**Page 0 is the reserved null page**: free decode lanes and masked commit
chunks scatter there and unwritten table entries point there; it is never
allocated and never read as live data.

Prefill runs against a raw bf16 batch-1 scratch cache in chunks;
:func:`paged_commit` quantizes the finished scratch once and scatters it
into the pools. Quantization is per (position, head), so the committed
bytes do not depend on the chunk schedule.

The host bookkeeping (:class:`PageAllocator`, :class:`SlotPager`,
:class:`PrefixRegistry`) is the reference's ``models/paging.py`` line for
line; the device helpers keep the reference's values on the port's cache
layout (a list of per-layer blocks) and update the cache in place, as
:func:`repro_torch.models.cache.insert_slot` does. :func:`paged_checksums`
is the integrity fold of a paged cache: per page over the pools, per slot
over the metadata (its one-launch counterpart on the card is
``kernels.fold.page_folds``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.models.cache import _mask, _select, quantize_kv
from repro_torch.models.config import ModelConfig


class PagingError(RuntimeError):
    """Page bookkeeping violation: double free, unknown page, pool
    exhaustion, or a slot assignment clashing with a live tenant."""


# ---------------------------------------------------------------------------
# Host-side bookkeeping
# ---------------------------------------------------------------------------


class PageAllocator:
    """Free-list page allocator with refcounts and CoW fork.

    Page ids run ``1..n_pages-1``; page 0 is the reserved null page and
    is never handed out. ``alloc`` returns a page with refcount 1;
    ``retain``/``release`` move the count, and the page returns to the
    free list exactly when the count hits zero (unless quarantined).
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise PagingError(
                f"n_pages={n_pages}: need at least 2 (page 0 is the reserved "
                "null page)"
            )
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list, lowest ids first out — keeps traces reproducible.
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._ref: dict[int, int] = {}
        self._quarantined: set[int] = set()
        self.peak_used = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._ref)

    @property
    def quarantined_pages(self) -> int:
        return len(self._quarantined)

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def alloc(self) -> int:
        if not self._free:
            raise PagingError(
                f"KV page pool exhausted ({self.n_pages} pages, "
                f"{len(self._quarantined)} quarantined); admission should "
                "have checked free-page capacity"
            )
        pid = self._free.pop()
        self._ref[pid] = 1
        self.peak_used = max(self.peak_used, len(self._ref))
        return pid

    def retain(self, pid: int) -> None:
        if pid not in self._ref:
            raise PagingError(f"retain of non-live page {pid}")
        self._ref[pid] += 1

    def release(self, pid: int) -> None:
        if pid not in self._ref:
            raise PagingError(f"release of non-live page {pid} (double free?)")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            del self._ref[pid]
            if pid not in self._quarantined:
                self._free.append(pid)

    def fork(self, pid: int) -> tuple[int, bool]:
        """Copy-on-write: declare intent to *write* page ``pid``.

        Exclusively held (refcount 1): returns ``(pid, False)`` — write
        in place. Shared: the caller's reference moves to a fresh page
        and the shared bytes stay untouched for the other holders —
        returns ``(new_pid, True)`` and the caller must copy the page
        bytes before diverging.
        """
        if pid not in self._ref:
            raise PagingError(f"fork of non-live page {pid}")
        if self._ref[pid] == 1:
            return pid, False
        # alloc before dropping the shared reference: pool exhaustion must
        # leave the refcounts untouched (the caller keeps its old handle)
        new_pid = self.alloc()
        self._ref[pid] -= 1
        return new_pid, True

    def quarantine(self, pid: int) -> None:
        """Permanently retire a page (repeat integrity offender). Takes
        effect immediately if free, else when its refcount drains."""
        if pid == 0 or pid in self._quarantined:
            return
        self._quarantined.add(pid)
        if pid in self._free:
            self._free.remove(pid)


class SlotPager:
    """Per-slot page assignment on top of :class:`PageAllocator`.

    Tracks which page ids each slot's block table holds and which of
    them the slot *owns* (allocated for it) versus maps *shared*
    (retained from a prefix-registry entry, never written by this slot).
    """

    def __init__(self, allocator: PageAllocator, n_slots: int, pages_per_slot: int):
        self.allocator = allocator
        self.n_slots = int(n_slots)
        self.pages_per_slot = int(pages_per_slot)
        self._pages: dict[int, list[int]] = {}
        self._owned: dict[int, list[bool]] = {}

    def pages_needed(self, extent: int) -> int:
        return -(-int(extent) // self.allocator.page_size)

    def holds(self, slot: int) -> bool:
        return slot in self._pages

    def pages(self, slot: int) -> list[int]:
        return list(self._pages.get(slot, ()))

    def owned_pages(self, slot: int) -> list[int]:
        return [
            p for p, own in zip(self._pages.get(slot, ()), self._owned.get(slot, ()))
            if own
        ]

    def assign(
        self, slot: int, shared_ids: Iterable[int], n_total: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Map ``shared_ids`` read-only and allocate the rest for ``slot``.

        Returns ``(table, write_mask)``: the block-table row padded with
        the null page to ``pages_per_slot``, and the owned-page mask the
        commit scatter uses (shared pages are never written).
        """
        if slot in self._pages:
            raise PagingError(f"slot {slot} already holds pages; release first")
        shared = list(shared_ids)
        if n_total > self.pages_per_slot or len(shared) > n_total:
            raise PagingError(
                f"slot {slot}: {n_total} pages requested "
                f"({len(shared)} shared) > pages_per_slot={self.pages_per_slot}"
            )
        for pid in shared:
            self.allocator.retain(pid)
        ids = shared + [self.allocator.alloc() for _ in range(n_total - len(shared))]
        owned = [False] * len(shared) + [True] * (n_total - len(shared))
        self._pages[slot] = ids
        self._owned[slot] = owned
        table = np.zeros((self.pages_per_slot,), np.int32)
        table[: len(ids)] = ids
        mask = np.zeros((self.pages_per_slot,), bool)
        mask[: len(ids)] = owned
        return table, mask

    def release(self, slot: int) -> None:
        for pid in self._pages.pop(slot, []):
            self.allocator.release(pid)
        self._owned.pop(slot, None)

    def slots_holding(self, pid: int) -> list[int]:
        return [s for s, ids in self._pages.items() if pid in ids]


@dataclasses.dataclass
class PrefixEntry:
    tokens: np.ndarray
    length: int
    page_ids: tuple
    scratch: object  # raw scratch cache at `length` tokens (never written again)
    hits: int = 0


class PrefixRegistry:
    """Shared-prefix registry: prompt-prefix bytes -> retained pages +
    the raw scratch snapshot at the prefix boundary.

    A hit maps the prefix's **full** pages read-only into the new slot
    and resumes chunked prefill from the snapshot, so the prefix is
    neither recomputed nor re-stored. Entries are LRU-ordered; the
    engine evicts under page pressure (capacity check) and the registry
    self-bounds at ``capacity`` entries.
    """

    def __init__(self, allocator: PageAllocator, capacity: int = 64):
        self.allocator = allocator
        self.capacity = int(capacity)
        self._entries: dict[bytes, PrefixEntry] = {}
        self.evictions = 0

    @staticmethod
    def key(tokens, tag=None) -> bytes:
        """Registry key: the prefix token bytes, scoped by ``tag`` — the
        engine passes its runtime precision dial, because a prefix
        prefilled at one tier is NOT bit-identical to the same tokens
        prefilled at another and must never be reused across tiers."""
        base = np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
        if tag is None:
            return base
        return repr(tag).encode() + b"|" + base

    def __len__(self) -> int:
        return len(self._entries)

    def peek(self, tokens, tag=None) -> Optional[PrefixEntry]:
        """Lookup without the LRU touch or hit count — the admission
        capacity check uses this to size the page ask without committing
        to the hit."""
        return self._entries.get(self.key(tokens, tag))

    def lookup(self, tokens, tag=None) -> Optional[PrefixEntry]:
        k = self.key(tokens, tag)
        entry = self._entries.pop(k, None)
        if entry is None:
            return None
        self._entries[k] = entry  # LRU touch
        entry.hits += 1
        return entry

    def register(self, tokens, page_ids: Iterable[int], scratch, tag=None) -> bool:
        k = self.key(tokens, tag)
        if k in self._entries:
            return False
        ids = tuple(page_ids)
        for pid in ids:
            self.allocator.retain(pid)
        self._entries[k] = PrefixEntry(
            tokens=np.asarray(tokens, np.int32).copy(),
            length=int(np.asarray(tokens).size),
            page_ids=ids,
            scratch=scratch,
        )
        while len(self._entries) > self.capacity:
            self.evict_oldest()
        return True

    def evict_oldest(self, protect: Optional[bytes] = None) -> bool:
        """Evict the least-recently-used entry (page pressure). ``protect``
        exempts one key — the entry the admission in progress is about to
        hit must not be evicted out from under it."""
        for k in self._entries:
            if k != protect:
                self._drop(k)
                return True
        return False

    def drop_page(self, pid: int) -> int:
        """Invalidate every entry mapping ``pid`` (integrity fault on a
        shared page); future admissions re-prefill. Returns #dropped."""
        doomed = [k for k, e in self._entries.items() if pid in e.page_ids]
        for k in doomed:
            self._drop(k)
        return len(doomed)

    def clear(self) -> None:
        for k in list(self._entries):
            self._drop(k)

    def _drop(self, k: bytes) -> None:
        entry = self._entries.pop(k)
        for pid in entry.page_ids:
            self.allocator.release(pid)
        self.evictions += 1


# ---------------------------------------------------------------------------
# Device-side cache
# ---------------------------------------------------------------------------

_POOL_KEYS = ("k_q", "k_scale", "v_q", "v_scale")


def _check_kinds(cfg: ModelConfig) -> None:
    bad = [k for k in cfg.layer_kinds() if k not in ("dense", "moe")]
    if bad:
        raise ValueError(
            f"paged KV requires full-attention layers only, got kinds {sorted(set(bad))}: "
            "windowed ring buffers and SSM/recurrent state stay dense"
        )


def _paged_block(cfg: ModelConfig, n_slots: int, pages_per_slot: int, n_pages: int,
                 page_size: int, device):
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "len": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "block_table": torch.zeros((n_slots, pages_per_slot), dtype=torch.int32, device=device),
        "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
    }


def paged_init_cache(cfg: ModelConfig, n_slots: int, max_len: int, page_size: int,
                     n_pages: int, device=None):
    """Paged decode cache: ``{"step": (n_slots,), "layers": [block, ...]}``
    like ``models.cache.init_cache``, but every attention block holds
    page pools and a block table instead of dense per-slot extents.

    ``max_len % page_size == 0`` is required: a slot's table then spans
    exactly ``max_len`` positions, the dense cache's extent."""
    _check_kinds(cfg)
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} not divisible by page_size={page_size}")
    pages_per_slot = max_len // page_size
    if n_pages < pages_per_slot + 1:
        raise ValueError(
            f"n_pages={n_pages} cannot hold even one slot "
            f"({pages_per_slot} pages) plus the null page"
        )
    return {
        "step": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "layers": [
            _paged_block(cfg, n_slots, pages_per_slot, n_pages, page_size, device)
            for _ in cfg.layer_kinds()
        ],
    }


def paged_commit(cache, scratch, slot, page_ids, write_mask, length):
    """Quantize a finished raw prefill scratch and scatter it into pages
    (in place; returns ``cache``).

    ``scratch``: batch-1 raw cache (``init_cache(cfg, 1, max_len,
    kv_quant=False)``) holding ``length`` prefilled positions.
    ``page_ids``/``write_mask``: ``(pages_per_slot,)`` block-table row and
    owned-page mask from :meth:`SlotPager.assign`. Chunks of owned pages go
    to their pages; masked (shared / unused) chunks go to the null page 0,
    where, as in the reference's scatter, the last one stays — read-only
    prefix pages are never touched."""
    page_ids = np.asarray(page_ids, np.int32)
    mask = np.asarray(write_mask, bool)
    owned = np.flatnonzero(mask)
    masked = np.flatnonzero(~mask)
    for blk, sblk in zip(cache["layers"], scratch["layers"]):
        dev = blk["k_q"].device
        ps = blk["k_q"].shape[1]
        kq, ks = quantize_kv(sblk["k"])
        vq, vs = quantize_kv(sblk["v"])
        tgt = torch.as_tensor(page_ids[owned], dtype=torch.int64, device=dev)
        src = torch.as_tensor(owned, dtype=torch.int64, device=dev)
        for key, val in (("k_q", kq), ("k_scale", ks), ("v_q", vq), ("v_scale", vs)):
            pool = blk[key]
            # drop the batch-1 axis, split positions into (pages, page_size)
            ch = val[0].reshape(-1, ps, *val.shape[2:]).to(pool.dtype)
            if masked.size:
                pool[0] = ch[int(masked[-1])]
            if owned.size:
                pool[tgt] = ch[src]
        blk["len"][slot] = length
        blk["block_table"][slot] = torch.as_tensor(page_ids, device=dev)
    cache["step"][slot] = length
    return cache


def clear_slot(cache, slot):
    """Neutralize a released slot's device state (in place; returns
    ``cache``): zero its length and point its whole block table at the
    null page, so the free lane's garbage decode writes land on page 0
    instead of pages that may since have been reallocated to another
    tenant."""
    for blk in cache["layers"]:
        blk["len"][slot] = 0
        blk["block_table"][slot] = 0
    cache["step"][slot] = 0
    return cache


def select_paged(cache_a, cache_b, take_slots, take_pages, out=None):
    """Mixed-tier merge for paged caches: slot metadata (len / step / block
    table) selects per slot, pool leaves select per **physical page** —
    ``take_pages`` marks the pages owned by slots whose post-step state
    should come from ``cache_b``. Decode writes touch only the writer
    slot's current owned page (shared prefix pages are read-only), so a
    page-granular select is exact; page 0 takes either side's garbage.
    The masks are device tensors or host data; with ``out`` the result is
    written into its leaves in place (see :func:`cache.select_slots`)."""
    dev = cache_a["step"].device
    take_slots = _mask(take_slots, dev)
    take_pages = _mask(take_pages, dev)
    res = {"step": _select(cache_a["step"], cache_b["step"], take_slots,
                           None if out is None else out["step"]),
           "layers": []}
    for i, (ablk, bblk) in enumerate(zip(cache_a["layers"], cache_b["layers"])):
        res["layers"].append({
            key: _select(ablk[key], bblk[key], take_pages if key in _POOL_KEYS else take_slots,
                         None if out is None else out["layers"][i][key])
            for key in ablk
        })
    return res if out is None else out


def pool_and_slot_leaves(cache) -> tuple[list, list]:
    """The paged cache's leaves split by their leading axis: the pool
    leaves (page axis) and the slot metadata (``step``, then each layer's
    ``len`` and ``block_table``, slot axis), in the fold order."""
    pools, slots = [], [cache["step"]]
    for blk in cache["layers"]:
        for key, leaf in blk.items():
            (pools if key in _POOL_KEYS else slots).append(leaf)
    return pools, slots


def paged_checksums(cache):
    """Integrity fold of a paged cache: ``(page_sums, slot_sums)``.

    ``page_sums``: ``(n_pages,)`` int64 holding uint32 values, every byte
    of every pool leaf folded to the physical-page axis: one flipped bit in
    page ``p``'s values or scales moves ``page_sums[p]`` and only it.
    ``slot_sums``: ``(n_slots,)`` over the ``len`` / ``step`` /
    ``block_table`` metadata. The engine maps a dirty page back to the
    slots and registry entries holding it; page 0 is left out of that
    attribution (free lanes scatter garbage there every step)."""

    def fold(leaves):
        total = 0
        for leaf in leaves:
            b = leaf.contiguous().view(torch.uint8)
            total = total + b.reshape(leaf.shape[0], -1).sum(dim=1, dtype=torch.int64)
        return total & 0xFFFFFFFF

    pools, slots = pool_and_slot_leaves(cache)
    return fold(pools), fold(slots)


def page_nbytes(cache) -> int:
    """Bytes one logical page occupies across every layer's pools (int8
    values + float32 scales, K and V). ``peak_used_pages * page_nbytes`` is
    the resident-KV metric."""
    total = 0
    for blk in cache["layers"]:
        n_pages = blk["k_q"].shape[0]
        for key in _POOL_KEYS:
            leaf = blk[key]
            total += (leaf.numel() // n_pages) * leaf.element_size()
    return total
