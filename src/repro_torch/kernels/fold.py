"""Byte folds of whole trees in one launch: the Hopper kernel, its wrapper
and the plain model of its arithmetic.

The detect-mode fingerprints (``core.integrity.tree_checksum`` of the
quantized weight tree, ``models.cache.cache_slot_checksums`` of the KV
cache) sum every byte of many tensors modulo 2^32. Their plain versions
fold leaf by leaf with a uint8 -> int64 sum each; the reference compiles
them (``jax.jit`` at ``src/repro/launch/serve.py:181`` and ``:667``). On
the card one launch of ``csrc/fold.cu`` folds a device table of segments
instead: :func:`tree_fold` gives the tree's one total, :func:`slot_folds`
the cache's per-slot totals and :func:`page_folds` a paged cache's
per-page and per-slot totals (two launches), bit-equal to the plain
versions (a sum of bytes modulo 2^32 does not depend on its order).
:func:`chunked_fold` models the kernel's chunks on the host.

CUDA tensors launch the kernel and CPU tensors run the plain versions;
nothing falls back. Tables are built once per set of (pointer, size)
segments, so the engine's persistent trees fold with no host copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, Sequence

import torch

from repro_torch.core import integrity
from repro_torch.kernels import _build
from repro_torch.models import paging
from repro_torch.models.cache import cache_slot_checksums

#: bytes one block folds (``fold::kChunk`` of csrc/fold.cu)
CHUNK_BYTES = 1 << 16
MASK32 = 0xFFFFFFFF


def chunked_fold(leaves: Sequence[torch.Tensor], n_slots: int) -> torch.Tensor:
    """The kernel's arithmetic on the host: every leaf is ``n_slots`` spans
    of ``nbytes / n_slots`` bytes, each cut into ``CHUNK_BYTES`` chunks; a
    chunk's byte sum (mod 2^32) adds into its span's total, modulo 2^32.
    Returns ``(n_slots,)`` int64 holding uint32 values."""
    out = [0] * n_slots
    for leaf in leaves:
        stride = _stride(leaf, n_slots)
        b = leaf.contiguous().reshape(-1).view(torch.uint8).reshape(n_slots, stride)
        for slot in range(n_slots):
            for c in range(0, stride, CHUNK_BYTES):
                part = int(b[slot, c:c + CHUNK_BYTES].sum(dtype=torch.int64)) & MASK32
                out[slot] = (out[slot] + part) & MASK32
    return torch.tensor(out, dtype=torch.int64)


def _stride(leaf: torch.Tensor, n_slots: int) -> int:
    nbytes = leaf.numel() * leaf.element_size()
    if nbytes % n_slots:
        raise ValueError(f"a leaf of {nbytes} bytes does not split into {n_slots} slots")
    return nbytes // n_slots


def _segments(leaves: Iterable[torch.Tensor], n_slots: int, device) -> tuple:
    """((pointer, stride), ...) of the non-empty leaves, checked."""
    segs = []
    for leaf in leaves:
        if leaf.device != device:
            raise ValueError(f"a leaf is on {leaf.device}, expected {device}")
        if not leaf.is_contiguous():
            raise ValueError("the fold kernel reads contiguous leaves only")
        stride = _stride(leaf, n_slots)
        if stride:
            segs.append((leaf.data_ptr(), stride))
    return tuple(segs)


@functools.lru_cache(maxsize=16)
def _table(segs: tuple, n_slots: int, device: torch.device) -> tuple:
    """The device table (pointer, stride, first block) of ``segs`` and its
    total of blocks, built once per segment set."""
    rows, first = [], 0
    for ptr, stride in segs:
        rows.append((ptr, stride, first))
        first += n_slots * -(-stride // CHUNK_BYTES)
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1, 3).to(device)
    return table, first


def _lib():
    lib = _build.load("fold")
    fn = lib.fold_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, i, p, p]  # table, n_seg, n_blocks, n_slots, out, stream
        fn.restype = ctypes.c_int
        lib.fold_chunk_bytes.restype = ll
        if lib.fold_chunk_bytes() != CHUNK_BYTES:
            raise RuntimeError(f"the kernel folds chunks of {lib.fold_chunk_bytes()} bytes, "
                               f"the wrapper counts blocks by {CHUNK_BYTES}")
    return fn


def fold_leaves(leaves: Sequence[torch.Tensor], n_slots: int) -> torch.Tensor:
    """``(n_slots,)`` int64 uint32 totals of the leaves' bytes, span ``i`` of
    every leaf into total ``i``, in one kernel launch (CUDA leaves, on
    their device; nothing is read back). CPU leaves run
    :func:`chunked_fold`."""
    leaves = list(leaves)
    if not leaves or not leaves[0].is_cuda:
        return chunked_fold(leaves, n_slots)
    dev = leaves[0].device
    table, n_blocks = _table(_segments(leaves, n_slots, dev), n_slots, dev)
    out = torch.empty((n_slots,), dtype=torch.int32, device=dev)
    fold_leaves.launches += 1
    err = _lib()(table.data_ptr(), table.shape[0], n_blocks, n_slots, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fold launch failed: CUDA error {err}")
    return out.to(torch.int64) & MASK32


fold_leaves.launches = 0


def tree_fold(tree) -> torch.Tensor:
    """``integrity.tree_checksum(tree)``: the uint32 fold of every byte of
    every tensor leaf (0-dim int64), in one launch for a tree on the card;
    a tree on the host runs the plain version."""
    leaves = list(integrity._leaves(tree))
    if not leaves or not leaves[0].is_cuda:
        return integrity.tree_checksum(tree)
    return fold_leaves(leaves, 1)[0]


def slot_folds(cache) -> torch.Tensor:
    """``cache_slot_checksums(cache)``: per-slot uint32 folds of a dense
    decode cache, ``(n_slots,)`` int64, in one launch on the card; a cache
    on the host runs the plain version."""
    step = cache["step"]
    if not step.is_cuda:
        return cache_slot_checksums(cache)
    leaves = [step] + [leaf for blk in cache["layers"] for leaf in blk.values()]
    for leaf in leaves:
        if leaf.shape[0] != step.shape[0]:
            raise ValueError("every cache leaf must lead with the slot axis")
    return fold_leaves(leaves, step.shape[0])


def page_folds(cache) -> tuple[torch.Tensor, torch.Tensor]:
    """``paging.paged_checksums(cache)``: a paged cache's ``(page_sums,
    slot_sums)``, int64 uint32 totals. On the card two launches: the pool
    leaves, which lead with the page axis, in ``n_pages`` spans, and the
    slot metadata in ``n_slots`` spans. A cache on the host runs the plain
    version."""
    if not cache["step"].is_cuda:
        return paging.paged_checksums(cache)
    pools, slots = paging.pool_and_slot_leaves(cache)
    for leaves in (pools, slots):
        for leaf in leaves:
            if leaf.shape[0] != leaves[0].shape[0]:
                raise ValueError("the pool leaves must lead with the page axis and the "
                                 "metadata with the slot axis")
    return (fold_leaves(pools, pools[0].shape[0]),
            fold_leaves(slots, slots[0].shape[0]))
