"""Plane-pair matrix multiplication: the Hopper kernel, its wrapper and its
plain PyTorch version.

Port of ``src/repro/kernels/plane_mm.py::plane_matmul``: over unpacked
int8 planes ``A (P_a, M, K)`` and ``W (P_w, K, N)`` it returns
``sum_{i,j} pw[i*P_w+j] * (A_i @ W_j)`` exactly in int32, for any int32
pair weights. It serves the bit-plane level (weights +-2^(i+j)) and the
Booth radix-256 digit level (weights +-256^(i+j), wrapped to int32), and
it is the all-pairs path of the fused and packed kernels for pair weights
they cannot factor. The kernel runs one int8 tensor-core product per
plane pair and K chunk and folds it into a uint32 total with its pair
weight; :func:`chunked_plane_matmul` is the plain model of that
arithmetic. The kernel source, with its design note, is
``csrc/plane_mm.cu``.

:func:`plane_matmul` launches the kernel for CUDA tensors and runs
:func:`plane_matmul_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build, bytesplit
from repro_torch.kernels.bytesplit import _sm_count, row_tile
from repro_torch.kernels.ref import plane_matmul_ref

#: K values per chunk: one pair product's exact int32 span, the unit of the K split
K_TILE = 128
#: A planes one launch takes (more run as several launches into one output)
MAX_A_PLANES = 16
#: W planes the kernel takes
MAX_W_PLANES = 64
MASK32 = 0xFFFFFFFF


def plane_matmul_plain(
    a_planes: torch.Tensor, w_planes: torch.Tensor, pair_weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version (any device): exact float matmuls per plane
    pair, int32 pair weighting with wraparound."""
    return plane_matmul_ref(a_planes, w_planes, pair_weights)


def chunked_plane_matmul(
    a_planes: torch.Tensor,
    w_planes: torch.Tensor,
    pair_weights: torch.Tensor,
    *,
    ksplit: int = 1,
    order: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The kernel's arithmetic, step by step: per K chunk of ``K_TILE``
    values and per plane pair an exact int32 product, folded into a uint32
    total as ``total += (uint32)pw[p] * (uint32)acc_p``; the chunks split
    into ``ksplit`` contiguous ranges whose partial totals meet modulo 2^32
    in ``order`` (the atomics' order, any permutation of the ranges).
    Returns (M, N) int32."""
    n_a, m, k = a_planes.shape
    n_w, _, n = w_planes.shape
    pw = [int(v) & MASK32 for v in pair_weights.tolist()]
    n_chunks = -(-k // K_TILE)
    cps = -(-n_chunks // ksplit)
    ranges = [(c, min(n_chunks, c + cps)) for c in range(0, n_chunks, cps)]
    partial = []
    for c0, c1 in ranges:
        total = torch.zeros((m, n), dtype=torch.int64)
        for c in range(c0, c1):
            ks = slice(c * K_TILE, min(k, (c + 1) * K_TILE))
            for j in range(n_w):
                wj = w_planes[j, ks].to(torch.int64)
                for i in range(n_a):
                    acc = a_planes[i, :, ks].to(torch.int64) @ wj  # within int32: |acc| <= 2^21
                    total = (total + pw[i * n_w + j] * (acc & MASK32)) & MASK32
        partial.append(total)
    out = torch.zeros((m, n), dtype=torch.int64)
    for r in (range(len(partial)) if order is None else order):
        out = (out + partial[r]) & MASK32
    return (out - ((out >> 31 & 1) << 32)).to(torch.int32)


def byte_transpose4x4(words: Sequence[int]) -> list[int]:
    """``byte_transpose4x4`` of ``csrc/plane_mm.cu``: four uint32 words of
    four K rows (byte c = column c) in, the four columns' K-quads out
    (byte r = row r), through the same eight ``__byte_perm`` selectors."""
    def perm(x, y, sel):
        src = [(x >> (8 * b)) & 0xFF for b in range(4)] + [(y >> (8 * b)) & 0xFF for b in range(4)]
        return sum(src[(sel >> (4 * b)) & 0x7] << (8 * b) for b in range(4))

    w0, w1, w2, w3 = (int(w) & MASK32 for w in words)
    t0, t1 = perm(w0, w1, 0x5140), perm(w2, w3, 0x5140)
    t2, t3 = perm(w0, w1, 0x7362), perm(w2, w3, 0x7362)
    return [perm(t0, t1, 0x5410), perm(t0, t1, 0x7632), perm(t2, t3, 0x5410),
            perm(t2, t3, 0x7632)]


def _lib():
    fn = _build.load("plane_mm").plane_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def plane_matmul(
    a_planes: torch.Tensor,
    w_planes: torch.Tensor,
    pair_weights: torch.Tensor,
    *,
    bm: Optional[int] = None,
    k_split: Optional[int] = None,
) -> torch.Tensor:
    """sum_{i,j} pair_weights[i*P_w+j] * (a_planes[i] @ w_planes[j]) as
    (M, N) int32, wrapping, for any int32 pair weights. ``bm`` (the row
    tile: 8, 16 or 32 tokens) and ``k_split`` (the ranges the ``K_TILE``
    chunks split into) choose the launch's geometry, never its result;
    None takes :func:`bytesplit.row_tile` / :func:`bytesplit.k_split`
    (the byte-split kernels' row tiles and 128-column blocks). CPU tensors
    run the plain version; CUDA tensors launch the kernel, and arguments
    it does not take raise."""
    n_a, m, k = a_planes.shape
    n_w, k2, n = w_planes.shape
    if k != k2:
        raise ValueError(f"K mismatch {tuple(a_planes.shape)} vs {tuple(w_planes.shape)}")
    if tuple(pair_weights.shape) != (n_a * n_w,):
        raise ValueError("pair_weights must have shape (P_a * P_w,)")
    bytesplit.checked_k_split(k_split)
    if not a_planes.is_cuda:
        return plane_matmul_plain(a_planes, w_planes, pair_weights)
    dev = a_planes.device
    for t, dt, name in (
        (a_planes, torch.int8, "a_planes"),
        (w_planes, torch.int8, "w_planes"),
        (pair_weights, torch.int32, "pair_weights"),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_w > MAX_W_PLANES:
        raise ValueError(f"the kernel takes at most {MAX_W_PLANES} weight planes, got {n_w}")
    tile = row_tile(m, bm)
    ksplit = k_split or bytesplit.k_split(m, n, -(-k // K_TILE), tile, _sm_count(dev))
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    plane_matmul.launches += 1
    err = _lib()(
        a_planes.data_ptr(), w_planes.data_ptr(), pair_weights.data_ptr(),
        n_a, n_w, m, k, n, out.data_ptr(), ksplit, tile,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"plane_matmul launch failed: CUDA error {err}")
    return out


plane_matmul.launches = 0
