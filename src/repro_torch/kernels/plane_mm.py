"""Plane-pair matrix multiplication: the Hopper kernel, its wrapper and its
plain PyTorch version.

Port of ``src/repro/kernels/plane_mm.py::plane_matmul``: over unpacked
int8 planes ``A (P_a, M, K)`` and ``W (P_w, K, N)`` it returns
``sum_{i,j} pw[i*P_w+j] * (A_i @ W_j)`` exactly in int32. It serves the
bit-plane level (weights +-2^(i+j)) and the Booth radix-256 digit level
(weights +-256^(i+j), wrapped to int32). The kernel source, with its
design note, is ``csrc/plane_mm.cu``.

:func:`plane_matmul` launches the kernel for CUDA tensors and runs
:func:`plane_matmul_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import plane_matmul_ref

#: row tiles the kernel is instantiated for
ROW_TILES = (1, 2, 4, 8, 16)
#: output columns and K values per CUDA block tile
COLS_PER_BLOCK = 128
K_TILE = 128


def plane_matmul_plain(
    a_planes: torch.Tensor, w_planes: torch.Tensor, pair_weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version (any device): exact float matmuls per plane
    pair, int32 pair weighting with wraparound."""
    return plane_matmul_ref(a_planes, w_planes, pair_weights)


def row_tile(m: int, bm: Optional[int] = None) -> int:
    if bm is not None:
        if bm not in ROW_TILES:
            raise ValueError(f"bm must be one of {ROW_TILES}, got {bm}")
        return bm
    return next((t for t in ROW_TILES if t >= m), ROW_TILES[-1])


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
) -> torch.Tensor:
    """sum_{i,j} pair_weights[i*P_w+j] * (a_planes[i] @ w_planes[j]) as
    (M, N) int32. CPU tensors run the plain version; CUDA tensors launch
    the kernel, and arguments it does not take raise."""
    n_a, m, k = a_planes.shape
    n_w, k2, n = w_planes.shape
    if k != k2:
        raise ValueError(f"K mismatch {tuple(a_planes.shape)} vs {tuple(w_planes.shape)}")
    if tuple(pair_weights.shape) != (n_a * n_w,):
        raise ValueError("pair_weights must have shape (P_a * P_w,)")
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
    if n_a * n_w > 256:
        raise ValueError("the kernel takes at most 256 plane pairs")
    tile = row_tile(m, bm)
    blocks = -(-n // COLS_PER_BLOCK) * -(-m // tile)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ksplit = max(1, min(-(-k // K_TILE), -(-2 * sms // blocks)))
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
