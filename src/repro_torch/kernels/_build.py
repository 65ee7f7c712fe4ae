"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds). Libraries go to the
git-ignored ``build/repro_torch/`` directory of the checkout, named by a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags: the
first use builds, later runs reuse, an edited source rebuilds. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import time; the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no contraction of a*b+c into one rounding: the epilogues must round
    # exactly as the plain PyTorch versions do
    "-fmad=false",
)

SOURCES = ("plane_mm_fused", "plane_mm", "plane_mm_packed", "flash_attn", "fold")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / name
        if cand.exists():
            return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit")


def lib_path(name: str) -> Path:
    """The shared library of ``csrc/<name>.cu`` for the current sources."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))  # shared headers
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (proc, tmp, dst) or None when
    the library is already built."""
    dst = lib_path(name)
    if dst.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, dst


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, dst = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            + out.decode(errors="replace")
        )
    os.replace(tmp, dst)  # atomic: concurrent builders never load a torn file


def build_all() -> float:
    """Build every kernel library that is missing, in parallel; returns the
    seconds spent (0.0 when all were already built)."""
    t0 = time.perf_counter()
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        for name, st in started.items():
            _finish(name, st)
    return time.perf_counter() - t0 if any(started.values()) else 0.0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
