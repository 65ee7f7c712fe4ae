"""Asynchronous, atomic checkpointing with resume and GC.

Layout (the reference's, so checkpoints cross between the packages in
both directions): ``<dir>/step_<N>/arrays.npz`` + ``meta.json``,
published by an atomic directory rename (``step_N.tmp`` -> ``step_N``),
so a crash mid-save never corrupts the latest checkpoint. Each leaf is
stored under its tree path (dict keys in sorted order and sequence
indices, joined by ``/``); ``meta.json`` records the step, the save time,
each leaf's dtype name and a crc32 of its bytes, checked on restore.
bfloat16 has no numpy dtype: it is stored as its uint16 bit pattern and
recorded as ``"bfloat16"``.

Saving snapshots the tree to host memory first, then writes on a
background thread while training continues. ``saves`` records each
save's step, snapshot and write seconds and bytes written.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as tr


class CheckpointCorruptionError(RuntimeError):
    """A restored array's checksum does not match the one recorded at
    save time (bit rot, torn write, SEU in storage)."""


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array it does not share with the caller
    (bfloat16 as its uint16 bit pattern)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.to("cpu", copy=True) if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    """crc32 of the array's bytes (those ``tobytes`` gives, without the copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _leaf_from(arr: np.ndarray, dtype: Optional[str], like):
    """The stored array as a leaf shaped like ``like``: a tensor on its
    device when ``like`` is one, else numpy."""
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(like.device)
    if dtype and str(arr.dtype) != dtype:
        raise TypeError(f"a {dtype} leaf restores only into a tensor template")
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves: list[dict] = []

    # -- save ------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[dict] = None, block=False):
        """Snapshot to host, then write in the background (``block``:
        write now)."""
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        flat, dtypes = {}, {}
        for path, leaf in tr.flatten_with_path(state):
            key = tr.path_key(path)
            flat[key], dtypes[key] = _host(leaf)
        meta = {"step": int(step), "time": time.time(), **(extra or {})}
        snapshot_s = time.perf_counter() - t0

        def work():
            try:
                t1 = time.perf_counter()
                self._write(step, flat, dtypes, meta)
                self.saves.append({
                    "step": int(step), "snapshot_s": snapshot_s,
                    "write_s": time.perf_counter() - t1,
                    "bytes": (self.dir / f"step_{step}" / "arrays.npz").stat().st_size,
                })
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_pending()

    def _write(self, step: int, flat: dict, dtypes: dict, meta: dict):
        final = self.dir / f"step_{step}"
        tmp = self.dir / f"step_{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        # a crc32 per array, verified on restore: the atomic rename guards
        # against torn publishes, the checksums against bit rot inside a
        # published checkpoint
        checksums = {k: _crc(v) for k, v in flat.items()}
        with open(tmp / "arrays.npz", "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        (tmp / "meta.json").write_text(
            json.dumps({**meta, "_dtypes": dtypes, "_checksums": checksums})
        )
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    # -- restore ----------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "meta.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: Optional[int] = None, place=None):
        """(state shaped like ``template``, meta), or (None, None) with no
        checkpoint. Tensor leaves of ``template`` give the device (the
        dtype is the stored one); other leaves come back as numpy.
        ``place(key, array)``: what is kept of each stored array before it
        is checked against the template (a sharded run's rank keeps its
        block: the template then holds blocks).

        Every array's bytes are checked against the crc32 recorded at save
        time; a mismatch raises :class:`CheckpointCorruptionError` naming
        the array and step (checkpoints without checksums restore
        unchecked)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self.dir / f"step_{step}"
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        meta = json.loads((d / "meta.json").read_text())
        checksums = meta.pop("_checksums", None)
        if checksums is not None:
            for key, want in checksums.items():
                if key not in flat:
                    raise CheckpointCorruptionError(
                        f"checkpoint step {step}: array {key!r} has a recorded "
                        "checksum but is missing from arrays.npz"
                    )
                got = _crc(flat[key])
                if got != want:
                    raise CheckpointCorruptionError(
                        f"checkpoint step {step}: array {key!r} is corrupt "
                        f"(crc32 {got:#010x} != recorded {want:#010x}) — "
                        "the checkpoint bytes changed after save; restore "
                        "an older step or re-save from a healthy replica"
                    )
        dtypes = meta.pop("_dtypes", {})
        out = []
        for path, like in tr.flatten_with_path(template):
            key = tr.path_key(path)
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = flat[key] if place is None else place(key, flat[key])
            want = getattr(like, "shape", None)
            if want is not None and tuple(arr.shape) != tuple(want):
                raise ValueError(f"leaf {key!r}: checkpoint {arr.shape} vs model {tuple(want)}")
            out.append(_leaf_from(arr, dtypes.get(key), like))
        return tr.unflatten_like(template, out), meta

    # -- GC ----------------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
