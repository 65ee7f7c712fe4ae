"""Integrity primitives: bit-pattern checksums and ABFT alarm collection
(the port of ``src/repro/core/integrity.py``; the engine's scrub-and-retry
recovery on top of them is in ``launch/serve.py``).

* **Storage fingerprints** (:func:`bit_fold`, :func:`tree_checksum`): a
  uint32 fold of the raw bytes of every tensor leaf. A flip of bit ``b``
  of one byte moves the sum by ``±2^b mod 2^32``, never 0, so comparing
  with a fold taken at load time detects any single at-rest flip,
  including flips in packed-word padding bits.
* **ABFT execution checks** (reported by the plan executors): the
  row-sum identity ``sum_n (x @ w)[m, n] == x @ (sum_n w[:, n])`` holds
  exactly modulo 2^32; the right-hand side comes from the per-plane
  column checksums of the packed cache, so a flipped plane word is caught
  at the matmul that consumed it.

Alarm flags are device tensors. Under an active :class:`Collector`
:func:`report` appends the flag (no host sync); the step stacks the flags
into one alarm vector and the engine reads it once per step with the
tokens, then :meth:`Collector.harvest` tallies it per plan key. A decode
step captured as a CUDA graph reports its flags once, while it is
captured: the collector's keys are then the graph's, and every replay
rewrites the same alarm vector, which the engine harvests against those
keys. Without a collector a flag is read and tallied at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

INTEGRITY_MODES = ("off", "detect", "scrub")

_MASK32 = 0xFFFFFFFF


class IntegrityError(RuntimeError):
    """Corruption was detected and could not be contained or recovered."""


def check_integrity_mode(mode: str) -> str:
    if mode not in INTEGRITY_MODES:
        raise ValueError(f"integrity must be one of {INTEGRITY_MODES}, got {mode!r}")
    return mode


# ---------------------------------------------------------------------------
# Bit-pattern folds (at-rest corruption detection)
# ---------------------------------------------------------------------------


def bit_fold(x: torch.Tensor) -> torch.Tensor:
    """Sum of the bytes of ``x`` (any dtype) modulo 2^32, as a 0-dim int64
    tensor on ``x``'s device. The bytes are reinterpreted (``view``), not
    converted, and summed in int64 (a uint8 sum promotes to it anyway)."""
    b = x.reshape(-1).view(torch.uint8)
    return b.sum(dtype=torch.int64) & _MASK32


def _leaves(tree):
    """Tensor leaves of a parameter tree: dicts, lists, tuples, and the
    plane-cache dataclasses (their tensor fields)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def tree_checksum(tree: Any) -> torch.Tensor:
    """Fold every tensor leaf of a tree into one uint32 fingerprint (a
    0-dim int64 tensor on the leaves' device)."""
    total = None
    for leaf in _leaves(tree):
        f = bit_fold(leaf)
        total = f if total is None else total + f.to(total.device)
    if total is None:
        return torch.zeros((), dtype=torch.int64)
    return total & _MASK32


# ---------------------------------------------------------------------------
# Alarm collection
# ---------------------------------------------------------------------------

_STACK: list["Collector"] = []
# plan key (or str pseudo-key) -> [checks, alarms]; module-level so the
# tally survives plan interning and is shared by every engine in the process
_TALLY: dict[Any, list] = {}


def record(key: Any, bad: bool, checks: int = 1) -> None:
    """Tally ``checks`` integrity checks (``bad`` of them alarming) for a key."""
    tally = _TALLY.setdefault(key, [0, 0])
    tally[0] += checks
    tally[1] += int(bool(bad))


def stats_for(key: Any) -> dict:
    checks, alarms = _TALLY.get(key, (0, 0))
    return {"checks": int(checks), "alarms": int(alarms)}


def all_stats() -> dict:
    return {k: {"checks": v[0], "alarms": v[1]} for k, v in _TALLY.items()}


def reset_tally() -> None:
    _TALLY.clear()


def report(key: Any, flag: torch.Tensor) -> None:
    """Report an ABFT check outcome (``flag`` True = mismatch) for ``key``:
    appended to the active collector, or read and tallied now without one."""
    if _STACK:
        _STACK[-1].keys.append(key)
        _STACK[-1].flags.append(flag)
        return
    record(key, bool(flag))


class Collector:
    """Collects the ABFT alarm flags reported while a step runs; the step
    returns :meth:`stacked`, and the engine hands the values it read back
    to :meth:`harvest`."""

    def __init__(self) -> None:
        self.keys: list = []
        self.flags: list = []

    @contextlib.contextmanager
    def collect(self):
        self.keys, self.flags = [], []
        _STACK.append(self)
        try:
            yield self
        finally:
            _STACK.pop()

    def stacked(self, device=None) -> torch.Tensor:
        """The alarm vector (empty when nothing was checked)."""
        if not self.flags:
            return torch.zeros((0,), dtype=torch.bool, device=device)
        dev = self.flags[0].device
        return torch.stack([f.reshape(()).to(dev) for f in self.flags])

    def any_alarm(self) -> torch.Tensor:
        """OR of every flag reported so far (a False host scalar if none),
        on the flags' device: nothing is copied from the host."""
        out = None
        for f in self.flags:
            out = f.reshape(()) if out is None else f.reshape(()) | out
        return torch.zeros((), dtype=torch.bool) if out is None else out

    def harvest(self, alarms, keys: Optional[list] = None) -> list:
        """Tally read-back alarm values against the keys of this step's
        reports (or ``keys``, kept from an earlier step whose alarms were
        read back later); returns ``[(key, bad), ...]``."""
        keys = self.keys if keys is None else keys
        vals = [bool(v) for v in torch.as_tensor(alarms).reshape(-1).tolist()]
        # report/report_carried append a key with every flag, so the step's
        # alarm vector and the keys always pair up
        assert len(keys) == len(vals), (len(keys), len(vals))
        out = []
        for key, bad in zip(keys, vals):
            record(key, bad)
            out.append((key, bad))
        return out


@contextlib.contextmanager
def scan_scope():
    """Fold the checks of a scanned layer stack into one flag, as the
    reference does for checks made inside its ``lax.scan`` body: the body
    reports to a nested collector, and :func:`report_carried` hands the OR
    of its flags to the outer one under the ``"<scan>"`` key. So a step
    counts one check for the whole stack, as the reference's does. With
    no collector active it is inert."""
    if not _STACK:
        yield None
        return
    inner = Collector()
    with inner.collect():
        yield inner
    report_carried(inner.any_alarm())


def report_carried(flag: torch.Tensor) -> None:
    """Report a scan-folded alarm to the active collector (no-op without one)."""
    if _STACK:
        _STACK[-1].keys.append("<scan>")
        _STACK[-1].flags.append(flag)


__all__ = [
    "INTEGRITY_MODES",
    "IntegrityError",
    "check_integrity_mode",
    "bit_fold",
    "tree_checksum",
    "Collector",
    "report",
    "report_carried",
    "scan_scope",
    "record",
    "stats_for",
    "all_stats",
    "reset_tally",
]
