"""Recovery runtime: step retry and straggler detection (the port of
``src/repro/runtime/recovery.py``).

* ``retry_step``        — transient-failure retry with exponential backoff;
                          after ``max_retries`` the exception escalates to
                          the caller. Its default ``retriable`` is
                          ``RuntimeError``, which ``torch`` and CUDA
                          runtime errors subclass.
* ``StragglerDetector`` — robust step-time outlier detection (median +
                          k*MAD over a sliding window).
* ``HealthMonitor``     — heartbeat bookkeeping for worker liveness.
* ``ElasticMesh``       — rebuilds the ``(data, model)`` rank mesh when the
                          number of healthy ranks changes, and puts a
                          restored whole tree onto the new layout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np


def retry_step(
    fn: Callable,
    *args,
    max_retries: int = 3,
    backoff_s: float = 0.5,
    retriable: tuple = (RuntimeError,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """Run ``fn``; retry transient runtime failures with backoff."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retriable as e:  # noqa: PERF203
            attempt += 1
            if attempt > max_retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2 ** (attempt - 1)))


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps slower than median + k*MAD over a sliding window."""

    window: int = 50
    k: float = 6.0
    min_samples: int = 10

    def __post_init__(self):
        self._times: list[float] = []
        self.flagged: list[tuple[int, float]] = []
        self._step = 0

    def record(self, seconds: float) -> bool:
        """Record a step time; returns True when it is a straggler."""
        self._step += 1
        hist = self._times[-self.window:]
        is_outlier = False
        if len(hist) >= self.min_samples:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) or 1e-6
            if seconds > med + self.k * 1.4826 * mad:
                is_outlier = True
                self.flagged.append((self._step, seconds))
        self._times.append(seconds)
        return is_outlier

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


@dataclasses.dataclass
class HealthMonitor:
    """Heartbeat bookkeeping for worker liveness (a single-controller stub:
    at scale it is fed by per-host heartbeats)."""

    timeout_s: float = 60.0

    def __post_init__(self):
        self._last: dict[str, float] = {}

    def beat(self, worker: str, t: Optional[float] = None):
        self._last[worker] = time.time() if t is None else t

    def dead_workers(self, now: Optional[float] = None) -> Sequence[str]:
        now = time.time() if now is None else now
        return [w for w, t in self._last.items() if now - t > self.timeout_s]


class ElasticMesh:
    """Rebuilds ``(data, model)`` meshes when the healthy-rank count
    changes: the model axis stays fixed (the tensor-parallel degree is a
    property of the model's sharding) and the data axis flexes, the
    reference's elastic policy."""

    def __init__(self, model_axis: int = 1):
        self.model_axis = model_axis

    def mesh_for(self, n_devices: int):
        """The mesh ``(max(n // model, 1), model)`` over the world's ranks
        (``launch/mesh.make_mesh``: every rank calls it)."""
        from repro_torch.launch.mesh import make_mesh

        data = max(n_devices // self.model_axis, 1)
        return make_mesh((data, self.model_axis), ("data", "model"))

    @staticmethod
    def place(arr, spec, mesh, device=None):
        """One restored whole leaf as this rank's block of it: a copy that
        holds nothing else of the leaf (a tensor moved to ``device`` when
        given; a numpy array stays on the host)."""
        import torch

        from repro_torch.sharding.rules import shard_leaf

        block = shard_leaf(arr, spec, mesh)
        if isinstance(block, torch.Tensor):
            return block.to(block.device if device is None else device, copy=True)
        return np.array(block)

    def reshard(self, state, specs, mesh, device=None):
        """A restored whole tree as this rank's blocks of it on the new
        mesh (``specs``: the tree's specs on that mesh); every leaf via
        :meth:`place`."""
        from repro_torch.core import tree as tr

        return tr.tree_map(lambda x, s: self.place(x, s, mesh, device), state, specs)


__all__ = ["ElasticMesh", "HealthMonitor", "StragglerDetector", "retry_step"]
