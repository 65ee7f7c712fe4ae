"""Deterministic, sharded, resumable data pipeline.

Every batch is a pure function of (seed, step, dp_rank) — the property
that makes checkpoint/restart and elastic re-sharding exact: a restored
run at step S on a *different* data-parallel width consumes precisely the
token stream it would have seen, because ranks index into a global
sample space rather than holding local iterator state.

Sources:
  * ``synthetic`` — seeded Zipf-ish token stream (tests, dry-runs, the
    end-to-end example);
  * ``memmap``    — fixed-window sampling from a flat binary token file
    (np.memmap; the production path for a tokenized corpus).

Prefetching: a small background thread keeps ``prefetch`` batches ahead
on the host.

Numpy only, the reference's code: the same (seed, step, sample) gives
the same token arrays in both packages. The trainer moves a batch to
the device itself.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | memmap
    path: Optional[str] = None  # token file for memmap
    dtype: str = "int32"


class DataPipeline:
    """Stateless-by-step pipeline: ``batch_at(step)`` is deterministic."""

    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1):
        if cfg.global_batch % dp_size:
            raise ValueError(
                f"global_batch {cfg.global_batch} must divide dp_size {dp_size}"
            )
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.local_batch = cfg.global_batch // dp_size
        self._tokens = None
        if cfg.source == "memmap":
            if not cfg.path:
                raise ValueError("memmap source needs cfg.path")
            self._tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")
            if len(self._tokens) < cfg.seq_len + 2:
                raise ValueError("corpus smaller than one sample")

    # -- deterministic access ------------------------------------------------

    def _sample_rng(self, step: int, sample: int) -> np.random.Generator:
        # independent stream per (seed, step, global sample index)
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, sample])
        )

    def _synthetic_sample(self, step: int, sample: int) -> np.ndarray:
        rng = self._sample_rng(step, sample)
        v = self.cfg.vocab_size
        # Zipf-flavoured ids clipped to the vocab: closer to text statistics
        # than uniform, cheap to generate.
        z = rng.zipf(1.3, size=self.cfg.seq_len + 1).astype(np.int64)
        return (z % v).astype(np.int32)

    def _memmap_sample(self, step: int, sample: int) -> np.ndarray:
        rng = self._sample_rng(step, sample)
        hi = len(self._tokens) - self.cfg.seq_len - 1
        start = int(rng.integers(0, hi))
        window = np.asarray(
            self._tokens[start : start + self.cfg.seq_len + 1], dtype=np.int32
        )
        return window % self.cfg.vocab_size

    def batch_at(self, step: int) -> dict:
        """Local shard of the global batch for ``step``: tokens + targets."""
        sample_fn = (
            self._memmap_sample if self.cfg.source == "memmap" else self._synthetic_sample
        )
        first = self.dp_rank * self.local_batch
        rows = [sample_fn(step, first + i) for i in range(self.local_batch)]
        arr = np.stack(rows)  # (local_batch, seq+1)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}

    # -- iteration + prefetch -------------------------------------------------

    def iterate(self, start_step: int = 0, prefetch: int = 2) -> Iterator[dict]:
        """Resumable iterator: pass the restored step to continue exactly."""
        if prefetch <= 0:
            step = start_step
            while True:
                yield self.batch_at(step)
                step += 1

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Helper for tests/examples: persist a uint16 token corpus."""
    np.asarray(tokens, dtype=np.uint16).tofile(path)
