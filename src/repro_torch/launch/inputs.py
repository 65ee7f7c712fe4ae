"""Model inputs: the shapes and dtypes of one step's batch (a dry-run cell's
as meta tensors: no memory), and concrete random batches from a numpy
generator (the same values as the reference's ``make_batch`` from the
same generator).

The audio and vision front ends take precomputed features: the encoder's
batch holds frame ``features``, the VLM's image ``patches`` beside the
text ``tokens``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig, ShapeCell


def batch_struct(cfg: ModelConfig, batch: int, seq: int, kind: str) -> dict:
    """``{name: (shape, dtype)}`` of one step's inputs. ``kind``: train
    (inputs and targets), prefill (inputs), decode (one token). A VLM's
    ``seq`` counts its ``num_patches`` patches."""
    i32, f32 = torch.int32, torch.float32
    if kind == "decode":
        return {"tokens": ((batch, 1), i32)}
    if cfg.frontend == "audio":
        out = {"features": ((batch, seq, cfg.frontend_dim), f32)}
        if kind == "train":
            out["targets"] = ((batch, seq), i32)
        return out
    if cfg.frontend == "vision":
        s_text = seq - cfg.num_patches
        out = {"tokens": ((batch, s_text), i32),
               "patches": ((batch, cfg.num_patches, cfg.frontend_dim), f32)}
        if kind == "train":
            out["targets"] = ((batch, s_text), i32)
        return out
    out = {"tokens": ((batch, seq), i32)}
    if kind == "train":
        out["targets"] = ((batch, seq), i32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCell, meta: bool = False) -> dict:
    """The cell's inputs: ``{name: (shape, dtype)}`` (the reference's
    ``ShapeDtypeStruct`` s), or with ``meta`` tensors of those shapes on
    the meta device (the dry run's; nothing is allocated)."""
    specs = batch_struct(cfg, shape.global_batch, shape.seq_len, shape.kind)
    if not meta:
        return specs
    return {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in specs.items()}


def make_batch(cfg: ModelConfig, batch: int, seq: int, kind: str = "train",
               rng: Optional[np.random.Generator] = None, device=None) -> dict:
    """A random batch of :func:`batch_struct`'s shapes on ``device`` (None:
    the GPU; pass ``"cpu"`` for the host): integers uniform in ``[0,
    vocab_size)``, features standard normal, drawn from ``rng`` (default
    seed 0) in the order of the struct's keys."""
    from repro_torch.launch.serve import resolve_device

    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    out = {}
    for name, (shape, dtype) in batch_struct(cfg, batch, seq, kind).items():
        if dtype.is_floating_point:
            a = rng.standard_normal(shape).astype(np.float32)
        else:
            a = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        out[name] = torch.from_numpy(a).to(device)
    return out
