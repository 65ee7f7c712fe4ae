"""Optimizers, schedules, clipping, gradient compression."""

from repro_torch.optim.adamw import (
    Optimizer,
    OptimConfig,
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    constant_lr,
    global_norm,
    state_specs,
    warmup_cosine,
)
from repro_torch.optim import compress

__all__ = [
    "Optimizer",
    "OptimConfig",
    "adafactor",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "constant_lr",
    "global_norm",
    "state_specs",
    "warmup_cosine",
    "compress",
]
