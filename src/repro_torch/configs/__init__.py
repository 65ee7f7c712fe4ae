"""Architecture registry: ``--arch <id>`` resolves here (dense configs
ported so far)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "yi-6b": "repro_torch.configs.yi_6b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name]).REDUCED


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "get_reduced"]
