"""Architecture registry: ``--arch <id>`` resolves here (the reference's
ten: dense, MoE, SSM, hybrid, encoder and VLM)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell, cell_applicable

_MODULES = {
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
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


def all_cells():
    """Every (arch, shape) cell with its applicability verdict:
    ``[(arch, shape name, applies, reason)]``."""
    out = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = cell_applicable(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out


__all__ = [
    "ARCH_NAMES",
    "SHAPES",
    "ModelConfig",
    "ShapeCell",
    "all_cells",
    "cell_applicable",
    "get_config",
    "get_reduced",
]
