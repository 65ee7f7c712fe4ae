"""Models: config, parameters, quantization, KV cache, transformer."""

from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell, cell_applicable

__all__ = ["SHAPES", "ModelConfig", "ShapeCell", "cell_applicable"]
