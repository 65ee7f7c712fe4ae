"""Deterministic sharded data pipeline."""

from repro_torch.data.pipeline import DataConfig, DataPipeline, write_token_file

__all__ = ["DataConfig", "DataPipeline", "write_token_file"]
