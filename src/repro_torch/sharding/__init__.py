"""Tensor-parallel serving: the Megatron split of the quantized plane tree
over ``torch.distributed`` ranks (``sharding/tp.py``)."""

from repro_torch.sharding.tp import (
    COL_PARALLEL,
    ROW_PARALLEL,
    VOCAB_PARALLEL,
    RankTuner,
    TPContext,
    current_tp,
    load_shard,
    plane_cache_device_bytes,
    shard_quantized,
    shard_quantized_all,
    shard_source,
    tp_role,
)

__all__ = [
    "COL_PARALLEL",
    "ROW_PARALLEL",
    "VOCAB_PARALLEL",
    "RankTuner",
    "TPContext",
    "current_tp",
    "load_shard",
    "plane_cache_device_bytes",
    "shard_quantized",
    "shard_quantized_all",
    "shard_source",
    "tp_role",
]
