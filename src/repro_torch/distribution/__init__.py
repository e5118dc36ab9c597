"""Distribution layer of the port: mesh axes, sharding rules, gradient
compression.

Parallelism map (as the JAX package's):
  DP    batch over ("pod", "data")
  FSDP  parameters + optimizer state sharded over "data" (ZeRO-ish)
  TP    head/FFN dims over "model" (Megatron column/row)
  EP    MoE experts over "model" (fallback: expert-internal TP)
  SP    long-context KV/state over "data" when batch=1

The rules give each tensor a ``PartitionSpec``; ``to_placements`` makes
DTensor placements of one on a ``DeviceMesh``.  The port trains and
serves on one card; the dry-run (``repro_torch.launch.dryrun``) plans
the production meshes with these rules.
"""
from repro_torch.distribution.sharding import (
    DEFAULT_RULES,
    FSDP_RULES,
    RULE_PROFILES,
    PartitionSpec,
    ShardingRules,
    batch_shardings,
    constrain,
    param_shardings,
    state_shardings,
    to_placements,
)
from repro_torch.distribution.compression import (
    CompressionState,
    compress_decompress,
    init_compression,
)

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "FSDP_RULES",
    "RULE_PROFILES",
    "PartitionSpec",
    "param_shardings",
    "batch_shardings",
    "state_shardings",
    "to_placements",
    "constrain",
    "CompressionState",
    "init_compression",
    "compress_decompress",
]
