"""Fused protocol steps and their mesh-sharded forms over torch.distributed
(one process a device; `launch` starts the ranks)."""

from .launch import launch
from .step import (
    Mesh,
    batch_sharding,
    beaver_mul_step,
    flagship_forward,
    gather,
    mac_check_fold,
    make_mesh,
    replicate,
    shard,
    shard_share,
    sharded_mul_mac_step,
    sharded_point_sum,
    sharded_rlc_fold,
    sharded_sum,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "beaver_mul_step",
    "flagship_forward",
    "gather",
    "launch",
    "mac_check_fold",
    "make_mesh",
    "replicate",
    "shard",
    "shard_share",
    "sharded_mul_mac_step",
    "sharded_point_sum",
    "sharded_rlc_fold",
    "sharded_sum",
]
