"""Distributed plane: ranks, their devices, barriers and sums."""

from .mesh import (
    all_reduce_sum,
    barrier,
    check_world,
    initialize_distributed,
    joined,
    launch,
    launched_world,
    local_device,
    process_shard_info,
    shutdown,
)

__all__ = [
    "all_reduce_sum",
    "barrier",
    "check_world",
    "initialize_distributed",
    "joined",
    "launch",
    "launched_world",
    "local_device",
    "process_shard_info",
    "shutdown",
]
