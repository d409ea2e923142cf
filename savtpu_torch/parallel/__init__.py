from .halo import (
    NeighborExchange,
    PartitionMaps,
    build_neighbor_exchange,
    build_partition_maps,
    rcm_reorder_maps,
)
from .partition import partition_elements
from .sharded import ShardedProblem, ShardedSolver, make_device_mesh

__all__ = [
    "NeighborExchange",
    "PartitionMaps",
    "build_neighbor_exchange",
    "build_partition_maps",
    "rcm_reorder_maps",
    "partition_elements",
    "ShardedProblem",
    "ShardedSolver",
    "make_device_mesh",
]
