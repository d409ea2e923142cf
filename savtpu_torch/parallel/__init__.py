from .halo import PartitionMaps, build_partition_maps, rcm_reorder_maps
from .partition import partition_elements
from .sharded import ShardedProblem, ShardedSolver

__all__ = [
    "PartitionMaps",
    "build_partition_maps",
    "rcm_reorder_maps",
    "partition_elements",
    "ShardedProblem",
    "ShardedSolver",
]
