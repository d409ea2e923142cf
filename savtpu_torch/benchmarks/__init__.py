"""Benchmarks of the port (``sweep``: the scale-out throughput sweep;
``bench``, ``train_bench``, ``partition_quality``)."""

from pathlib import Path

# The reference repository's unstructured beam (110 nodes / 256 tets), at
# the path where the JAX package's bench.py, benchmarks/sweep.py and
# benchmarks/partition_quality.py look for it. ``bench``, ``sweep`` and
# ``partition_quality`` read it, as those do, only where it exists.
REF_MESH = Path("/root/reference/Mesh_info/beam_coarse.vtk")
