"""Benchmarks of the port (``sweep``: the scale-out throughput sweep)."""
