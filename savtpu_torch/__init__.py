"""savtpu_torch — the PyTorch/CUDA port of savtpu, the
synchronization-avoiding distributed explicit FEM pipeline.

It runs the same five stages (exchanged solve, shared-trace extraction,
per-shard surrogate fitting, the sync-avoiding online run, comparison) on
one NVIDIA GPU, from the same JSON config as the JAX package. Plain tensor
code is PyTorch; the TPU's Pallas kernels become hand-written CUDA
kernels under ``csrc/``, built with nvcc at first use. The package
imports neither JAX nor savtpu.

Layout mirrors savtpu: ``config``, ``mesh``, ``parallel``, ``ops``,
``solvers``, ``models``, ``io``, ``pipeline``, ``api``; ``convert``
carries a savtpu run's state over.
"""

__version__ = "0.1.0"
