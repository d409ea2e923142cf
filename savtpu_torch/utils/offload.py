"""Threaded device-to-host copies of recorded trajectories (port of
``savtpu/utils/offload.py``: ``fetch_into``, ``fetch``).

``fetch_into`` copies a tensor straight into its host destination (an
array, a strided view or a memmap region; no temporary host buffer). A
copy of at least two 16 MiB chunks is split into up to 4 leading-axis
chunks copied from a persistent thread pool; a smaller one is one copy.
It serves ``ShardedSolver.run_streamed``'s chunks and stage 4's
trajectory segments, as in the JAX package. chip_smoke.py's phase 4
times it against one direct copy and a bulk ``.cpu()`` at the slice's
trajectory and at its full-depth size. The copies are exact.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_POOL: ThreadPoolExecutor | None = None
_THREADS = 4
# below two chunks of this size one copy is faster than a split one
_MIN_CHUNK_BYTES = 16 << 20


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=_THREADS,
                                   thread_name_prefix="savtpu-d2h")
    return _POOL


def fetch_into(dst, src) -> None:
    """Copy tensor (or ndarray) ``src`` into the host ndarray ``dst`` of
    the same shape, chunked along axis 0 across the pool's threads.
    ``dst`` may be an array, a view or a memmap region: the workers write
    disjoint leading-axis chunks. A numpy ``src`` is assigned as is."""
    if isinstance(src, np.ndarray):
        dst[...] = src
        return
    out = torch.from_numpy(dst)
    n = src.shape[0] if src.ndim else 0
    nbytes = src.element_size() * src.numel()
    k = min(_THREADS, n, max(1, nbytes // _MIN_CHUNK_BYTES))
    if k <= 1:
        out.copy_(src)
        return
    bounds = np.linspace(0, n, k + 1).astype(int)

    def copy(i: int) -> None:
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        out[lo:hi].copy_(src[lo:hi])

    # list() re-raises any worker's exception
    list(_pool().map(copy, range(k)))


def fetch(src) -> np.ndarray:
    """The threaded-chunk counterpart of ``src.cpu().numpy()``."""
    if isinstance(src, np.ndarray):
        return src
    out = np.empty(tuple(src.shape),
                   torch.empty((), dtype=src.dtype).numpy().dtype)
    fetch_into(out, src)
    return out
