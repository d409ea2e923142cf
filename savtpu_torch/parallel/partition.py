"""Mesh partitioning (host-side, setup-time; NumPy copy of
``savtpu/parallel/partition.py``).

``rcb`` (recursive coordinate bisection on element centroids, the
default) and ``slab`` are carried over. The native C++ graph partitioner
(``graph``) and the structured ``box`` grid wait for a later slice.

Returns ``epart``: (E,) int array of element -> part assignments, the
same contract as ParMETIS' output.
"""

from __future__ import annotations

import numpy as np


def partition_elements(
    cells: np.ndarray,
    points: np.ndarray,
    n_parts: int,
    method: str = "rcb",
) -> np.ndarray:
    if n_parts <= 1:
        return np.zeros(len(cells), dtype=np.int64)
    centroids = points[np.asarray(cells)[:, :4]].mean(axis=1)
    if method == "rcb":
        epart = np.zeros(len(cells), dtype=np.int64)
        _rcb(np.arange(len(cells)), centroids, 0, n_parts, epart)
        return epart
    if method == "slab":
        axis = int(np.argmax(points.max(0) - points.min(0)))
        order = np.argsort(centroids[:, axis], kind="stable")
        epart = np.zeros(len(cells), dtype=np.int64)
        for p, chunk in enumerate(np.array_split(order, n_parts)):
            epart[chunk] = p
        return epart
    if method in ("graph", "box"):
        raise NotImplementedError(
            f"partition method {method!r} is not ported yet; use 'rcb' "
            "or 'slab'"
        )
    raise ValueError(f"unknown partition method {method!r}")


def _rcb(idx, centroids, base, k, epart):
    """Recursive coordinate bisection: split along the widest centroid axis
    into contiguous halves proportional to the sub-part counts."""
    if k == 1:
        epart[idx] = base
        return
    k1 = k // 2
    c = centroids[idx]
    axis = int(np.argmax(c.max(0) - c.min(0)))
    order = np.argsort(c[:, axis], kind="stable")
    cut = int(round(len(idx) * k1 / k))
    _rcb(idx[order[:cut]], centroids, base, k1, epart)
    _rcb(idx[order[cut:]], centroids, base + k1, k - k1, epart)
