"""Mesh geometry utilities: CFL mesh size, time step, Dirichlet detection.

Reproduces the reference's math exactly:

- ``min_mesh_size``: h = 2*min(min edge per tet)/sqrt(24) — the inscribed-
  sphere estimate (Tools/commons.py:79-90), vectorized over all elements.
- ``cfl_dt``: dt = gamma*h/sqrt(E/rho/(1-nu^2)) (Data_prepare.py:147).
- ``dirichlet_nodes``: nodes of boundary triangles whose 3 vertices lie on
  the clamped plane |x - value| < tol (Data_prepare.py:127-136).
"""

from __future__ import annotations

import numpy as np

_EDGES = [(0, 1), (1, 2), (2, 3), (1, 3), (0, 3), (0, 2)]


def min_mesh_size(tets: np.ndarray, points: np.ndarray) -> float:
    P = points[tets[:, :4]]  # (E, 4, 3)
    edge_len = np.stack(
        [np.linalg.norm(P[:, a] - P[:, b], axis=1) for a, b in _EDGES], axis=1
    )
    return 2.0 * float(edge_len.min()) / np.sqrt(24.0)


def cfl_dt(
    tets: np.ndarray,
    points: np.ndarray,
    E: float,
    rho: float,
    nu: float,
    gamma: float = 0.9,
) -> float:
    h = min_mesh_size(tets, points)
    return gamma * h / np.sqrt(E / rho / (1.0 - nu**2))


def dirichlet_nodes(
    facets: np.ndarray,
    points: np.ndarray,
    axis: int = 0,
    value: float = 0.0,
    tol: float = 1e-9,
) -> np.ndarray:
    """Global node ids on the clamped face, in facet-scan first-appearance
    order (matching the reference's list-append dedup at
    Data_prepare.py:129-136)."""
    on_plane = np.abs(points[facets, axis] - value) < tol  # (F, 3)
    clamped = facets[np.all(on_plane, axis=1)]
    seen: dict = {}
    for f in clamped:
        for n in f:
            seen.setdefault(int(n), None)
    return np.array(list(seen.keys()), dtype=np.int64)


def node_to_dof(nodes: np.ndarray, ndim: int = 3) -> np.ndarray:
    """Interleaved DOF ids for nodes: dof = ndim*node + component
    (Tools/commons.py:66-71), all components."""
    nodes = np.asarray(nodes, dtype=np.int64)
    return (ndim * nodes[:, None] + np.arange(ndim)[None, :]).reshape(-1)
