"""Structured tetrahedral beam generator (NumPy copy of
``savtpu/mesh/generator.py``: ``beam_mesh`` and its boundary-facet scan).

Produces refined cantilever beams (6 Kuhn tets per hex cell) with boundary
triangles, so the Dirichlet facet scan has the same inputs as on a gmsh
mesh.
"""

from __future__ import annotations

import numpy as np

from .vtk_io import Mesh

# Kuhn decomposition of the unit cube into 6 tets sharing the (0,0,0)-(1,1,1)
# diagonal. All tets positively oriented (det > 0).
_HEX_TO_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 7, 5],
        [0, 5, 7, 4],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
    ],
    dtype=np.int32,
)

# local hex corner offsets (i, j, k) for corners 0..7
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [0, 1, 0],
        [1, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [0, 1, 1],
        [1, 1, 1],
    ],
    dtype=np.int64,
)


def beam_mesh(
    nx: int = 25,
    ny: int = 1,
    nz: int = 1,
    extent: tuple = (25.0, 1.0, 1.0),
) -> Mesh:
    """Structured tet mesh of the [0,Lx]x[0,Ly]x[0,Lz] beam.

    Returns a Mesh with 'tetra' cells and boundary 'triangle' facets
    (each exterior quad split into 2 triangles, consistent with the tet
    faces on that quad).
    """
    Lx, Ly, Lz = extent
    xs = np.linspace(0.0, Lx, nx + 1)
    ys = np.linspace(0.0, Ly, ny + 1)
    zs = np.linspace(0.0, Lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    base = np.stack([I.ravel(), J.ravel(), K.ravel()], axis=1)  # (H,3)
    corners = nid(
        base[:, None, 0] + _CORNERS[None, :, 0],
        base[:, None, 1] + _CORNERS[None, :, 1],
        base[:, None, 2] + _CORNERS[None, :, 2],
    )  # (H, 8)
    tets = corners[:, _HEX_TO_TETS].reshape(-1, 4).astype(np.int32)

    tris = _boundary_triangles(tets)
    return Mesh(points=points, cells={"tetra": tets, "triangle": tris})


def _boundary_triangles(tets: np.ndarray) -> np.ndarray:
    """Extract boundary faces: tet faces appearing exactly once."""
    faces = np.concatenate(
        [
            tets[:, [0, 2, 1]],
            tets[:, [0, 1, 3]],
            tets[:, [0, 3, 2]],
            tets[:, [1, 2, 3]],
        ]
    )
    key = np.sort(faces, axis=1)
    _, idx, counts = np.unique(
        key, axis=0, return_index=True, return_counts=True
    )
    return faces[idx[counts == 1]].astype(np.int32)
