"""Tetrahedral mesh generators (NumPy copy of ``savtpu/mesh/generator.py``:
``beam_mesh``, ``tube_mesh``, ``irregular_beam_mesh``, the boundary-facet
scan and ``to_p2``).

Refined cantilever beams and annular tubes (6 Kuhn tets per hex cell) and
irregular Delaunay beams, each with its boundary triangles, so the
Dirichlet facet scan has the same inputs as on a gmsh mesh.
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


def tube_mesh(
    n_r: int = 2,
    n_theta: int = 16,
    n_z: int = 20,
    r_inner: float = 0.5,
    r_outer: float = 1.0,
    length: float = 5.0,
) -> Mesh:
    """Structured tet mesh of an annular tube (a coronary-vessel stand-in,
    the reference's target geometry class). Cylindrical product grid
    (n_r x n_theta x n_z hex cells, periodic in theta), each hex split by
    the same Kuhn pattern as :func:`beam_mesh` — the pattern is
    translation-invariant in index space, so the split is conforming
    across the periodic seam. Clamped-face detection: the z=0 end cap
    (``dirichlet_axis=2``).
    """
    rs = np.linspace(r_inner, r_outer, n_r + 1)
    ts = np.arange(n_theta) * (2.0 * np.pi / n_theta)
    zs = np.linspace(0.0, length, n_z + 1)
    R, T, Z = np.meshgrid(rs, ts, zs, indexing="ij")
    points = np.stack(
        [(R * np.cos(T)).ravel(), (R * np.sin(T)).ravel(), Z.ravel()], axis=1
    )

    def nid(i, j, k):  # theta wraps
        return (i * n_theta + (j % n_theta)) * (n_z + 1) + k

    I, J, K = np.meshgrid(
        np.arange(n_r), np.arange(n_theta), np.arange(n_z), indexing="ij"
    )
    base = np.stack([I.ravel(), J.ravel(), K.ravel()], axis=1)
    corners = nid(
        base[:, None, 0] + _CORNERS[None, :, 0],
        base[:, None, 1] + _CORNERS[None, :, 1],
        base[:, None, 2] + _CORNERS[None, :, 2],
    )
    tets = corners[:, _HEX_TO_TETS].reshape(-1, 4).astype(np.int32)
    # the (r, theta, z) frame is right-handed and the cylindrical map has
    # det = r > 0, so every Kuhn tet stays positively oriented; verify.
    P = points[tets]
    vol6 = np.einsum(
        "ei,ei->e",
        np.cross(P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]),
        P[:, 3] - P[:, 0],
    )
    assert (vol6 > 0).all(), "tube generator produced inverted tets"

    tris = _boundary_triangles(tets)
    return Mesh(points=points, cells={"tetra": tets, "triangle": tris})


def irregular_beam_mesh(
    nx: int = 25,
    ny: int = 4,
    nz: int = 4,
    extent: tuple = (25.0, 1.0, 1.0),
    jitter: float = 0.25,
    grade: float = 1.5,
    seed: int = 0,
) -> Mesh:
    """Irregular tet mesh of the cantilever beam: graded, jittered points
    and a 3D Delaunay triangulation (gmsh-style unstructured output
    without gmsh, the reference's natural input class).

    ``grade`` > 1 refines toward the clamped x=0 face (node spacing grows
    as a power law along x, like a gmsh size field); ``jitter`` displaces
    INTERIOR points by up to ``jitter``x the local spacing in all three
    axes (boundary points stay exactly on their faces so the clamped-face
    Dirichlet scan and the hull stay clean). The resulting connectivity
    is a true Delaunay tetrahedralization — irregular node valences, no
    logical grid — so ``parallel.stencil.detect_box_partition`` cannot
    fire and the solver exercises its unstructured paths. Tets are
    re-oriented to positive volume (scipy gives arbitrary orientation).
    """
    from scipy.spatial import Delaunay

    Lx, Ly, Lz = extent
    # graded x-abscissae: x_i = Lx * (i/nx)^grade, finest at the clamp
    xs = Lx * (np.arange(nx + 1) / nx) ** grade
    ys = np.linspace(0.0, Ly, ny + 1)
    zs = np.linspace(0.0, Lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    rng = np.random.default_rng(seed)
    # local spacing per point (forward-difference of the graded axis)
    dx = np.diff(xs, append=xs[-1] + (xs[-1] - xs[-2]))
    hx = dx[np.minimum(np.searchsorted(xs, pts[:, 0]), nx)]
    hy, hz = Ly / ny, Lz / nz
    h = np.stack([hx, np.full(len(pts), hy), np.full(len(pts), hz)], 1)
    interior = (
        (pts[:, 0] > 0) & (pts[:, 0] < Lx)
        & (pts[:, 1] > 0) & (pts[:, 1] < Ly)
        & (pts[:, 2] > 0) & (pts[:, 2] < Lz)
    )
    pts = pts + np.where(
        interior[:, None],
        rng.uniform(-jitter, jitter, pts.shape) * h,
        0.0,
    )

    tets = Delaunay(pts).simplices.astype(np.int32)
    P = pts[tets]
    vol6 = np.einsum(
        "ei,ei->e",
        np.cross(P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]),
        P[:, 3] - P[:, 0],
    )
    flip = vol6 < 0
    tets[flip] = tets[flip][:, [0, 2, 1, 3]]
    # drop exactly-degenerate hull slivers (coplanar lattice points on
    # the unjittered faces can tie in the Delaunay triangulation)
    vol6 = np.abs(vol6)
    keep = vol6 > 1e-12 * np.median(vol6)
    tets = tets[keep]

    tris = _boundary_triangles(tets)
    return Mesh(points=pts, cells={"tetra": tets, "triangle": tris})




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


# P2 edge order: the midpoint of edge k is local node 4 + k
_P2_EDGES = np.array([(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)])


def to_p2(mesh: Mesh) -> Mesh:
    """Promote a P1 tet mesh to P2 (10-node tets) by inserting edge
    midpoints. Per element: the 4 vertices, then the midpoints of edges
    (0,1), (1,2), (0,2), (0,3), (1,3), (2,3) (the basis order of
    ``ops.shape.shape_function(2, .)`` and gmsh's tet10). Midpoint nodes
    are numbered from ``len(points)`` in the order their edge is first
    met, element by element and edge by edge, as the JAX package does.
    The boundary triangles stay the corner facets."""
    tets = np.asarray(mesh.tetra, dtype=np.int64)
    points = mesh.points
    n0 = len(points)
    a = tets[:, _P2_EDGES[:, 0]].reshape(-1)
    b = tets[:, _P2_EDGES[:, 1]].reshape(-1)
    key = np.minimum(a, b) * n0 + np.maximum(a, b)
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    order = np.sort(first)
    mid_points = 0.5 * (points[a[order]] + points[b[order]])
    tet10 = np.empty((len(tets), 10), dtype=np.int32)
    tet10[:, :4] = tets
    tet10[:, 4:] = (n0 + rank[inv.reshape(-1)]).reshape(len(tets), 6)
    cells = {"tetra10": tet10}
    if mesh.triangles is not None:
        cells["triangle"] = mesh.triangles
    return Mesh(points=np.vstack([points, mid_points]), cells=cells)
