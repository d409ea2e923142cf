"""P1/P2 tetrahedral shape functions and parametric derivatives (port of
``savtpu/ops/shape.py``; P2 runs the steady-only path, as there).

Jacobian convention as in the JAX package: J[i, j] = sum_a dN_a/dxi_j *
x_a[i], i.e. J = P^T @ dN for nodal coordinates P (nb, 3). P2 nodes are
the 4 vertices, then the midpoints of edges (0,1), (1,2), (0,2), (0,3),
(1,3), (2,3) (``mesh.generator.to_p2``, gmsh tet10).
"""

from __future__ import annotations

import torch


def shape_function(deg: int, xi: torch.Tensor) -> torch.Tensor:
    """Basis values at parametric point xi (3,). Returns (nb,)."""
    x, y, z = xi[0], xi[1], xi[2]
    if deg == 1:
        return torch.stack([1.0 - x - y - z, x, y, z])
    if deg == 2:
        w = 1.0 - x - y - z
        return torch.stack([
            w * (2.0 * w - 1.0),
            x * (2.0 * x - 1.0),
            y * (2.0 * y - 1.0),
            z * (2.0 * z - 1.0),
            4.0 * x * w,
            4.0 * x * y,
            4.0 * y * w,
            4.0 * z * w,
            4.0 * x * z,
            4.0 * y * z,
        ])
    raise ValueError(f"unsupported polynomial degree {deg}")


def shape_derivative(deg: int, xi: torch.Tensor) -> torch.Tensor:
    """Parametric gradients dN/dxi at xi. Returns (nb, 3)."""
    if deg == 1:
        return torch.tensor(
            [
                [-1.0, -1.0, -1.0],
                [1.0, 0.0, 0.0],
                [0.0, 1.0, 0.0],
                [0.0, 0.0, 1.0],
            ],
            dtype=xi.dtype,
            device=xi.device,
        )
    if deg == 2:
        x, y, z = xi[0], xi[1], xi[2]
        g = -3.0 + 4.0 * (x + y + z)
        zero = torch.zeros_like(x)
        rows = [
            [g, g, g],
            [4.0 * x - 1.0, zero, zero],
            [zero, 4.0 * y - 1.0, zero],
            [zero, zero, 4.0 * z - 1.0],
            [4.0 - 8.0 * x - 4.0 * y - 4.0 * z, -4.0 * x, -4.0 * x],
            [4.0 * y, 4.0 * x, zero],
            [-4.0 * y, 4.0 - 4.0 * x - 8.0 * y - 4.0 * z, -4.0 * y],
            [-4.0 * z, -4.0 * z, 4.0 - 4.0 * x - 4.0 * y - 8.0 * z],
            [4.0 * z, zero, 4.0 * x],
            [zero, 4.0 * z, 4.0 * y],
        ]
        return torch.stack([torch.stack(r) for r in rows])
    raise ValueError(f"unsupported polynomial degree {deg}")


def jacobian(P: torch.Tensor, dN: torch.Tensor) -> torch.Tensor:
    """Isoparametric Jacobian J = P^T dN (..., 3, 3) of nodal coordinates
    P (..., nb, 3) and parametric derivatives dN (nb, 3)."""
    return P.transpose(-1, -2) @ dN


def isoparametric_map(P: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """Physical coordinates (..., 3) of a parametric point with shape
    values N (nb,): X_i = sum_a P[..., a, i] N_a."""
    return P.transpose(-1, -2) @ N


def n_basis(deg: int) -> int:
    return {1: 4, 2: 10}[deg]
