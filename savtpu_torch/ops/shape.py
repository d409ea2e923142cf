"""P1 tetrahedral shape functions and parametric derivatives (port of
``savtpu/ops/shape.py``; the P2 basis is steady-only there and waits for
a later slice).

Jacobian convention as in the JAX package: J[i, j] = sum_a dN_a/dxi_j *
x_a[i], i.e. J = P^T @ dN for nodal coordinates P (nb, 3).
"""

from __future__ import annotations

import torch


def shape_function(deg: int, xi: torch.Tensor) -> torch.Tensor:
    """Basis values at parametric point xi (3,). Returns (nb,)."""
    if deg != 1:
        raise NotImplementedError("only P1 tets are ported")
    x, y, z = xi[0], xi[1], xi[2]
    return torch.stack([1.0 - x - y - z, x, y, z])


def shape_derivative(deg: int, xi: torch.Tensor) -> torch.Tensor:
    """Parametric gradients dN/dxi at xi. Returns (nb, 3)."""
    if deg != 1:
        raise NotImplementedError("only P1 tets are ported")
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


def n_basis(deg: int) -> int:
    return {1: 4, 2: 10}[deg]
