"""Batched element kernels: per-element mass, stiffness and force (port
of ``savtpu/ops/element.py`` for P1 and P2 tets).

The JAX package writes one element and ``vmap``s it; here the element
axis is the leading batch dimension of every tensor. The integrals are
identical: K_e = sum_q B^T D B detJ w_q, M_e = sum_q rho N_i N_j detJ w_q
(x I3), F_e = sum_q N_i f(X_q, t) detJ w_q.
"""

from __future__ import annotations

import numpy as np
import torch

from .quadrature import tet_quadrature
from .shape import jacobian, n_basis, shape_derivative, shape_function


def det3(J: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    return (
        J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
        - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
        + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
    )


def inv3(J: torch.Tensor, detJ: torch.Tensor | None = None) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) via the adjugate."""
    if detJ is None:
        detJ = det3(J)
    a = lambda i, j: J[..., i, j]  # noqa: E731
    adj = torch.stack(
        [
            torch.stack([
                a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1),
                a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
                a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1),
            ], dim=-1),
            torch.stack([
                a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2),
                a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
                a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2),
            ], dim=-1),
            torch.stack([
                a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0),
                a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
                a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0),
            ], dim=-1),
        ],
        dim=-2,
    )
    return adj / detJ[..., None, None]


def strain_displacement(G: torch.Tensor) -> torch.Tensor:
    """Voigt strain-displacement matrices B (E, 6, 3*nb) from physical
    gradients G (E, nb, 3); ordering (xx, yy, zz, yz, zx, xy)."""
    Z = torch.zeros_like(G[..., 0])
    gx, gy, gz = G[..., 0], G[..., 1], G[..., 2]
    Ba = torch.stack(
        [
            torch.stack([gx, Z, Z], dim=-1),
            torch.stack([Z, gy, Z], dim=-1),
            torch.stack([Z, Z, gz], dim=-1),
            torch.stack([Z, gz, gy], dim=-1),
            torch.stack([gz, Z, gx], dim=-1),
            torch.stack([gy, gx, Z], dim=-1),
        ],
        dim=-2,
    )  # (E, nb, 6, 3)
    E, nb = G.shape[0], G.shape[1]
    return Ba.permute(0, 2, 1, 3).reshape(E, 6, 3 * nb)


def batch_element_mkf(deg: int, n_quad: int, material, t: float,
                      coords: torch.Tensor):
    """Element integrals over coords (E, nb, 3): returns
    (M (E, 3nb, 3nb), K (E, 3nb, 3nb), F (E, 3nb))."""
    nb = n_basis(deg)
    dtype, device = coords.dtype, coords.device
    nodes, weights = tet_quadrature(n_quad)
    nodes = torch.as_tensor(nodes, dtype=dtype, device=device)
    weights = torch.as_tensor(weights, dtype=dtype, device=device)
    D = material.D(dtype, device)
    f = material.body_force(t, dtype, device)
    E = coords.shape[0]
    K = torch.zeros((E, 3 * nb, 3 * nb), dtype=dtype, device=device)
    Mbar = torch.zeros((E, nb, nb), dtype=dtype, device=device)
    F = torch.zeros((E, 3 * nb), dtype=dtype, device=device)
    for q in range(nodes.shape[0]):
        xi, w = nodes[q], weights[q]
        N = shape_function(deg, xi)
        dN = shape_derivative(deg, xi)
        J = jacobian(coords, dN)  # (E, 3, 3)
        detJ = det3(J)
        G = dN @ inv3(J, detJ)  # (E, nb, 3)
        B = strain_displacement(G)
        K = K + (B.transpose(1, 2) @ D @ B) * detJ[:, None, None] * w
        Mbar = Mbar + torch.outer(N, N) * (material.rho * detJ * w)[:, None, None]
        F = F + (N[:, None] * f[None, :]).reshape(-1) * detJ[:, None] * w
    eye = torch.eye(3, dtype=dtype, device=device)
    M = (Mbar[:, :, None, :, None] * eye[None, None, :, None, :]).reshape(
        E, 3 * nb, 3 * nb
    )
    return M, K, F


def batch_element_k(deg: int, n_quad: int, material,
                    coords: torch.Tensor) -> torch.Tensor:
    """Stiffness only over coords (E, nb, 3): (E, 3nb, 3nb)."""
    nb = n_basis(deg)
    dtype, device = coords.dtype, coords.device
    nodes, weights = tet_quadrature(n_quad)
    nodes = torch.as_tensor(nodes, dtype=dtype, device=device)
    weights = torch.as_tensor(weights, dtype=dtype, device=device)
    D = material.D(dtype, device)
    E = coords.shape[0]
    K = torch.zeros((E, 3 * nb, 3 * nb), dtype=dtype, device=device)
    for q in range(nodes.shape[0]):
        dN = shape_derivative(deg, nodes[q])
        J = jacobian(coords, dN)
        detJ = det3(J)
        B = strain_displacement(dN @ inv3(J, detJ))
        K = K + (B.transpose(1, 2) @ D @ B) * detJ[:, None, None] * weights[q]
    return K


def element_mkf(deg: int, n_quad: int, material, t: float,
                P: torch.Tensor):
    """(M_e, K_e, F_e) of one element with nodal coordinates P (nb, 3):
    :func:`batch_element_mkf` on a batch of one."""
    M, K, F = batch_element_mkf(deg, n_quad, material, t, P[None])
    return M[0], K[0], F[0]


def element_k(deg: int, n_quad: int, material, P: torch.Tensor):
    """Stiffness (3nb, 3nb) of one element with nodal coordinates P
    (nb, 3)."""
    return batch_element_k(deg, n_quad, material, P[None])[0]


def neo_hookean_element_fint(material, P: torch.Tensor,
                             d_e: torch.Tensor) -> torch.Tensor:
    """Internal forces (E, 3nb) of P1 tets under Neo-Hookean stress: the
    readable per-element twin of the stepper's structure-of-arrays
    forces. P (E, 4, 3) reference coordinates, d_e (E, 12) nodal
    displacements.

    P1 shape gradients are constant, so the integrand (deformation
    gradient, first Piola stress) is constant over the element: one
    evaluation times the total quadrature weight."""
    dtype, device = P.dtype, P.device
    nodes, weights = tet_quadrature(2)
    xi = torch.as_tensor(nodes[0], dtype=dtype, device=device)
    u = d_e.reshape(-1, 4, 3)
    dN = shape_derivative(1, xi)
    J = jacobian(P, dN)                             # (E, 3, 3)
    detJ = det3(J)
    G = dN @ inv3(J, detJ)                          # (E, 4, 3) physical
    Fdef = torch.eye(3, dtype=dtype, device=device) + u.transpose(1, 2) @ G
    Pstress = material.first_piola(Fdef)
    # f_a[i] = P[i, j] G[a, j] * detJ * sum(w)
    return ((G @ Pstress.transpose(1, 2)).reshape(-1, 12)
            * (detJ * float(np.sum(weights)))[:, None])


def gather_coords(cells: np.ndarray, points: np.ndarray,
                  dtype=torch.float64) -> torch.Tensor:
    """(E, nb, 3) element coordinate tensor from connectivity."""
    coords = np.asarray(points)[np.asarray(cells)]
    return torch.as_tensor(coords, dtype=dtype)
