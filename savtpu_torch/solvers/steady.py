"""Steady displacement under the full (unramped) load and the unramped
load's ghost step (port of ``savtpu/solvers/steady.py``:
``steady_displacement``, ``ghost_step_init``, ``ghost_step_init_cg``).

K d = F with strong Dirichlet rows (zeroed rows/columns, unit diagonal,
zero right-hand side), solved once on the host in float64. The JAX
package uses a dense solve up to 6000 DOFs and PCG beyond; here the
assembled system goes to SciPy's sparse direct solver at every size.

The ghost step d_{-1} of an unramped load (the load is on at t = 0, so
the initial acceleration is not 0) solves the consistent mass system:
densely (``torch.linalg.solve``) up to 6144 DOFs, beyond by conjugate
gradients on element-by-element operators, with the JAX package's CG
(``jax.scipy.sparse.linalg.cg``: its update order and its stopping rule),
so both take the same iterations. Both run on the tensors' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from ..ops.assembly import (
    FIntOperator,
    assemble_dense,
    assemble_vector,
    dirichlet_mask,
)
from ..ops.element import batch_element_mkf


def steady_solve(Ke, Fe, edofs, ndof: int, dirichlet_dofs) -> np.ndarray:
    """Solve K d = F (float64, host) with homogeneous Dirichlet DOFs."""
    Ke = np.asarray(Ke, dtype=np.float64)
    Fe = np.asarray(Fe, dtype=np.float64)
    edofs = np.asarray(edofs, dtype=np.int64)
    E, nb3 = edofs.shape
    rows = np.repeat(edofs, nb3, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, nb3)).reshape(-1)
    keep = np.ones(ndof)
    d = np.asarray(dirichlet_dofs, dtype=np.int64)
    keep[d] = 0.0
    vals = Ke.reshape(-1) * keep[rows] * keep[cols]
    K = sps.coo_matrix((vals, (rows, cols)), shape=(ndof, ndof)).tocsr()
    K = K + sps.coo_matrix(
        (np.ones(len(d)), (d, d)), shape=(ndof, ndof)
    ).tocsr()
    F = np.zeros(ndof)
    np.add.at(F, edofs.reshape(-1), Fe.reshape(-1))
    F = F * keep
    return spla.spsolve(K.tocsc(), F)


def steady_displacement(prob) -> np.ndarray:
    """Steady displacement of an AssembledProblem under the unramped
    load."""
    mat = dataclasses.replace(prob.material, ramped=False)
    Fe = batch_element_mkf(prob.deg, prob.n_quad, mat, 0.0, prob.coords)[2]
    return steady_solve(
        prob.Ke.to(torch.float64).numpy(), Fe.to(torch.float64).numpy(),
        prob.edofs, prob.ndof, prob.dirichlet_dofs,
    )


def ghost_step_init(Me, Ke, Fe_t0, edofs, ndof: int, dirichlet_dofs, d0, v0,
                    dt: float) -> torch.Tensor:
    """d_{-1} = d0 - dt v0 + dt^2/2 a0 with a0 = M^-1 (F(0) - K d0): M
    consistent with the Dirichlet rows and columns zeroed and a unit
    diagonal there, K with them zeroed, F(0) with the Dirichlet rows
    zeroed; one dense solve."""
    M = assemble_dense(Me, edofs, ndof)
    K = assemble_dense(Ke, edofs, ndof)
    F = assemble_vector(Fe_t0, edofs, ndof)
    keep = dirichlet_mask(ndof, dirichlet_dofs, dtype=M.dtype).to(M.device)
    d = torch.as_tensor(np.asarray(dirichlet_dofs),
                        dtype=torch.int64).to(M.device)
    M = M * keep[:, None] * keep[None, :]
    M[d, d] = 1.0
    K = K * keep[:, None] * keep[None, :]
    a0 = torch.linalg.solve(M, F * keep - K @ d0)
    return d0 - dt * v0 + 0.5 * dt * dt * a0


def cg(A, b: torch.Tensor, tol: float = 1e-5, atol: float = 0.0,
       maxiter: int | None = None):
    """Conjugate gradients from x0 = 0, as ``jax.scipy.sparse.linalg.cg``
    runs them (no preconditioner): stop once r.r <= max(tol^2 b.b,
    atol^2) or after ``maxiter`` iterations (default 10 * size). Returns
    (x, iterations)."""
    if maxiter is None:
        maxiter = 10 * b.numel()
    x = torch.zeros_like(b)
    atol2 = max(tol * tol * float(b @ b), atol * atol)
    r = b - A(x)
    p = r
    gamma = r @ r
    k = 0
    while float(gamma) > atol2 and k < maxiter:
        Ap = A(p)
        alpha = gamma / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = r @ r
        beta = gamma_ / gamma
        p = r + beta * p
        gamma = gamma_
        k += 1
    return x, k


def ghost_step_init_cg(Me, Ke, Fe_t0, edofs, ndof: int, dirichlet_dofs, d0,
                       v0, dt: float, tol: float = 1e-12,
                       maxiter: int = 500, info: dict | None = None):
    """The matrix-free ghost step for large meshes: M a0 = F(0) - K d0 by
    :func:`cg` on element-by-element operators (M is SPD after the
    Dirichlet unit diagonal). ``info`` receives the iteration count."""
    keep = dirichlet_mask(ndof, dirichlet_dofs, dtype=d0.dtype).to(d0.device)
    Mop = FIntOperator(Me, edofs, ndof, mode="ebe")
    Kop = FIntOperator(Ke, edofs, ndof, mode="ebe")
    rhs = assemble_vector(Fe_t0, edofs, ndof) * keep - Kop(d0) * keep

    def mat(x):
        # M with the Dirichlet rows and columns zeroed, unit diagonal
        return Mop(x * keep) * keep + x * (1.0 - keep)

    a0, iters = cg(mat, rhs, tol=tol, maxiter=maxiter)
    if info is not None:
        info["iterations"] = iters
    return d0 - dt * v0 + 0.5 * dt * dt * a0
