"""Steady displacement under the full (unramped) load (port of
``savtpu/solvers/steady.py:steady_displacement``).

K d = F with strong Dirichlet rows (zeroed rows/columns, unit diagonal,
zero right-hand side), solved once on the host in float64. The JAX
package uses a dense solve up to 6000 DOFs and PCG beyond; here the
assembled system goes to SciPy's sparse direct solver at every size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

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
