"""Assembly of element arrays into global vectors (port of the parts of
``savtpu/ops/assembly.py`` the pipeline's setup uses)."""

from __future__ import annotations

import numpy as np
import torch


def element_dofs(cells: np.ndarray) -> np.ndarray:
    """(E, 3*nb) int32 interleaved DOF indices per element."""
    cells = np.asarray(cells, dtype=np.int64)
    E, nb = cells.shape
    dofs = 3 * cells[:, :, None] + np.arange(3)[None, None, :]
    return dofs.reshape(E, 3 * nb).astype(np.int32)


def assemble_vector(Fe: torch.Tensor, edofs, ndof: int) -> torch.Tensor:
    """Global vector by scatter-add of (E, 3nb) element vectors."""
    idx = torch.as_tensor(np.asarray(edofs), dtype=torch.int64,
                          device=Fe.device).reshape(-1)
    out = torch.zeros((ndof,), dtype=Fe.dtype, device=Fe.device)
    return out.index_add_(0, idx, Fe.reshape(-1))


def assemble_force(Fe: torch.Tensor, edofs, ndof: int) -> torch.Tensor:
    return assemble_vector(Fe, edofs, ndof)


def assemble_lumped_mass(Me: torch.Tensor, edofs, ndof: int) -> torch.Tensor:
    """Row-sum lumped mass vector: lumped[p] = sum_q M[p, q]."""
    return assemble_vector(Me.sum(dim=2), edofs, ndof)


def dirichlet_mask(ndof: int, dirichlet_dofs, dtype=torch.float64):
    """0/1 mask, 0 on constrained DOFs."""
    m = torch.ones((ndof,), dtype=dtype)
    m[torch.as_tensor(np.asarray(dirichlet_dofs), dtype=torch.int64)] = 0.0
    return m
