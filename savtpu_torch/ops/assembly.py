"""Assembly of element arrays into global vectors and operators (port of
``savtpu/ops/assembly.py``): element DOF maps, vector assembly, lumped
mass (vector and diagonal forms), the Dirichlet mask and its dense-system
form, and ``FIntOperator``, the global F_int(d) = K_nobc d that the serial
explicit runner and the unramped ghost step's CG use."""

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


def assemble_dense(Ke: torch.Tensor, edofs, ndof: int) -> torch.Tensor:
    """Dense global matrix: the element blocks summed into (ndof, ndof)
    (on the host, in the blocks' dtype)."""
    ed = np.asarray(edofs, dtype=np.int64)
    K = np.zeros((ndof, ndof), dtype=torch.empty(
        (), dtype=Ke.dtype).numpy().dtype)
    np.add.at(K, (ed[:, :, None], ed[:, None, :]), Ke.cpu().numpy())
    return torch.as_tensor(K).to(Ke.device)


def lumping(M: torch.Tensor) -> torch.Tensor:
    """Row-sum lumping to a diagonal matrix (the pipeline uses the vector
    form below)."""
    return torch.diag(M.sum(dim=1))


def lumping_to_vec(M: torch.Tensor) -> torch.Tensor:
    """Row-sum lumping to a vector."""
    return M.sum(dim=1)


def apply_dirichlet_dense(K: torch.Tensor, F: torch.Tensor, dirichlet_dofs):
    """Strong homogeneous Dirichlet on a dense system: the constrained
    rows and columns zeroed, a unit diagonal there, the right-hand side
    zeroed; on the tensors' device."""
    d = torch.as_tensor(np.asarray(dirichlet_dofs), dtype=torch.int64,
                        device=K.device)
    keep = torch.ones((K.shape[0],), dtype=K.dtype, device=K.device)
    keep[d] = 0.0
    K = K * keep[:, None] * keep[None, :]
    K[d, d] = 1.0
    return K, F * keep


def incident_lists(edofs, DL: int) -> np.ndarray:
    """(P, DL, C_max) flat element-slot positions (element * nb3 + slot)
    writing into each DOF but the last (DL - 1, the dummy slot of a
    part's padded layout), in element order, padded with the sentinel
    E_max * nb3 (which reads an appended zero): a fixed-order fold of
    element rows by a gather instead of a scatter-add (no atomics on a
    card). The incident-list Neo-Hookean force and the ebe force of the
    stacked solver, and ``FIntOperator``'s ebe mode, fold through it."""
    npn, E_max, nb3 = edofs.shape
    sent = E_max * nb3
    C_max = 1
    per_part_pos = []
    for p in range(npn):
        flat_dof = edofs[p].reshape(-1)
        real = flat_dof < DL - 1
        pos = np.flatnonzero(real)
        dofs = flat_dof[real]
        order = np.argsort(dofs, kind="stable")
        dofs, pos = dofs[order], pos[order]
        counts = np.bincount(dofs, minlength=DL)
        C_max = max(C_max, int(counts.max(initial=1)))
        per_part_pos.append((dofs, pos, counts))
    idx = np.full((npn, DL, C_max), sent, dtype=np.int64)
    for p, (dofs, pos, counts) in enumerate(per_part_pos):
        offs = np.zeros(DL + 1, dtype=np.int64)
        offs[1:] = np.cumsum(counts)
        slot = np.arange(len(dofs)) - offs[dofs]
        idx[p, dofs, slot] = pos
    return idx


def dirichlet_mask(ndof: int, dirichlet_dofs, dtype=torch.float64):
    """0/1 mask, 0 on constrained DOFs: multiplying d1 by it is the
    strong enforcement d1[Dirichlet] = 0."""
    m = torch.ones((ndof,), dtype=dtype)
    m[torch.as_tensor(np.asarray(dirichlet_dofs), dtype=torch.int64)] = 0.0
    return m


class FIntOperator:
    """F_int(d) = K_nobc d with a selectable execution strategy:

    - ``dense``: one (ndof, ndof) matrix-vector product;
    - ``ebe``: matrix-free, each element's K_e d_e (multiply and reduce),
      then every DOF's incident element rows summed by a fixed-width
      gather in element order (``incident_lists``); the JAX package adds
      them with a segment sum, here no scatter-add (and no atomics on a
      card) runs;
    - ``bcoo``: a sparse product: the element blocks' COO entries, their
      duplicates summed on the host at build, stored as CSR (a row-wise
      product, the same sums on a card and on the CPU);
    - ``auto``: dense up to ``dense_cutoff`` DOFs, else ebe.

    The tensors live on ``Ke``'s device."""

    def __init__(self, Ke: torch.Tensor, edofs, ndof: int,
                 mode: str = "auto", dense_cutoff: int = 6144):
        self.ndof = int(ndof)
        self.Ke = Ke
        self.device = dev = Ke.device
        self.edofs = torch.as_tensor(np.asarray(edofs),
                                     dtype=torch.int64).to(dev)
        if mode == "auto":
            mode = "dense" if ndof <= dense_cutoff else "ebe"
        if mode not in ("dense", "ebe", "bcoo"):
            raise ValueError(f"unknown FIntOperator mode {mode!r}")
        self.mode = mode
        self._dense = self._bcoo = self._slots = None
        if mode == "dense":
            self._dense = assemble_dense(Ke, edofs, ndof)
        elif mode == "bcoo":
            E, nb3, _ = Ke.shape
            ed = torch.as_tensor(np.asarray(edofs), dtype=torch.int64)
            rows = ed[:, :, None].expand(E, nb3, nb3).reshape(-1)
            cols = ed[:, None, :].expand(E, nb3, nb3).reshape(-1)
            self._bcoo = torch.sparse_coo_tensor(
                torch.stack([rows, cols]), Ke.cpu().reshape(-1),
                (ndof, ndof), check_invariants=False,
            ).coalesce().to_sparse_csr().to(dev)
        else:
            # one "part" whose dummy slot (ndof) no element writes into
            ed = np.asarray(edofs, dtype=np.int64)[None]
            self._slots = torch.as_tensor(
                incident_lists(ed, ndof + 1)[0, :ndof]).to(dev)

    @property
    def dense_matrix(self) -> torch.Tensor:
        """K_nobc as one (ndof, ndof) tensor on ``Ke``'s device, assembled
        at first use in the modes that do not keep it."""
        if self._dense is None:
            self._dense = assemble_dense(self.Ke, self.edofs.cpu().numpy(),
                                         self.ndof)
        return self._dense

    def __call__(self, d: torch.Tensor) -> torch.Tensor:
        d = d.reshape(-1)
        if self.mode == "dense":
            return self._dense @ d
        if self.mode == "bcoo":
            return (self._bcoo @ d[:, None])[:, 0]
        fe = (self.Ke * d[self.edofs][:, None, :]).sum(-1).reshape(-1)
        flat = torch.cat([fe, fe.new_zeros(1)])
        return flat[self._slots].sum(-1)
