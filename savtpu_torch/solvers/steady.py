"""Steady solve, the unramped load's ghost step and modal analysis (port of
``savtpu/solvers/steady.py``: ``steady_solve``, ``_steady_solve_pcg``,
``_steady_solve_sparse_host``, ``steady_displacement``, ``eigen_modes``,
``ghost_step_init``, ``ghost_step_init_cg``).

K d = F with strong Dirichlet rows (zeroed rows/columns, unit diagonal,
zero right-hand side), solved once per run, by the JAX package's route:
- up to 6,000 DOFs the dense assembled system, one float64
  ``torch.linalg.solve`` on the tensors' device;
- beyond, two-level preconditioned CG (Jacobi plus a trilinear coarse
  grid over the bounding box) in float64 NumPy/SciPy on the host, as
  there: the attainable residual of CG is about eps * kappa(K), which
  float32 cannot bring under 1 at the sizes that need it;
- a PCG result above 1e-6 relative residual goes to SciPy's sparse direct
  solver.

The ghost step d_{-1} of an unramped load (the load is on at t = 0, so
the initial acceleration is not 0) solves the consistent mass system:
densely (``torch.linalg.solve``) up to 6144 DOFs, beyond by conjugate
gradients on element-by-element operators, with the JAX package's CG
(``jax.scipy.sparse.linalg.cg``: its update order and its stopping rule),
so both take the same iterations. Both run on the tensors' device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from ..ops.assembly import (
    FIntOperator,
    apply_dirichlet_dense,
    assemble_dense,
    assemble_vector,
    dirichlet_mask,
)
from ..ops.element import batch_element_mkf
from ..utils import resolve_device

# the dense route's limit, and the residual a PCG result must reach: any
# float64 solve reaches about eps * kappa(K) (about 1e-7 at 384x16x16),
# and the sparse direct fallback cannot beat it
DENSE_MAX_NDOF = 6000
PCG_ACCEPT = 1e-6


def _as64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float64)


def steady_solve(Ke, Fe, edofs, ndof: int, dirichlet_dofs, points=None,
                 info: dict | None = None) -> torch.Tensor:
    """Solve K d = F (float64) with homogeneous Dirichlet DOFs. Returns a
    float64 tensor on ``Ke``'s device. ``info`` receives the route
    ("dense", "pcg" or "sparse") and PCG's iterations and residual."""
    Ke, Fe = _as64(Ke), _as64(Fe)
    if info is None:
        info = {}
    if ndof <= DENSE_MAX_NDOF:
        info["route"] = "dense"
        K = assemble_dense(Ke, edofs, ndof)
        F = assemble_vector(Fe, edofs, ndof)
        K, F = apply_dirichlet_dense(K, F, dirichlet_dofs)
        return torch.linalg.solve(K, F)
    Ke_h, Fe_h = Ke.cpu().numpy(), Fe.cpu().numpy()
    x, rel = _steady_solve_pcg(Ke_h, Fe_h, edofs, ndof, dirichlet_dofs,
                               points=points, info=info)
    if rel <= PCG_ACCEPT:
        info["route"] = "pcg"
        return torch.as_tensor(x).to(Ke.device)
    # PCG stagnated (pathological conditioning): the sparse direct solve
    info["route"] = "sparse"
    x = _steady_solve_sparse_host(Ke_h, Fe_h, edofs, ndof, dirichlet_dofs)
    return torch.as_tensor(x).to(Ke.device)


def _dirichlet_system(Ke, Fe, edofs, ndof, dirichlet_dofs):
    """(K CSR, F, keep) on the host in float64: the element blocks summed,
    the Dirichlet rows and columns zeroed, a unit diagonal there."""
    ed = np.asarray(edofs, dtype=np.int32)  # int32 halves the COO sort
    nb3 = ed.shape[1]
    rows = np.repeat(ed, nb3, axis=1).reshape(-1)
    cols = np.tile(ed, (1, nb3)).reshape(-1)
    K = sps.coo_matrix(
        (np.asarray(Ke, dtype=np.float64).reshape(-1), (rows, cols)),
        shape=(ndof, ndof),
    ).tocsr()
    keep = np.ones(ndof)
    keep[np.asarray(dirichlet_dofs)] = 0.0
    Dk = sps.diags(keep)
    K = Dk @ K @ Dk + sps.diags(1.0 - keep)
    F = np.zeros(ndof)
    np.add.at(F, ed.reshape(-1), np.asarray(Fe, np.float64).reshape(-1))
    return K, F * keep, keep


def _coarse_space(Ksp, points, ndof, coarse_target):
    """The coarse correction r -> P K_c^-1 P^T r: P trilinear
    interpolation from a regular grid of about ``coarse_target`` DOFs over
    the bounding box (geometry only), K_c = P^T K P factored once by
    Cholesky (with a diagonal jitter ladder; an eigen-decomposition if
    every rung fails). Returns (apply, coarse cell counts)."""
    pts = np.asarray(points, dtype=np.float64)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    n_nodes_target = max(coarse_target // 3, 8)
    scale = (n_nodes_target / float(np.prod(span))) ** (1.0 / 3.0)
    cdims = np.maximum((span * scale).astype(int), 1)  # cells per axis
    while np.prod(cdims + 1) * 3 > coarse_target * 1.5:
        cdims = np.maximum(cdims - 1, 1)
    ncx, ncy, ncz = (int(c) for c in cdims)
    n_coarse = (ncx + 1) * (ncy + 1) * (ncz + 1)
    u = (pts - lo) / span * cdims  # in [0, cdims]
    cell = np.minimum(u.astype(int), cdims - 1)
    frac = u - cell
    strides = np.array([(ncy + 1) * (ncz + 1), ncz + 1, 1], dtype=np.int64)
    corners = np.array(
        [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
        dtype=np.int64,
    )
    cidx = ((cell[:, None, :] + corners[None, :, :]) * strides).sum(-1)
    wxyz = np.stack([1.0 - frac, frac], axis=2)  # (Nf, 3, 2)
    w = (wxyz[:, 0, corners[:, 0]] * wxyz[:, 1, corners[:, 1]]
         * wxyz[:, 2, corners[:, 2]])  # (Nf, 8)
    nc_dof = 3 * n_coarse
    Nf = pts.shape[0]
    rP = np.broadcast_to(
        3 * np.arange(Nf)[:, None, None] + np.arange(3)[None, None, :],
        (Nf, 8, 3),
    ).reshape(-1)
    cP = (3 * cidx[:, :, None] + np.arange(3)[None, None, :]).reshape(-1)
    vP = np.broadcast_to(w[:, :, None], (Nf, 8, 3)).reshape(-1)
    Pmat = sps.coo_matrix((vP, (rP, cP)), shape=(ndof, nc_dof)).tocsr()
    Kc = (Pmat.T @ (Ksp @ Pmat)).toarray()
    Kc = 0.5 * (Kc + Kc.T)
    # coarse nodes whose support holds no fine node give zero rows: a
    # small diagonal jitter decouples them (their residual is exactly 0).
    # The Cholesky factor comes from torch's LAPACK on the host (float64;
    # SciPy's took 20 times as long on some installations), and the
    # coarse solve applies K_c^-1 formed from it once: one threaded
    # matrix-vector product an iteration, where two triangular solves
    # read the factor on one thread (0.15 s an iteration at 4,425 coarse
    # DOFs)
    diag_scale = max(float(np.trace(Kc)) / nc_dof, 1e-30)
    L = None
    for jit_eps in (1e-12, 1e-9, 1e-6):
        Kc_j = Kc.copy()
        Kc_j[np.arange(nc_dof), np.arange(nc_dof)] += jit_eps * diag_scale
        L, bad = torch.linalg.cholesky_ex(torch.from_numpy(Kc_j))
        if int(bad) == 0:
            break
        L = None
    if L is None:
        lam, V = np.linalg.eigh(Kc)
        lam_max = float(lam[-1]) if len(lam) else 1.0
        keep_modes = lam > 1e-12 * max(lam_max, 1e-30)
        W = V[:, keep_modes] / np.sqrt(lam[keep_modes])

        def apply(r):
            return Pmat @ (W @ (W.T @ (Pmat.T @ r)))
    else:

        Kc_inv = torch.cholesky_inverse(L)

        def apply(r):
            rc = torch.from_numpy(np.ascontiguousarray(Pmat.T @ r))
            return Pmat @ torch.mv(Kc_inv, rc).numpy()

    return apply, (ncx, ncy, ncz)


def _steady_solve_pcg(
    Ke,
    Fe,
    edofs,
    ndof: int,
    dirichlet_dofs,
    points=None,
    rtol: float = 1e-10,
    maxiter: int = 20_000,
    coarse_target: int = 4096,
    coarse_min_ndof: int = 20_000,
    info: dict | None = None,
):
    """Two-level preconditioned CG, float64 on the host:

        M^-1 = D^-1 + P K_c^-1 P^T        (additive two-level Schwarz)

    with the coarse term only when ``points`` are given and ndof >
    ``coarse_min_ndof`` (it carries the slender beam's slow bending
    modes, which stall Jacobi-CG). The true residual replaces the
    recursive one every 200 iterations. Returns ``(x, final relative
    residual)``; ``info`` receives iterations, the residual, the coarse
    grid and the seconds."""
    t0 = time.perf_counter()
    Ksp, F64, _ = _dirichlet_system(Ke, Fe, edofs, ndof, dirichlet_dofs)
    invdiag = 1.0 / Ksp.diagonal()
    apply_coarse, cdims = None, None
    if points is not None and ndof > coarse_min_ndof:
        apply_coarse, cdims = _coarse_space(Ksp, points, ndof, coarse_target)
    if apply_coarse is None:
        Minv = lambda r: r * invdiag  # noqa: E731
    else:
        Minv = lambda r: r * invdiag + apply_coarse(r)  # noqa: E731
    t_setup = time.perf_counter() - t0

    x = np.zeros(ndof)
    r = F64.copy()
    nF = float(np.linalg.norm(F64))
    it = -1
    if nF == 0.0:
        rel = 0.0
    else:
        z = Minv(r)
        p = z.copy()
        rz = float(r @ z)
        for it in range(maxiter):
            Ap = Ksp @ p
            pAp = float(p @ Ap)
            if not np.isfinite(pAp) or pAp <= 0.0:
                break
            alpha = rz / pAp
            x += alpha * p
            r -= alpha * Ap
            if (it + 1) % 200 == 0:
                r = F64 - Ksp @ x  # refresh against recursion drift
            rel = float(np.linalg.norm(r) / nF)
            if rel <= rtol:
                break
            z = Minv(r)
            rz_new = float(r @ z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        rel = float(np.linalg.norm(F64 - Ksp @ x) / nF)
    if info is not None:
        info.update(iterations=it + 1, rel_residual=rel, coarse_cells=cdims,
                    setup_s=t_setup, seconds=time.perf_counter() - t0)
    return x, rel


def _steady_solve_sparse_host(Ke, Fe, edofs, ndof, dirichlet_dofs):
    """SciPy's sparse direct solve of the Dirichlet system (float64)."""
    K, F, _ = _dirichlet_system(Ke, Fe, edofs, ndof, dirichlet_dofs)
    return spla.spsolve(K.tocsc(), F)


def steady_displacement(prob, device=None, info: dict | None = None
                        ) -> np.ndarray:
    """Steady displacement (float64, host) of an AssembledProblem under
    the unramped load, P1 or the steady-only P2 path. The dense route
    solves on ``device`` (default CUDA, through ``resolve_device``); the
    host PCG takes the problem's host arrays as they are."""
    dev = resolve_device(device)
    mat = dataclasses.replace(prob.material, ramped=False)
    coords, Ke = prob.coords, prob.Ke
    if prob.ndof <= DENSE_MAX_NDOF:
        coords, Ke = coords.to(dev), Ke.to(dev)
    Fe = batch_element_mkf(prob.deg, prob.n_quad, mat, 0.0, coords)[2]
    d = steady_solve(Ke, Fe, prob.edofs, prob.ndof, prob.dirichlet_dofs,
                     points=prob.mesh.points, info=info)
    return d.cpu().numpy()


def eigen_modes(Me, Ke, edofs, ndof: int, dirichlet_dofs,
                num: int = 50) -> torch.Tensor:
    """The first ``num`` natural frequencies (Hz) of K phi = w^2 M phi,
    float64 on ``Ke``'s device: the Dirichlet rows and columns dropped
    from both, and each constrained DOF a zero-frequency mode, as in the
    JAX package's spectrum. The free block is reduced by M's Cholesky
    factor (C = L^-1 K L^-T) and ``eigvalsh``'d."""
    Ke = _as64(Ke)
    K = assemble_dense(Ke, edofs, ndof)
    M = assemble_dense(_as64(Me).to(Ke.device), edofs, ndof)
    keep = np.ones(ndof, dtype=bool)
    keep[np.asarray(dirichlet_dofs)] = False
    free = torch.as_tensor(np.flatnonzero(keep), device=K.device)
    K, M = K[free][:, free], M[free][:, free]
    L = torch.linalg.cholesky(M)
    A = torch.linalg.solve_triangular(L, K, upper=False)
    C = torch.linalg.solve_triangular(L, A.T, upper=False).T
    omega_sq = torch.linalg.eigvalsh(0.5 * (C + C.T))
    omega_sq = torch.cat([omega_sq.new_zeros(ndof - len(free)), omega_sq])
    freqs = torch.sqrt(torch.clamp(omega_sq, min=0.0)) / (2 * np.pi)
    return freqs[:num]


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
