"""The port's steady solve (``solvers/steady.py``) against savtpu's, on
the CPU in float64: every route of ``steady_solve`` and ``eigen_modes``.

- the dense route (up to 6,000 DOFs, ``torch.linalg.solve``): savtpu's
  dense solve at 1e-10 of the max;
- two-level PCG with the coarse space forced on (``coarse_min_ndof=0,
  coarse_target=384``) and Jacobi-only (no points): savtpu's
  ``_steady_solve_pcg`` at 1e-10 in norm, and both within savtpu's own
  bounds (relative residual below 1e-9, 1e-7 from the dense solution;
  tests/test_assembly_solvers.py);
- ``steady_displacement`` past 6,000 DOFs takes PCG and agrees with
  savtpu's at 1e-10;
- the sparse fallback: SciPy's direct solve against savtpu's at 1e-10,
  and ``steady_solve`` takes it when PCG stops above 1e-6;
- ``eigen_modes``: savtpu's frequencies at 1e-10 of the largest, the
  constrained DOFs zero-frequency modes;
- the dense helpers ``lumping`` and ``lumping_to_vec`` (row sums: 1e-15
  of the max, the sum order) and ``apply_dirichlet_dense`` (exactly):
  savtpu's.

The ``gpu`` leg runs the dense route and ``eigen_modes`` on the card
against the CPU at 1e-10: two LU factorizations (cuSOLVER's, LAPACK's)
agree to the solve's forward error, eps * kappa(K), about 4e-12 on the
default beam.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MAT = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


def _system(nx, ny, nz, extent):
    """(Ke, Fe, edofs, ndof, ddofs, points, Me) of a beam, from savtpu's
    element kernels (the port's are held to them elsewhere)."""
    from savtpu.mesh import beam_mesh, dirichlet_nodes
    from savtpu.mesh.geometry import node_to_dof
    from savtpu.ops.assembly import element_dofs
    from savtpu.ops.element import batch_element_mkf, gather_coords
    from savtpu.ops.material import LinearElastic

    mesh = beam_mesh(nx, ny, nz, extent=extent)
    mat = LinearElastic.from_engineering(**MAT, ramped=False)
    Me, Ke, Fe = batch_element_mkf(1, 2, mat, 0.0,
                                   gather_coords(mesh.tetra, mesh.points))
    ddofs = node_to_dof(dirichlet_nodes(mesh.triangles, mesh.points))
    return (np.array(Ke), np.array(Fe), element_dofs(mesh.tetra),
            mesh.num_dofs, np.array(ddofs), mesh.points, np.array(Me))


def test_dense_route_matches_savtpu():
    from savtpu.solvers.steady import steady_solve as j_solve

    from savtpu_torch.solvers import steady_solve

    Ke, Fe, ed, ndof, dd, _, _ = _system(6, 1, 1, (6.0, 1.0, 1.0))
    want = np.asarray(j_solve(Ke, Fe, ed, ndof, dd))
    info = {}
    got = steady_solve(torch.as_tensor(Ke), torch.as_tensor(Fe), ed, ndof,
                       dd, info=info)
    assert info["route"] == "dense" and got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("coarse", [True, False])
def test_pcg_matches_savtpu(coarse):
    from savtpu.solvers.steady import _steady_solve_pcg as j_pcg
    from savtpu.solvers.steady import steady_solve as j_solve

    from savtpu_torch.solvers.steady import _steady_solve_pcg

    if coarse:
        sysm = _system(16, 3, 3, (16.0 / 3.0, 1.0, 1.0))
        kw = dict(points=sysm[5], coarse_min_ndof=0, coarse_target=384)
    else:
        sysm = _system(4, 1, 1, (4.0, 1.0, 1.0))
        kw = {}
    Ke, Fe, ed, ndof, dd = sysm[:5]
    dense = np.asarray(j_solve(Ke, Fe, ed, ndof, dd))
    want, rel_j = j_pcg(Ke, Fe, ed, ndof, dd, **kw)
    info = {}
    got, rel = _steady_solve_pcg(Ke, Fe, ed, ndof, dd, info=info, **kw)
    assert rel < 1e-9 and _rel(got, dense) < 1e-7
    assert _rel(got, want) <= 1e-10
    assert info["iterations"] > 0
    assert (info["coarse_cells"] is not None) == coarse


def test_steady_displacement_pcg_route_matches_savtpu():
    """40x6x6 (6,027 DOFs): past the dense limit, under the coarse gate,
    so Jacobi PCG with the problem's points."""
    from savtpu.config import Config as JConfig
    from savtpu.solvers import setup_problem as j_setup
    from savtpu.solvers.steady import steady_displacement as j_steady

    from savtpu_torch.config import Config
    from savtpu_torch.solvers import setup_problem, steady_displacement

    def cfg(C):
        c = C()
        c.beam_cells = (40, 6, 6)
        c.beam_extent = (40.0 / 6.0, 1.0, 1.0)
        return c

    want = np.asarray(j_steady(j_setup(cfg(JConfig))))
    info = {}
    got = steady_displacement(setup_problem(cfg(Config)), device="cpu",
                              info=info)
    assert want.shape == (6027,)
    assert info["route"] == "pcg" and info["rel_residual"] <= 1e-6
    assert _rel(got, want) <= 1e-10


def test_steady_displacement_defaults_to_cuda(monkeypatch):
    """With no device, steady_displacement solves on CUDA, and raises
    where there is none rather than solving on the CPU."""
    from savtpu_torch.config import Config
    from savtpu_torch.solvers import setup_problem, steady_displacement

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.beam_cells = (4, 1, 1)
    cfg.beam_extent = (4.0, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steady_displacement(setup_problem(cfg))


def test_sparse_fallback(monkeypatch):
    from savtpu.solvers.steady import _steady_solve_sparse_host as j_sparse

    from savtpu_torch.solvers import steady as st

    Ke, Fe, ed, ndof, dd, pts, _ = _system(6, 1, 1, (6.0, 1.0, 1.0))
    want = np.asarray(j_sparse(Ke, Fe, ed, ndof, dd))
    got = st._steady_solve_sparse_host(Ke, Fe, ed, ndof, dd)
    assert _rel(got, want) <= 1e-10
    dense = st.steady_solve(torch.as_tensor(Ke), torch.as_tensor(Fe), ed,
                            ndof, dd).numpy()
    # past the dense limit, a PCG that stops above 1e-6 hands over
    monkeypatch.setattr(st, "DENSE_MAX_NDOF", 0)
    monkeypatch.setattr(st, "_steady_solve_pcg",
                        lambda *a, **k: (np.zeros(ndof), 1.0))
    info = {}
    got = st.steady_solve(torch.as_tensor(Ke), torch.as_tensor(Fe), ed,
                          ndof, dd, points=pts, info=info)
    assert info["route"] == "sparse"
    assert _rel(got.numpy(), dense) <= 1e-10


def test_eigen_modes_match_savtpu():
    from savtpu.solvers.steady import eigen_modes as j_eigen

    from savtpu_torch.solvers import eigen_modes

    Ke, Fe, ed, ndof, dd, _, Me = _system(6, 1, 1, (6.0, 1.0, 1.0))
    want = np.asarray(j_eigen(Me, Ke, ed, ndof, dd, num=40))
    got = eigen_modes(torch.as_tensor(Me), torch.as_tensor(Ke), ed, ndof,
                      dd, num=40).numpy()
    assert got.shape == want.shape == (40,)
    assert (got[:len(dd)] == 0.0).all() and (got[len(dd):] > 0.0).all()
    assert np.abs(got - want).max() <= 1e-10 * want.max()


def test_dense_helpers_match_savtpu():
    import jax.numpy as jnp
    from savtpu.ops import assembly as ja

    from savtpu_torch.ops import assembly as ta

    Ke, Fe, ed, ndof, dd, _, Me = _system(4, 1, 1, (4.0, 1.0, 1.0))
    M = np.array(ja.assemble_dense(Me, ed, ndof))
    K = np.array(ja.assemble_dense(Ke, ed, ndof))
    F = np.array(ja.assemble_vector(Fe, ed, ndof))
    for t_fn, j_fn in ((ta.lumping, ja.lumping),
                       (ta.lumping_to_vec, ja.lumping_to_vec)):
        want = np.asarray(j_fn(jnp.asarray(M)))
        np.testing.assert_allclose(t_fn(torch.as_tensor(M)).numpy(), want,
                                   rtol=0, atol=1e-15 * np.abs(want).max())
    Kt, Ft = ta.apply_dirichlet_dense(torch.as_tensor(K),
                                      torch.as_tensor(F), dd)
    Kj, Fj = ja.apply_dirichlet_dense(jnp.asarray(K), jnp.asarray(F), dd)
    np.testing.assert_array_equal(Kt.numpy(), np.asarray(Kj))
    np.testing.assert_array_equal(Ft.numpy(), np.asarray(Fj))
    assert (Kt.numpy()[dd, dd] == 1.0).all() and (Ft.numpy()[dd] == 0).all()


@pytest.mark.gpu
def test_dense_route_and_eigen_modes_on_card_match_cpu():
    from savtpu_torch.config import Config
    from savtpu_torch.ops.element import batch_element_mkf
    from savtpu_torch.solvers import (
        eigen_modes,
        setup_problem,
        steady_displacement,
    )

    dev = _card()
    prob = setup_problem(Config())
    info = {}
    card = steady_displacement(prob, device=dev, info=info)
    cpu = steady_displacement(prob, device="cpu")
    assert info["route"] == "dense"
    assert np.abs(card - cpu).max() <= 1e-10 * np.abs(cpu).max()
    Me, Ke, _ = batch_element_mkf(1, 2, prob.material, 0.0, prob.coords)
    f_cpu = eigen_modes(Me, Ke, prob.edofs, prob.ndof, prob.dirichlet_dofs)
    f_card = eigen_modes(Me.to(dev), Ke.to(dev), prob.edofs, prob.ndof,
                         prob.dirichlet_dofs)
    assert f_card.device.type == "cuda"
    assert (f_card.cpu() - f_cpu).abs().max() <= 1e-10 * f_cpu.max()
