"""The unramped load's ghost step (``solvers/steady.py``) and the
unramped ``setup_problem`` against savtpu's, on the CPU.

- the dense ghost step (consistent mass, one ``torch.linalg.solve`` in
  float64): 1e-12 of the max;
- the CG ghost step: CG is ``jax.scipy.sparse.linalg.cg``'s iteration
  (tol 1e-12, maxiter 500), held to it iteration for iteration on a
  seeded SPD system, and to savtpu's ghost step at 1e-10 (the solution's
  share of CG's 1e-12 residual);
- ``setup_problem`` with ``material.ramped = False``: savtpu's ghost step
  at 1e-12 on the dense path (ndof <= 6144) and at 1e-10 on the CG path;
- stage 1 under the unramped load: savtpu's trajectories at 1e-10.

The ``gpu`` legs hold both ghost steps on the card against the CPU. This
module imports JAX and savtpu only inside its CPU tests, so on the card
it runs as ``python -m pytest --noconftest -m gpu
tests/test_torch_ghost_step.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _unramped(C, cells):
    cfg = C()
    cfg.beam_cells = cells
    cfg.beam_extent = (cells[0] / cells[1], 1.0, 1.0)
    cfg.material.ramped = False
    return cfg


def _element_arrays(cells=(6, 1, 1), device="cpu"):
    """The port's unramped problem and its Me, Ke, Fe on ``device``."""
    from savtpu_torch.config import Config
    from savtpu_torch.ops.element import batch_element_mkf
    from savtpu_torch.solvers import setup_problem

    prob = setup_problem(_unramped(Config, cells))
    mat = dataclasses.replace(prob.material, ramped=False)
    Me, Ke, Fe = batch_element_mkf(prob.deg, prob.n_quad, mat, 0.0,
                                   prob.coords)
    return prob, [t.to(device) for t in (Me, Ke, Fe)]


def test_dense_ghost_step_matches_savtpu():
    import jax.numpy as jnp
    from savtpu.solvers.steady import ghost_step_init as j_ghost

    from savtpu_torch.solvers import ghost_step_init

    prob, (Me, Ke, Fe) = _element_arrays()
    z = torch.zeros(prob.ndof, dtype=torch.float64)
    got = ghost_step_init(Me, Ke, Fe, prob.edofs, prob.ndof,
                          prob.dirichlet_dofs, z, z, prob.dt).numpy()
    want = np.asarray(j_ghost(
        *(jnp.asarray(t.numpy()) for t in (Me, Ke, Fe)), prob.edofs,
        prob.ndof, prob.dirichlet_dofs, jnp.zeros(prob.ndof),
        jnp.zeros(prob.ndof), prob.dt))
    assert np.abs(want).max() > 0.0
    assert _rel(got, want) <= 1e-12


def test_cg_ghost_step_matches_savtpu():
    import jax.numpy as jnp
    from savtpu.solvers.steady import ghost_step_init_cg as j_cg

    from savtpu_torch.solvers import ghost_step_init, ghost_step_init_cg

    prob, (Me, Ke, Fe) = _element_arrays()
    z = torch.zeros(prob.ndof, dtype=torch.float64)
    info = {}
    got = ghost_step_init_cg(Me, Ke, Fe, prob.edofs, prob.ndof,
                             prob.dirichlet_dofs, z, z, prob.dt,
                             info=info).numpy()
    want = np.asarray(j_cg(
        *(jnp.asarray(t.numpy()) for t in (Me, Ke, Fe)), prob.edofs,
        prob.ndof, prob.dirichlet_dofs, jnp.zeros(prob.ndof),
        jnp.zeros(prob.ndof), prob.dt))
    assert 0 < info["iterations"] < 500
    assert _rel(got, want) <= 1e-10
    dense = ghost_step_init(Me, Ke, Fe, prob.edofs, prob.ndof,
                            prob.dirichlet_dofs, z, z, prob.dt).numpy()
    assert _rel(got, dense) <= 1e-10


def test_cg_takes_jax_cgs_iterations():
    """On a seeded SPD system: the port's CG stops after k iterations,
    where JAX's CG capped at k iterations gives the port's solution and
    capped at k - 1 does not yet meet the tolerance."""
    import jax.numpy as jnp
    from jax.scipy.sparse.linalg import cg as j_cg

    from savtpu_torch.solvers.steady import cg

    rng = np.random.default_rng(0)
    B = rng.standard_normal((60, 60))
    A = B @ B.T + 60.0 * np.eye(60)
    b = rng.standard_normal(60)
    At = torch.as_tensor(A)
    x, k = cg(lambda v: At @ v, torch.as_tensor(b), tol=1e-12, maxiter=500)
    Aj = jnp.asarray(A)
    xk, _ = j_cg(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12, maxiter=k)
    xk1, _ = j_cg(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                  maxiter=k - 1)
    assert _rel(x.numpy(), xk) <= 1e-13
    res = lambda y: np.linalg.norm(b - A @ np.asarray(y))  # noqa: E731
    assert res(x.numpy()) <= 1e-12 * np.linalg.norm(b)
    assert res(xk1) > 1e-12 * np.linalg.norm(b)


@pytest.mark.parametrize("cells,tol", [((12, 2, 2), 1e-12),
                                       ((42, 6, 6), 1e-10)])
def test_unramped_setup_matches_savtpu(cells, tol):
    """setup_problem with an unramped load: the ghost step d_{-1} is not 0
    and equals savtpu's; 12x2x2 (351 DOFs) takes the dense solve, 42x6x6
    (6,321 DOFs) the CG."""
    from savtpu.config import Config as JConfig
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.config import Config
    from savtpu_torch.solvers import setup_problem

    pt = setup_problem(_unramped(Config, cells))
    pj = j_setup(_unramped(JConfig, cells))
    assert (pt.ndof > 6144) == (cells[0] == 42)
    assert not pt.material.ramped
    want = np.asarray(pj.dn)
    assert np.abs(want).max() > 0.0
    assert _rel(pt.dn.numpy(), want) <= tol
    for name in ("lumped_M", "F_pre"):
        assert _rel(getattr(pt, name).numpy(),
                    np.asarray(getattr(pj, name))) <= 1e-12, name


def test_unramped_stage1_matches_savtpu(tmp_path):
    """Stage 1 under the unramped load (the full load from step 0, the
    ghost-step start): the port's stored trajectories are savtpu's."""
    from savtpu.config import Config as JConfig
    from savtpu.io.artifacts import ArtifactStore as JStore
    from savtpu.io.artifacts import load_displacement as j_load
    from savtpu.pipeline import data_prepare as j_stage1

    from savtpu_torch.config import Config
    from savtpu_torch.io.artifacts import ArtifactStore, load_displacement
    from savtpu_torch.pipeline import data_prepare

    cfgs = []
    for C, sub in ((Config, "port"), (JConfig, "savtpu")):
        c = _unramped(C, (6, 1, 1))
        c.workdir = str(tmp_path / sub / "Results")
        c.model_dir = str(tmp_path / sub / "Distributed_save")
        c.partition.n_parts = 2
        c.solver.num_steps = 100
        cfgs.append(c)
    data_prepare.run(cfgs[0], verbose=False, device="cpu")
    j_stage1.run(cfgs[1], verbose=False)
    for r in range(2):
        a = load_displacement(ArtifactStore(
            cfgs[0].workdir, cfgs[0].model_dir, "x").dynamics_h5(r))
        b = j_load(JStore(cfgs[1].workdir, cfgs[1].model_dir,
                          "x").dynamics_h5(r))
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a[:, 0]).max() > 0.0   # moving from the first step
        assert _rel(a, b) <= 1e-10, r


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_ghost_steps_equal_cpu():
    """Both ghost steps on the card against the CPU: the dense solve at
    1e-12, the CG at its tolerance."""
    from savtpu_torch.solvers import ghost_step_init, ghost_step_init_cg

    dev = _card()
    for fn, tol in ((ghost_step_init, 1e-12), (ghost_step_init_cg, 1e-10)):
        outs = []
        for d in ("cpu", dev):
            prob, arrays = _element_arrays(device=d)
            z = torch.zeros(prob.ndof, dtype=torch.float64, device=d)
            outs.append(fn(*arrays, prob.edofs, prob.ndof,
                           prob.dirichlet_dofs, z, z, prob.dt).cpu().numpy())
        assert _rel(outs[1], outs[0]) <= tol, fn.__name__
