"""The port's serial explicit runner (``solvers/explicit.py``) and its
Neo-Hookean operator (``solvers/nonlinear.py``) against savtpu's, on the
CPU in float64, and the port's partitioned runs against its serial one.

- ``run_explicit`` over ``FIntOperator`` dense, ebe and bcoo against
  savtpu's ``run_explicit_jit``: 1e-12 of the max;
- ``save_every``: the rows of the steps i with i % save_every == 0, bit
  for bit against the every-step run; a step count it does not divide
  raises;
- the port's 2- and 3-part exchanged ``ShardedSolver.run``, globalized,
  against the port's serial run: 1e-12 in norm at every row, as
  savtpu's ``test_emulated_exchanged_matches_serial``;
- ``NeoHookeanFIntOperator`` against savtpu's at 1e-12 of the max on a
  strained input (float64 parity of the Neo-Hookean stress is eps over
  the strain, so the input is strained near 1e-2), and its 120-step run
  from rest at savtpu's own 1e-9 (tests/test_nh_sharded.py).

The ``gpu`` leg runs the serial runner on the card against the CPU.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = 1e-12
MAT = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)


def _cfg(C, nx=6):
    cfg = C()
    cfg.beam_cells = (nx, 1, 1)
    cfg.beam_extent = (float(nx), 1.0, 1.0)
    return cfg


def _port_problem(nx=6):
    from savtpu_torch.config import Config
    from savtpu_torch.solvers import setup_problem

    return setup_problem(_cfg(Config, nx))


def _port_serial(prob, steps, mode="dense", save_every=1, device="cpu"):
    from savtpu_torch.ops.assembly import FIntOperator
    from savtpu_torch.solvers import make_step_fn, run_explicit

    op = FIntOperator(prob.Ke.to(device), prob.edofs, prob.ndof, mode=mode)
    step = make_step_fn(op, prob.F_pre, prob.lumped_M, prob.mask,
                        prob.alpha, prob.dt)
    return run_explicit(step, prob.d0, prob.dn, 0.0, prob.dt, steps,
                        save_every=save_every)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _max_rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("mode", ["dense", "ebe", "bcoo"])
def test_serial_runner_matches_savtpu(mode):
    from savtpu.config import Config as JConfig
    from savtpu.ops.assembly import FIntOperator as JOp
    from savtpu.solvers import make_step_fn as j_step
    from savtpu.solvers import setup_problem as j_setup
    from savtpu.solvers.explicit import run_explicit_jit

    pj = j_setup(_cfg(JConfig))
    sj = j_step(JOp(pj.Ke, pj.edofs, pj.ndof, mode=mode), pj.F_pre,
                pj.lumped_M, pj.mask, pj.alpha, pj.dt)
    want, cj = run_explicit_jit(sj, pj.d0, pj.dn, 0.0, pj.dt, 200)
    got, ct = _port_serial(_port_problem(), 200, mode)
    want = np.asarray(want)
    assert got.shape == want.shape == (200, pj.ndof)
    assert np.abs(want).max() > 0.0
    assert _max_rel(got.numpy(), want) <= TOL
    assert _max_rel(ct[0].numpy(), np.asarray(cj[0])) <= TOL
    assert float(ct[2]) == float(cj[2])


def test_save_every_rows():
    from savtpu.config import Config as JConfig
    from savtpu.ops.assembly import FIntOperator as JOp
    from savtpu.solvers import make_step_fn as j_step
    from savtpu.solvers import setup_problem as j_setup
    from savtpu.solvers.explicit import run_explicit_jit

    prob = _port_problem()
    full, c_full = _port_serial(prob, 200)
    rows, c_rows = _port_serial(prob, 200, save_every=5)
    assert rows.shape == (40, prob.ndof)
    assert torch.equal(rows, full[0::5])
    assert all(torch.equal(a, b) for a, b in zip(c_rows, c_full))
    pj = j_setup(_cfg(JConfig))
    sj = j_step(JOp(pj.Ke, pj.edofs, pj.ndof, mode="dense"), pj.F_pre,
                pj.lumped_M, pj.mask, pj.alpha, pj.dt)
    want, _ = run_explicit_jit(sj, pj.d0, pj.dn, 0.0, pj.dt, 200,
                               save_every=5)
    assert _max_rel(rows.numpy(), np.asarray(want)) <= TOL
    with pytest.raises(ValueError, match="divisible by save_every"):
        _port_serial(prob, 201, save_every=5)


def _globalized(sp, traj, ndof):
    """(P, T, DL) -> (T, ndof), each global DOF from every owner (they
    agree in the exchanged run); also the largest owner disagreement."""
    traj = traj.numpy()
    dm = sp.dof_mask.numpy()
    out = np.zeros((traj.shape[1], ndof))
    seen = np.zeros(ndof, dtype=bool)
    spread = 0.0
    for p in range(sp.n_parts):
        n = int(dm[p].sum())
        g = sp.local_dofs_global[p, :n]
        vals = traj[p, :, :n]
        both = seen[g]
        if both.any():
            spread = max(spread, float(np.abs(
                out[:, g[both]] - vals[:, both]).max()))
        out[:, g] = vals
        seen[g] = True
    assert seen.all()
    return out, spread


@pytest.mark.parametrize("n_parts", [2, 3])
@pytest.mark.parametrize("fint_mode", ["dense", "banded"])
def test_sharded_exchanged_matches_serial(n_parts, fint_mode):
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        ShardedProblem,
        ShardedSolver,
        build_partition_maps,
        partition_elements,
    )

    prob = _port_problem(8)
    steps = 100
    ref, _ = _port_serial(prob, steps)
    ref = ref.numpy()
    mesh = prob.mesh
    epart = partition_elements(mesh.tetra, mesh.points, n_parts, "rcb")
    maps = build_partition_maps(
        mesh.tetra, epart, mesh.num_points,
        dirichlet_nodes(mesh.triangles, mesh.points))
    sp = ShardedProblem.build(prob, maps, fint_mode=fint_mode, device="cpu")
    (traj, _), _ = ShardedSolver(sp).run(
        sp.localize(prob.d0), sp.localize(prob.dn), 0.0, steps, sync=True,
        record="traj")
    g, spread = _globalized(sp, traj, prob.ndof)
    for t in range(0, steps, 25):
        err = np.linalg.norm(g[t] - ref[t]) / max(np.linalg.norm(ref[t]),
                                                  1e-30)
        assert err < TOL, (t, err)
    assert spread <= 1e-13 * np.abs(ref).max()


def _nh_pair(nx=6):
    from savtpu.config import Config as JConfig
    from savtpu.ops.material import NeoHookean as JNH
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.ops.material import NeoHookean

    pj = j_setup(_cfg(JConfig, nx))
    return pj, _port_problem(nx), JNH.from_engineering(**MAT), \
        NeoHookean.from_engineering(**MAT)


def test_nh_operator_matches_savtpu():
    from savtpu.solvers.nonlinear import NeoHookeanFIntOperator as JOp

    from savtpu_torch.solvers import NeoHookeanFIntOperator

    pj, pt, mj, mt = _nh_pair()
    rng = np.random.default_rng(7)
    # strained near 1e-2 (smooth field plus a small random part)
    x = pt.mesh.points
    d = (1e-2 * np.stack([x[:, 0] * 0.1, np.sin(x[:, 0]), 0.3 * x[:, 2]],
                         axis=1)
         + 1e-3 * rng.standard_normal(x.shape)).reshape(-1)
    d *= pt.mask.numpy()
    want = np.asarray(JOp(mj, pj.coords, pj.edofs, pj.ndof)(d))
    got = NeoHookeanFIntOperator(mt, pt.coords, pt.edofs, pt.ndof)(
        torch.as_tensor(d)).numpy()
    assert np.abs(want).max() > 0.0
    assert _max_rel(got, want) <= TOL


def test_nh_run_matches_savtpu():
    from savtpu.solvers import make_step_fn as j_step
    from savtpu.solvers.explicit import run_explicit_jit
    from savtpu.solvers.nonlinear import NeoHookeanFIntOperator as JOp

    from savtpu_torch.solvers import (
        NeoHookeanFIntOperator,
        make_step_fn,
        run_explicit,
    )

    pj, pt, mj, mt = _nh_pair()
    sj = j_step(JOp(mj, pj.coords, pj.edofs, pj.ndof), pj.F_pre,
                pj.lumped_M, pj.mask, pj.alpha, pj.dt)
    want, _ = run_explicit_jit(sj, pj.d0, pj.dn, 0.0, pj.dt, 120)
    st = make_step_fn(NeoHookeanFIntOperator(mt, pt.coords, pt.edofs,
                                             pt.ndof),
                      pt.F_pre, pt.lumped_M, pt.mask, pt.alpha, pt.dt)
    got, _ = run_explicit(st, pt.d0, pt.dn, 0.0, pt.dt, 120)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.0
    assert _max_rel(got.numpy(), want) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "ebe", "bcoo"])
def test_serial_runner_on_card_matches_cpu(mode):
    dev = _card()
    prob = _port_problem()
    cpu, _ = _port_serial(prob, 200, mode)
    card, _ = _port_serial(prob, 200, mode, device=dev)
    assert card.device.type == "cuda"
    assert _max_rel(card.cpu().numpy(), cpu.numpy()) <= TOL
