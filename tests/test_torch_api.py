"""``api.Simulation``'s direct solver access (``solver()``, ``steady()``)
against savtpu's, on the CPU.

- ``steady()``: savtpu's steady displacement at 1e-10 of the max (savtpu
  solves densely at this size, the port with SciPy's sparse direct
  solver);
- ``solver()``: the context's ShardedSolver, whose exchanged run is the
  stage-1 run;
- ``steady()`` at ``deg = 2`` (the steady-only P2 path, no sharded
  context): savtpu's at 1e-10 of the max.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _cfg(C, root):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    return cfg


def test_steady_matches_savtpu(tmp_path):
    from savtpu.api import Simulation as JSimulation
    from savtpu.config import Config as JConfig

    from savtpu_torch.api import Simulation
    from savtpu_torch.config import Config

    got = Simulation(_cfg(Config, tmp_path / "port"), device="cpu",
                     verbose=False).steady()
    want = np.asarray(JSimulation(_cfg(JConfig, tmp_path / "savtpu"),
                                  verbose=False).steady())
    assert got.shape == want.shape and np.abs(want).max() > 0.0
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_solver_is_the_contexts(tmp_path):
    from savtpu_torch.api import Simulation
    from savtpu_torch.config import Config
    from savtpu_torch.parallel import ShardedSolver

    sim = Simulation(_cfg(Config, tmp_path), device="cpu", verbose=False)
    sol = sim.solver()
    assert isinstance(sol, ShardedSolver) and sol is sim.ctx.solver
    sp = sol.sp
    (traj, _), carry = sol.run(sp.localize(sim.ctx.prob.d0),
                               sp.localize(sim.ctx.prob.dn), 0.0, 20,
                               sync=True, record="traj")
    assert traj.shape == (sp.n_parts, 20, sp.DL)
    assert bool(torch.isfinite(carry[0]).all())


def test_steady_p2_matches_savtpu(tmp_path):
    from savtpu.api import Simulation as JSimulation
    from savtpu.config import Config as JConfig

    from savtpu_torch.api import Simulation
    from savtpu_torch.config import Config

    cfg, cj = _cfg(Config, tmp_path / "port"), _cfg(JConfig, tmp_path / "j")
    cfg.solver.deg = cj.solver.deg = 2
    got = Simulation(cfg, device="cpu", verbose=False).steady()
    want = np.asarray(JSimulation(cj, verbose=False).steady())
    # the P2 beam: 13 x 3 x 3 nodes
    assert got.shape == want.shape == (3 * 13 * 3 * 3,)
    assert np.abs(want).max() > 0.0
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
