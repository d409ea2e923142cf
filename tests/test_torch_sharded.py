"""savtpu_torch's stacked stepper against savtpu's ``stacked_run``.

Same problem, maps, initial state and synthetic shared-DOF predictions
through both packages: exchanged (psum) and comm-free with prediction
overwrite, compensated and plain, banded and dense, ``save_every`` 1 and
5. savtpu's comm-free banded compensated block is held here on its
``lax.scan`` branch (its Pallas kernel is compared in
test_torch_online_kernel.py); the port's goes through its online path,
which on the CPU is the kernel's plain version.

Tolerances: float64 1e-12 of each output's norm (only the sum order of
the matvecs differs). float32 2e-4 of the norm, the bound savtpu's own
float32 kernel test uses: the two packages sum the matvec in different
orders, and the states drift apart at float32 round-off.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.parallel import (
    ShardedProblem as JShardedProblem,
    build_partition_maps as j_maps,
)
from savtpu.parallel.sharded import ShardedSolver as JSolver
from savtpu.solvers import setup_problem as j_setup

from savtpu_torch.config import Config as TConfig
from savtpu_torch.mesh import dirichlet_nodes
from savtpu_torch.parallel import (
    ShardedProblem as TShardedProblem,
    ShardedSolver as TSolver,
    build_partition_maps as t_maps,
    partition_elements,
)
from savtpu_torch.solvers import setup_problem as t_setup

torch.set_num_threads(1)

STEPS = 60
TOL = {"float64": 1e-12, "float32": 2e-4}


def _pair(dtype, fint_mode, compensated):
    cfgs = []
    for C in (JConfig, TConfig):
        cfg = C()
        cfg.beam_cells = (12, 2, 2)
        cfg.beam_extent = (6.0, 1.0, 1.0)
        cfgs.append(cfg)
    pj = j_setup(cfgs[0], dtype=getattr(jnp, dtype))
    pt = t_setup(cfgs[1], dtype=getattr(torch, dtype))
    m = pt.mesh
    ep = partition_elements(m.tetra, m.points, 4)
    dn = dirichlet_nodes(m.triangles, m.points)
    sj = JShardedProblem.build(
        pj, j_maps(m.tetra, ep, m.num_points, dn), fint_mode=fint_mode,
        dtype=getattr(jnp, dtype), compensated=compensated,
    )
    st = TShardedProblem.build(
        pt, t_maps(m.tetra, ep, m.num_points, dn), fint_mode=fint_mode,
        dtype=getattr(torch, dtype), compensated=compensated,
    )
    return pt, sj, st


def _inputs(pt, st, steps, seed=0):
    """Seeded initial displacement (zero velocity) and smooth sinusoidal
    shared-DOF predictions, as numpy."""
    rng = np.random.default_rng(seed)
    d0 = st.localize(1e-4 * rng.standard_normal(pt.ndof)).double().numpy()
    P, S3 = st.sld.shape
    t = np.arange(steps)[None, :, None]
    amp = rng.uniform(1e-5, 5e-5, (P, 1, S3))
    w = rng.uniform(0.01, 0.1, (P, 1, S3))
    return d0, amp * np.sin(w * t)


def _close(a, b, tol, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


def _run_both(dtype, fint_mode, compensated, sync, save_every, monkeypatch):
    monkeypatch.setattr(JShardedProblem, "_online_pallas_ok",
                        lambda self, *a, **k: False)
    pt, sj, st = _pair(dtype, fint_mode, compensated)
    d0, preds = _inputs(pt, st, STEPS)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    kw = dict(sync=sync, record="all", save_every=save_every)
    (tj, shj), cj = sj.stacked_run(
        jnp.asarray(d0, jd), jnp.asarray(d0, jd), 0.0, STEPS,
        preds=None if sync else jnp.asarray(preds, jd), **kw,
    )
    (tt, sht), ct = st.stacked_run(
        torch.as_tensor(d0, dtype=td), torch.as_tensor(d0, dtype=td), 0.0,
        STEPS, preds=None if sync else torch.as_tensor(preds, dtype=td),
        **kw,
    )
    tol = TOL[dtype]
    _close(tt.numpy(), tj, tol, "traj")
    _close(sht.numpy(), shj, tol, "shared")
    for a, b, name in zip(ct[:2], cj[:2], ("d", "d_prev")):
        _close(a.numpy(), b, tol, name)
    assert float(ct[2]) == pytest.approx(float(cj[2]), rel=1e-6)
    return tt


@pytest.mark.parametrize("save_every", [1, 5])
@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("fint_mode", ["banded", "dense"])
def test_compensated_stacked_run_f64(fint_mode, sync, save_every,
                                     monkeypatch):
    _run_both("float64", fint_mode, True, sync, save_every, monkeypatch)


@pytest.mark.parametrize("sync", [True, False])
def test_plain_stacked_run_f64(sync, monkeypatch):
    _run_both("float64", "dense", False, sync, 5, monkeypatch)


@pytest.mark.parametrize("sync", [True, False])
def test_compensated_stacked_run_f32(sync, monkeypatch):
    _run_both("float32", "banded", True, sync, 5, monkeypatch)


def test_run_streamed_matches_savtpu(monkeypatch):
    """Chunked exchanged runs (compensated re-entry at chunk boundaries)
    agree with savtpu's run_streamed on the same chunk plan."""
    pt, sj, st = _pair("float64", "banded", True)
    d0, _ = _inputs(pt, st, 30)
    (tj, shj), cj = JSolver(sj).run_streamed(
        jnp.asarray(d0), jnp.asarray(d0), 0.0, 30, sync=True,
        record="all", save_every=5, chunk_steps=10,
    )
    (tt, sht), ct = TSolver(st).run_streamed(
        torch.as_tensor(d0), torch.as_tensor(d0), 0.0, 30, sync=True,
        record="all", save_every=5, chunk_steps=10,
    )
    _close(tt, tj, 1e-12, "traj")
    _close(sht, shj, 1e-12, "shared")
    _close(ct[0].numpy(), cj[0], 1e-12, "d")


def test_run_streamed_long_run_starts_like_the_warmup():
    """A run longer than 16 probe lengths starts with two probe-sized
    chunks, as the JAX package's does, so its first rows equal those of
    the stage-4 warm-up (compensated chunk re-entry at the same steps)."""
    _, _, st = _pair("float32", "dense", True)
    d0 = torch.zeros((st.n_parts, st.DL), dtype=torch.float32)
    solver = TSolver(st)
    (warm, _), _ = solver.run_streamed(d0, d0, 0.0, 3000, sync=True,
                                       record="traj", save_every=50)
    (long, _), _ = solver.run_streamed(d0, d0, 0.0, 17000, sync=True,
                                       record="traj", save_every=50)
    np.testing.assert_array_equal(long[:, : warm.shape[1]], warm)
