"""K4, the banded comm-free scan of the port (savtpu_torch/ops/
banded_scan.py), against savtpu's ``pallas_scan_comm_free_banded`` in
interpret mode, as tests/test_pallas_step.py runs it: cells (8,1,1) give
one band chunk, (25,2,2) three, so the sub- and super-diagonal terms run.

Tolerance: float64 1e-12 of each output's norm (only the band matvec's
sum order differs).

The ``gpu`` legs hold the CUDA kernel against its plain version with
chip_smoke.py's check and limit; they skip where no CUDA device is
present. The module imports neither JAX nor savtpu at its top, so on a
machine with the card it runs as ``python -m pytest --noconftest -m gpu
tests/test_torch_banded_scan.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from savtpu_torch.ops.banded_scan import (
    scan_comm_free_banded,
    scan_comm_free_banded_plain,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 30


def _pair(cells, dtype="float64", n_parts=2):
    """The same banded problem through both packages: (savtpu's
    ShardedProblem, the port's)."""
    import jax.numpy as jnp
    from savtpu.config import Config as JConfig
    from savtpu.parallel import ShardedProblem as JShardedProblem
    from savtpu.parallel import build_partition_maps as j_maps
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.config import Config as TConfig
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import ShardedProblem as TShardedProblem
    from savtpu_torch.parallel import build_partition_maps as t_maps
    from savtpu_torch.parallel import partition_elements
    from savtpu_torch.solvers import setup_problem as t_setup

    cfgs = []
    for C in (JConfig, TConfig):
        cfg = C()
        cfg.beam_cells = cells
        cfg.beam_extent = (float(cells[0]) / max(cells[1], 1), 1.0, 1.0)
        cfgs.append(cfg)
    pj = j_setup(cfgs[0], dtype=getattr(jnp, dtype))
    pt = t_setup(cfgs[1], dtype=getattr(torch, dtype))
    m = pt.mesh
    ep = partition_elements(m.tetra, m.points, n_parts)
    dn = dirichlet_nodes(m.triangles, m.points)
    sj = JShardedProblem.build(
        pj, j_maps(m.tetra, ep, m.num_points, dn), fint_mode="banded",
        dtype=getattr(jnp, dtype),
    )
    st = TShardedProblem.build(
        pt, t_maps(m.tetra, ep, m.num_points, dn), fint_mode="banded",
        dtype=getattr(torch, dtype),
    )
    return sj, st


def _close(a, b, tol, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


def _states(st, seed=0):
    """Seeded (d0, dn) on the real slots, as numpy (P, DL)."""
    rng = np.random.default_rng(seed)
    m = st.dof_mask.double().cpu().numpy()
    d0 = 1e-3 * rng.standard_normal(m.shape) * m
    return d0, d0 - 1e-6 * rng.standard_normal(m.shape) * m


@pytest.mark.parametrize("cells", [(8, 1, 1), (25, 2, 2)])
def test_banded_whole_scan_kernel_matches_scan(cells):
    """A comm-free banded run with record="none" goes through K4's gate
    in both packages; the port's plain version equals savtpu's kernel and
    the port's own generic comm-free stepper (record="all")."""
    import jax.numpy as jnp
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedSolver as TSolver

    sj, st = _pair(cells)
    assert st.band_Kd.shape == sj.band_Kd.shape
    if cells == (25, 2, 2):
        assert st.band_Kd.shape[1] > 1
    jsol, tsol = JSolver(sj, mesh=None), TSolver(st)
    d0, dn = _states(st)
    assert jsol._banded_scan_ok(False, "none", None, None)
    assert tsol._banded_scan_ok(False, "none", None)
    before = scan_comm_free_banded.launches
    (t_none, s_none), ck = tsol.run(torch.as_tensor(d0),
                                    torch.as_tensor(dn), 0.25, STEPS,
                                    sync=False, record="none")
    assert t_none is None and s_none is None
    assert scan_comm_free_banded.launches == before  # the CPU: plain
    (_, _), cj = jsol.run(jnp.asarray(d0), jnp.asarray(dn), 0.25, STEPS,
                          sync=False, record="none")
    for a, b, name in zip(ck, cj, ("d", "d_prev", "t")):
        _close(a.numpy(), b, 1e-12, name)
    (_, _), cs = tsol.run(torch.as_tensor(d0), torch.as_tensor(dn), 0.25,
                          STEPS, sync=False, record="all")
    for a, b, name in zip(ck, cs, ("d", "d_prev", "t")):
        _close(a.numpy(), b.numpy(), 1e-12, f"{name} vs generic stepper")


@pytest.mark.parametrize("cells", [(8, 1, 1), (25, 2, 2)])
def test_plain_matches_pallas_kernel_directly(cells):
    """K4's plain version and savtpu's pallas_scan_comm_free_banded on
    the same arrays, unramped from t0 = 2 and ramped from t0 = 0.9 (the
    ramp's end inside the run)."""
    import jax.numpy as jnp
    from savtpu.ops.pallas_banded import pallas_scan_comm_free_banded

    sj, st = _pair(cells)
    d0, dn = _states(st, seed=3)
    for t0 in (2.0, 0.9):
        kw = dict(num_steps=STEPS, dt=st.dt, alpha=st.alpha,
                  ramped=st.ramped)
        ot = scan_comm_free_banded_plain(
            st.band_Kd, st.band_Kl, torch.as_tensor(d0),
            torch.as_tensor(dn), t0, st.F_pre, st.lM, st.bc_mask, **kw)
        oj = pallas_scan_comm_free_banded(
            sj.band_Kd, sj.band_Kl, jnp.asarray(d0), jnp.asarray(dn),
            jnp.asarray(t0), sj.F_pre, sj.lM, sj.bc_mask, **kw)
        for a, b, name in zip(ot, oj, ("d", "d_prev", "t")):
            _close(a.numpy(), np.asarray(b), 1e-12, f"{name} t0={t0}")


def test_wrapper_takes_plain_version_on_cpu():
    """On the CPU the wrapper is the plain version, exactly."""
    _, st = _pair((25, 2, 2))
    d0, dn = _states(st)
    args = (st.band_Kd, st.band_Kl, torch.as_tensor(d0),
            torch.as_tensor(dn), 0.1, st.F_pre, st.lM, st.bc_mask)
    kw = dict(num_steps=10, dt=st.dt, alpha=st.alpha, ramped=True)
    before = scan_comm_free_banded.launches
    for a, b in zip(scan_comm_free_banded(*args, **kw),
                    scan_comm_free_banded_plain(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert scan_comm_free_banded.launches == before


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_kernel_check_rejects_control_on_cpu():
    """chip_smoke.py's K4 check on the CPU, where the wrapper is the plain
    version: the kernel passes, and the control (the band matvec without
    its super-diagonal term) is rejected by the same comparison."""
    from savtpu_torch.benchmarks.sweep import build_case

    _, sp = build_case(25, 2, 2, 2, "banded", device="cpu",
                       dtype=torch.float32)
    assert sp.band_Kd.shape[1] > 1
    res = _smoke().check_banded_scan(sp, 100, 2)
    assert res["failures"] == [], res
    assert res["kernel_max_rel"] == 0.0
    assert res["control_max_rel"] > res["rtol"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_banded_scan_matches_plain(dtype):
    """K4 on the card: bit for bit with the band zeroed, within RTOL with
    the band; the no-super-diagonal control is rejected (chip_smoke.py's
    check)."""
    from savtpu_torch.benchmarks.sweep import build_case

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    _, sp = build_case(25, 2, 2, 2, "banded", device="cuda", dtype=dtype)
    before = scan_comm_free_banded.launches
    res = _smoke().check_banded_scan(sp, 300, 2)
    torch.cuda.synchronize()
    assert scan_comm_free_banded.launches == before + 2
    assert res["failures"] == [], res
    assert res["rounding_kernel_max_abs"] == 0.0
