"""The dense local-K step kernels of the port (savtpu_torch/ops/
dense_step.py: K1 ``batched_fint_matvec``, K2 ``scan_comm_free``) and the
``fint_mode="pallas"`` solver around them, against savtpu's Pallas
kernels in interpret mode, as tests/test_pallas_step.py runs them.

The port keeps the dense layout in pallas mode (DL = 3 L_max + 1), where
savtpu pads DL to a multiple of 128; the two are compared on the real
slots. Tolerance: float64 1e-12 of each output's norm (only the sum order
of the matvec differs), float32 2e-4 (savtpu's own float32 bound).

The ``gpu`` legs hold the CUDA kernels against their plain versions with
chip_smoke.py's checks and limits; they skip where no CUDA device is
present. The module imports neither JAX nor savtpu at its top, so on a
machine with the card it runs as ``python -m pytest --noconftest -m gpu
tests/test_torch_dense_step.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from savtpu_torch.ops.dense_step import (
    batched_fint_matvec,
    batched_fint_matvec_plain,
    scan_comm_free,
    scan_comm_free_plain,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _pair(fint_mode, dtype="float64", cells=(8, 1, 1), n_parts=2,
          compensated=False):
    """The same beam, partition and mode through both packages: (the
    port's AssembledProblem, savtpu's ShardedProblem, the port's)."""
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
        pj, j_maps(m.tetra, ep, m.num_points, dn), fint_mode=fint_mode,
        dtype=getattr(jnp, dtype), compensated=compensated,
    )
    st = TShardedProblem.build(
        pt, t_maps(m.tetra, ep, m.num_points, dn), fint_mode=fint_mode,
        dtype=getattr(torch, dtype), compensated=compensated, device="cpu"
    )
    return pt, sj, st


def _real(a, n):
    """The first n (real) slots of the last axis, as float64 numpy."""
    return np.asarray(a, dtype=np.float64)[..., :n]


def _close(a, b, tol, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


def _state(st, seed=0):
    """A seeded displacement on the port's real slots, as numpy (P, DL)."""
    rng = np.random.default_rng(seed)
    return (1e-3 * rng.standard_normal((st.n_parts, st.DL))
            * st.dof_mask.double().cpu().numpy())


def _to_savtpu(sj, x):
    """(P, DL) port layout -> savtpu's padded pallas layout (P, DLp)."""
    import jax.numpy as jnp

    n = x.shape[1] - 1
    out = np.zeros((sj.n_parts, sj.DL))
    out[:, :n] = x[:, :n]
    return jnp.asarray(out, dtype=sj.lM.dtype)


def _preds(st, steps, seed=1):
    rng = np.random.default_rng(seed)
    P, S3 = st.sld.shape
    t = np.arange(steps)[None, :, None]
    return (rng.uniform(1e-5, 5e-5, (P, 1, S3))
            * np.sin(rng.uniform(0.01, 0.1, (P, 1, S3)) * t))


def test_unknown_fint_mode_rejected():
    """A misspelt mode is a ValueError, as in savtpu, and so is 'nh'
    without a Neo-Hookean material; every mode of savtpu builds, ell and
    ebe giving the dense mode's forces."""
    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu_torch.solvers import setup_problem

    cfg = Config()
    cfg.beam_cells = (8, 1, 1)
    cfg.beam_extent = (8.0, 1.0, 1.0)
    prob = setup_problem(cfg)
    m = prob.mesh
    maps = build_partition_maps(
        m.tetra, partition_elements(m.tetra, m.points, 2), m.num_points,
        dirichlet_nodes(m.triangles, m.points))
    with pytest.raises(ValueError, match="unknown fint_mode"):
        ShardedProblem.build(prob, maps, fint_mode="palas",  # typo
                             device="cpu")
    dense = ShardedProblem.build(prob, maps, fint_mode="dense", device="cpu")
    d = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (dense.n_parts, dense.DL))) * dense.dof_mask
    want = dense._fint_stacked(d)
    for mode in ("ell", "ebe"):
        sp = ShardedProblem.build(prob, maps, fint_mode=mode, device="cpu")
        assert sp.fint_mode == mode
        got = sp._fint_stacked(d)
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
    with pytest.raises(ValueError, match="NeoHookean"):
        ShardedProblem.build(prob, maps, fint_mode="nh", device="cpu")


def test_pallas_padding_and_matvec_matches_dense():
    """K1's plain version (the port's pallas F_int on the CPU) against
    savtpu's batched_fint_matvec on its 128-padded layout, and against
    the port's dense mode: the port does not pad."""
    import jax.numpy as jnp
    from savtpu.ops import pallas_step

    _, sj, st = _pair("pallas")
    _, _, sd = _pair("dense")
    assert st.DL == sd.DL and sj.DL % pallas_step.TILE == 0
    n = st.DL - 1
    d = _state(st)
    fj = pallas_step.batched_fint_matvec(sj.denseK, _to_savtpu(sj, d))
    ft = batched_fint_matvec(st.denseK, torch.as_tensor(d))
    _close(ft[:, :n].numpy(), _real(fj, n), 1e-12, "F_int vs savtpu")
    assert float(ft[:, n].abs().max()) == 0.0  # dummy slot
    _close(ft.numpy(), sd._fint_stacked(torch.as_tensor(d)).numpy(), 1e-12,
           "F_int vs dense")
    torch.testing.assert_close(ft, st._fint_stacked(torch.as_tensor(d)),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ft, batched_fint_matvec_plain(st.denseK, torch.as_tensor(d)),
        rtol=0, atol=0)
    assert np.abs(np.asarray(fj)[:, n:]).max() == 0.0
    assert jnp.asarray(fj).shape == (sj.n_parts, sj.DL)


def test_pallas_exchanged_run_matches_dense():
    """The pallas-mode exchanged run (K1 once per step) against savtpu's
    pallas exchanged run and the port's dense run, on the real slots."""
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedSolver as TSolver

    pt, sj, st = _pair("pallas")
    _, _, sd = _pair("dense")
    n, steps = st.DL - 1, 40
    d0, dn = st.localize(pt.d0), st.localize(pt.dn)
    before = batched_fint_matvec.launches
    (tt, sht), ct = TSolver(st).run(d0, dn, 0.0, steps, sync=True)
    assert batched_fint_matvec.launches == before  # the CPU runs no kernel
    (tj, shj), cj = JSolver(sj, mesh=None).run(
        sj.localize(np.asarray(pt.d0)), sj.localize(np.asarray(pt.dn)),
        0.0, steps, sync=True)
    _close(_real(tt, n), _real(tj, n), 1e-12, "traj")
    _close(sht.numpy(), shj, 1e-12, "shared")
    for a, b, name in zip(ct[:2], cj[:2], ("d", "d_prev")):
        _close(_real(a, n), _real(b, n), 1e-12, name)
    (td, _), _ = TSolver(sd).run(d0, dn, 0.0, steps, sync=True)
    _close(tt.numpy(), td.numpy(), 1e-12, "traj vs dense")


def test_pallas_whole_scan_kernel_matches_scan():
    """K2's plain version (ShardedSolver.run through the port's gate)
    against savtpu's pallas_scan_comm_free: final carry and shared rows,
    without and with predictions; and the perfect-prediction identity:
    fed the exchanged run's own shared rows, the comm-free run reproduces
    the exchanged run."""
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedSolver as TSolver

    pt, sj, st = _pair("pallas")
    n, steps = st.DL - 1, 30
    jsol, tsol = JSolver(sj, mesh=None), TSolver(st)
    d0 = _state(st)
    dj, dt_ = _to_savtpu(sj, d0), torch.as_tensor(d0)
    assert jsol._pallas_scan_ok(False, "shared", 1, steps)
    assert tsol._pallas_scan_ok(False, "shared", 1)
    preds = _preds(st, steps)
    for p in (None, preds):
        (tk, sk), ck = tsol.run(
            dt_, dt_, 0.0, steps, sync=False, record="shared",
            preds=None if p is None else torch.as_tensor(p))
        (tjk, sjk), cjk = jsol.run(dj, dj, 0.0, steps, sync=False,
                                   record="shared", preds=p)
        assert tk is None and tjk is None
        _close(sk.numpy(), sjk, 1e-12, "shared")
        for a, b, name in zip(ck[:2], cjk[:2], ("d", "d_prev")):
            _close(_real(a, n), _real(b, n), 1e-12, name)
        assert float(ck[2]) == pytest.approx(float(cjk[2]), rel=1e-14)

    (tx, shx), cx = tsol.run(dt_, dt_, 0.0, steps, sync=True)
    (_, shp), cp = tsol.run(dt_, dt_, 0.0, steps, sync=False, preds=shx,
                            record="shared")
    _close(shp.numpy(), shx.numpy(), 1e-12, "perfect-prediction shared")
    for a, b, name in zip(cp[:2], cx[:2], ("d", "d_prev")):
        _close(a.numpy(), b.numpy(), 1e-12, f"perfect-prediction {name}")


def test_pallas_compensated_runs_and_matches_dense():
    """Pallas with the compensated (double-word) state in float32: the
    generic compensated stepper with K1's F_int runs, and matches the
    dense mode (1e-6, savtpu's own bound for this test) and savtpu's
    pallas run (2e-4, savtpu's float32 bound)."""
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedSolver as TSolver

    runs = {}
    for mode in ("pallas", "dense"):
        pt, sj, st = _pair(mode, "float32", compensated=True)
        (traj, _), _ = TSolver(st).run(st.localize(pt.d0),
                                       st.localize(pt.dn), 0.0, 25,
                                       sync=True)
        runs[mode] = traj.numpy()
        if mode == "pallas":
            (tj, _), _ = JSolver(sj, mesh=None).run(
                sj.localize(np.asarray(pt.d0)),
                sj.localize(np.asarray(pt.dn)), 0.0, 25, sync=True)
            n = st.DL - 1
            _close(_real(traj, n), _real(tj, n), 2e-4, "vs savtpu")
    assert np.isfinite(runs["pallas"]).all()
    assert np.allclose(runs["pallas"], runs["dense"], atol=1e-6)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("fint_mode", ["pallas", "banded", "dense"])
def test_gates_agree_with_savtpu(fint_mode, compensated):
    """The port's K2 and K4 gates take the same runs as savtpu's
    _pallas_scan_ok and _banded_scan_ok over (sync, record, preds,
    save_every); at this size savtpu's VMEM rule admits everything, and
    the port's shared-memory rule too."""
    import itertools

    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedSolver as TSolver

    _, sj, st = _pair(fint_mode, compensated=compensated)
    jsol, tsol = JSolver(sj, mesh=None), TSolver(st)
    steps, seen = 30, set()
    for sync, record, use_preds, save_every in itertools.product(
            (True, False), ("all", "traj", "shared", "none"), (False, True),
            (1, 5)):
        preds = np.zeros((1,)) if use_preds else None
        k2 = tsol._pallas_scan_ok(sync, record, save_every)
        assert k2 == jsol._pallas_scan_ok(sync, record, save_every, steps)
        k4 = tsol._banded_scan_ok(sync, record, preds)
        assert k4 == jsol._banded_scan_ok(sync, record, preds, None)
        seen.add((k2, k4))
    expect = {("pallas", False): {(True, False), (False, False)},
              ("banded", False): {(False, True), (False, False)}}
    assert seen == expect.get((fint_mode, compensated), {(False, False)})


def test_converted_pallas_problem_matches_savtpu():
    """savtpu's pallas arrays (128-padded, dummy at the padded DL-1) carried
    over by convert.from_savtpu_arrays: the converted problem's K1 and K2
    results equal savtpu's on the real slots."""
    from savtpu.ops import pallas_step
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.convert import from_savtpu_arrays
    from savtpu_torch.parallel import ShardedSolver as TSolver

    _, sj, st = _pair("pallas")
    fields = ("n_parts", "DL", "SD", "dt", "alpha", "ramped", "fint_mode",
              "compensated", "local_dofs_global", "dof_mask", "bc_mask",
              "lM", "F_pre", "sld", "sgi", "smask", "denseK")
    arrays = {k: getattr(sj, k) for k in fields}
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in arrays.items()}
    assert arrays["DL"] > st.DL  # savtpu padded
    sc, _ = from_savtpu_arrays(arrays, device="cpu")
    assert sc.DL == st.DL and sc.fint_mode == "pallas"
    for k in ("dof_mask", "bc_mask", "sld"):
        torch.testing.assert_close(getattr(sc, k), getattr(st, k), rtol=0,
                                   atol=0)
    for k in ("lM", "F_pre", "denseK"):
        _close(getattr(sc, k).numpy(), getattr(st, k).numpy(), 1e-12, k)
    n, steps = st.DL - 1, 30
    d0 = _state(st)
    dj = _to_savtpu(sj, d0)
    ft = batched_fint_matvec(sc.denseK, torch.as_tensor(d0))
    fj = pallas_step.batched_fint_matvec(sj.denseK, dj)
    _close(ft[:, :n].numpy(), _real(fj, n), 1e-12, "K1")
    preds = _preds(st, steps)
    (_, sk), ck = TSolver(sc).run(
        torch.as_tensor(d0), torch.as_tensor(d0), 0.0, steps, sync=False,
        record="shared", preds=torch.as_tensor(preds))
    (_, sjk), cjk = JSolver(sj, mesh=None).run(
        dj, dj, 0.0, steps, sync=False, record="shared", preds=preds)
    _close(sk.numpy(), sjk, 1e-12, "K2 shared")
    for a, b, name in zip(ck[:2], cjk[:2], ("d", "d_prev")):
        _close(_real(a, n), _real(b, n), 1e-12, f"K2 {name}")


def test_wrappers_take_plain_versions_on_cpu():
    """On the CPU the wrappers are their plain versions, exactly, and
    count no launch."""
    from savtpu_torch.benchmarks.sweep import build_case

    _, sp = build_case(8, 1, 1, 2, "pallas", device="cpu",
                       dtype=torch.float64)
    d = torch.as_tensor(_state(sp))
    before = (batched_fint_matvec.launches, scan_comm_free.launches)
    torch.testing.assert_close(batched_fint_matvec(sp.denseK, d),
                               batched_fint_matvec_plain(sp.denseK, d),
                               rtol=0, atol=0)
    args = (sp.denseK, d, d, 0.1, sp.F_pre, sp.lM, sp.bc_mask, sp.sld,
            sp.smask, torch.as_tensor(_preds(sp, 10)))
    kw = dict(num_steps=10, dt=sp.dt, alpha=sp.alpha, ramped=True,
              record_shared=True)
    for a, b in zip(scan_comm_free(*args, **kw),
                    scan_comm_free_plain(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (batched_fint_matvec.launches,
            scan_comm_free.launches) == before


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_kernel_checks_reject_controls_on_cpu():
    """chip_smoke.py's K1 and K2 checks on the CPU, where each wrapper is
    its plain version: the kernel passes, and each control (K1: a TF32
    product; K2: the overwrite dropped) is rejected by the comparison
    that passes the kernel."""
    from savtpu_torch.benchmarks.sweep import build_case

    smoke = _smoke()
    _, sp = build_case(8, 1, 1, 2, "pallas", device="cpu",
                       dtype=torch.float32)
    d = torch.as_tensor(_state(sp), dtype=torch.float32)
    for res in (smoke.check_fint_matvec(sp.denseK, d),
                smoke.check_scan_comm_free(sp, 100, 1)):
        assert res["failures"] == [], res
        assert res["kernel_max_rel"] == 0.0
        assert res["control_max_rel"] > res["rtol"]


def _card_problem(dtype):
    """The sweep's 48x4x4 / 8-part pallas problem on the card (DL 526)."""
    from savtpu_torch.benchmarks.sweep import build_case

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return build_case(48, 4, 4, 8, "pallas", device="cuda", dtype=dtype)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_matvec_matches_plain(dtype):
    """K1 on the card within MATVEC_RTOL of its plain version; the TF32
    control is rejected (chip_smoke.py's check)."""
    sp = _card_problem(dtype)
    d = torch.as_tensor(_state(sp), dtype=dtype, device="cuda")
    before = batched_fint_matvec.launches
    res = _smoke().check_fint_matvec(sp.denseK, d)
    torch.cuda.synchronize()
    assert batched_fint_matvec.launches == before + 1
    assert res["failures"] == [], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_scan_matches_plain(dtype):
    """K2 on the card: bit for bit with K zeroed, within SCAN_RTOL with K,
    with and without predictions; the dropped-overwrite control is
    rejected (chip_smoke.py's check)."""
    sp = _card_problem(dtype)
    before = scan_comm_free.launches
    res = _smoke().check_scan_comm_free(sp, 300, 1)
    torch.cuda.synchronize()
    assert scan_comm_free.launches == before + 4
    assert res["failures"] == [], res
    assert res["rounding_kernel_max_abs"] == 0.0


def _sweep_DL(nx, ny, nz, n_parts):
    """A sweep case's pallas DL (3 L_max + 1), from its mesh and RCB
    partition alone (sweep.build_case's)."""
    from savtpu_torch.mesh import beam_mesh, dirichlet_nodes
    from savtpu_torch.parallel import build_partition_maps, partition_elements

    m = beam_mesh(nx, ny, nz, (float(nx) / max(ny, 1), 1.0, 1.0))
    maps = build_partition_maps(
        m.tetra, partition_elements(m.tetra, m.points, n_parts, "rcb"),
        m.num_points, dirichlet_nodes(m.triangles, m.points))
    return 3 * maps.max_local_nodes + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,DL,blocks,resident", [
    ((25, 1, 1, 2), 163, 1, True),      # one part's K fits one block
    ((48, 4, 4, 8), 526, 16, True),     # 33 rows of K per block resident
    ((96, 8, 8, 8), 3160, 16, False),   # 320 MB of K streamed every step
])
def test_scan_plan_for_sweep_cases(case, DL, blocks, resident, dtype):
    """K2's plan for the sweep's three pallas cases on an H100 (132 SMs,
    227 KB of shared memory a block): one block per part exactly where one
    part's K fits a block beside the state; else P B <= the SM count,
    every block with at least one row, and the resident rows within the
    block's shared memory."""
    from savtpu_torch.ops import kernels
    from savtpu_torch.ops.dense_step import forced_plan, scan_plan

    assert _sweep_DL(*case) == DL
    P, it, sms = case[3], (4 if dtype == torch.float32 else 8), 132
    plan = scan_plan(P, DL, dtype, sms)
    assert (plan.blocks, plan.resident) == (blocks, resident)
    whole_k = 6 * DL * it + 4 * DL + DL * DL * it
    assert (plan.blocks == 1) == (whole_k <= kernels.SMEM_PER_BLOCK)
    assert plan.smem <= kernels.SMEM_PER_BLOCK
    assert plan.blocks * plan.rows >= DL > (plan.blocks - 1) * plan.rows
    if plan.blocks > 1:
        assert P * plan.blocks <= sms
        if plan.resident:
            assert plan.rows * DL * it < plan.smem
        else:   # the rows would not fit
            assert forced_plan(DL, dtype, plan.blocks, True).smem > (
                kernels.SMEM_PER_BLOCK)
    # a card with fewer SMs than two per part: one block per part
    assert scan_plan(P, DL, dtype, P).blocks == 1


def _card_plans(dtype):
    """Every K2 launch shape at the sweep's 48x4x4 / 8-part size: the plan
    (16 blocks per part, resident), resident in 12 blocks, streamed in 16
    and 2 blocks, and one block per part streamed."""
    from savtpu_torch.ops.dense_step import forced_plan

    return [forced_plan(526, dtype, b, r)
            for b, r in ((16, True), (12, True), (16, False), (2, False),
                         (1, False))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forced_card_plans_fit(dtype):
    """Every launch shape the gpu leg forces at 48x4x4/8 fits an H100:
    shared memory within a block's, 8 parts' blocks within 132 SMs, and
    no block without rows."""
    from savtpu_torch.ops import kernels

    shapes = set()
    for plan in _card_plans(dtype):
        assert plan.smem <= kernels.SMEM_PER_BLOCK, plan
        assert plan.blocks == 1 or 8 * plan.blocks <= 132, plan
        assert plan.blocks * plan.rows >= 526 > (plan.blocks - 1) * plan.rows
        shapes.add((plan.blocks > 1, plan.resident))
    assert shapes == {(True, True), (True, False), (False, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_scan_every_plan_matches_plain(dtype):
    """K2 on the card in each launch shape the plan can take, forced at
    48x4x4/8: bit for bit with K zeroed, within SCAN_RTOL with K, with and
    without predictions; the dropped-overwrite control is rejected; one
    launch per run."""
    sp = _card_problem(dtype)
    assert sp.DL == 526
    smoke = _smoke()
    for plan in _card_plans(dtype):
        before = scan_comm_free.launches
        res = smoke.check_scan_comm_free(sp, 200, 1, plan=plan)
        torch.cuda.synchronize()
        assert scan_comm_free.launches == before + 4, plan
        assert res["failures"] == [], (plan, res)


@pytest.mark.gpu
def test_cuda_scan_one_block_resident_matches_plain():
    """The one-block kernel with K in shared memory (the sweep's
    25x1x1/2 plan) against its plain version."""
    from savtpu_torch.benchmarks.sweep import build_case
    from savtpu_torch.ops.dense_step import scan_plan, sm_count

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    sp = build_case(25, 1, 1, 2, "pallas", device="cuda")[1]
    plan = scan_plan(sp.n_parts, sp.DL, sp.dtype, sm_count(sp.device))
    assert (plan.blocks, plan.resident) == (1, True)
    res = _smoke().check_scan_comm_free(sp, 500, 1)
    assert res["failures"] == [], res
