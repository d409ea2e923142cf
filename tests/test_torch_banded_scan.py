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


# The launch plan shared by K3 and K4 (savtpu_torch/ops/band_plan.py).
# Band shapes (P, nc, Bk) of the sweep's banded cases, as the band builder
# makes them (test_band_shapes_of_sweep_cases checks the two 96x8x8 ones;
# 192x12x12/64 and 384x16x16/256 from the sweep's runs, PERF.md).
BAND_SHAPES = {
    "96x8x8/16": (16, 7, 256),    # the slice and the sweep's banded case
    "96x8x8/8": (8, 7, 512),      # bandwidth above 256: Bk 512
    "192x12x12/64": (64, 8, 256),
    "384x16x16/256": (256, 7, 256),
}
# cudaOccupancyMaxActiveClusters of the port's banded kernels on an H100
# 80GB HBM3 (132 SMs), clusters of B blocks with a full block's shared
# memory (PERF.md): the uneven GPCs hold 15 clusters of 8, not 16
H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
        10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


def test_band_shapes_of_sweep_cases():
    """The band builder's (P, nc, Bk) at the two 96x8x8 banded cases."""
    from savtpu_torch.benchmarks.sweep import build_case

    for tag, case in (("96x8x8/16", (96, 8, 8, 16)),
                      ("96x8x8/8", (96, 8, 8, 8))):
        _, sp = build_case(*case, "banded", device="cpu",
                           dtype=torch.float32)
        assert tuple(sp.band_Kd.shape[:3]) == BAND_SHAPES[tag]


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("tag,blocks,resident", [
    ("96x8x8/16", {F32: 6, F64: 6}, {F32: 189, F64: 82}),
    ("96x8x8/8", {F32: 9, F64: 9}, {F32: 87, F64: 31}),
    ("192x12x12/64", {F32: 2, F64: 2}, {F32: 152, F64: 41}),
    ("384x16x16/256", {F32: 1, F64: 2}, {F32: 112, F64: 47}),
])
def test_band_plan_for_sweep_and_slice_shapes(tag, blocks, resident,
                                              dtype):
    """band_plan on a 132-SM card with the H100's cluster table: the
    largest cluster whose P copies all run at once (16 parts: 15 clusters
    of 7 or 8 run at once, 17 of 6, so 6; 8 parts: 7 of 10-16, 9 of 9,
    so 9; 64 parts: 2), one block per part where the parts outnumber the
    SMs, or two where one block cannot hold a part's state (384x16x16/256
    in float64; clusters in waves); as many Kd rows resident as fit
    beside the state; the shared memory as band_layout_bytes counts it,
    within a block's."""
    from savtpu_torch.ops import kernels
    from savtpu_torch.ops.band_plan import (
        band_layout_bytes,
        band_plan,
        forced_band_plan,
    )

    P, nc, Bk = BAND_SHAPES[tag]
    it = 4 if dtype == torch.float32 else 8
    plan = band_plan(P, nc, Bk, dtype, 132, H100)
    B = blocks[dtype]
    assert (plan.blocks, plan.resident) == (B, resident[dtype])
    assert plan.rows == -(-nc * Bk // B)
    assert plan.smem == band_layout_bytes(nc, Bk, it, B, plan.resident)
    assert plan.smem <= kernels.SMEM_PER_BLOCK
    assert plan.smem + Bk * it > kernels.SMEM_PER_BLOCK  # one more: no
    # on a table where every size fits its SMs, 8 parts take 16 blocks
    even = {b: 132 // b for b in range(1, 17)}
    if P == 8:
        assert band_plan(P, nc, Bk, dtype, 132, even).blocks == 16
    # a card with fewer SMs than two per part: one block per part, or
    # where one block cannot hold the state, the fewest blocks that can
    # (96x8x8/8 float64: 3)
    fewest = min(b for b in range(1, 17) if forced_band_plan(
        nc, Bk, dtype, b).smem <= kernels.SMEM_PER_BLOCK)
    assert band_plan(P, nc, Bk, dtype, P, H100).blocks == fewest


def _rows_of(plan, DLB):
    return [range(b * plan.rows, min(DLB, (b + 1) * plan.rows))
            for b in range(plan.blocks)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_band_plan_fits_and_covers_the_rows(dtype):
    """Every plan band_plan or forced_band_plan gives, for the sweep's
    shapes and small ones (nc 1-3) at 1-16 blocks, fits 232,448 bytes,
    and its blocks' rows cover the part's DLB rows exactly once, each
    block's window holding its rows' chunks and the chunk before them."""
    from savtpu_torch.ops import kernels
    from savtpu_torch.ops.band_plan import band_plan, forced_band_plan

    shapes = [s[1:] for s in BAND_SHAPES.values()] + [(1, 256), (2, 256),
                                                      (3, 512)]
    seen = 0
    for nc, Bk in shapes:
        DLB = nc * Bk
        plans = [band_plan(P, nc, Bk, dtype, 132, t)
                 for P in (1, 2, 8, 16, 64, 256) for t in (H100, {})]
        for B in range(1, 17):
            for res in (None, 0):
                p = forced_band_plan(nc, Bk, dtype, B, res)
                if p.smem <= kernels.SMEM_PER_BLOCK:
                    plans.append(p)
        for plan in plans:
            assert plan.smem <= kernels.SMEM_PER_BLOCK, plan
            assert 0 <= plan.resident <= plan.rows
            rows = [i for r in _rows_of(plan, DLB) for i in r]
            assert sorted(rows) == list(range(DLB)), plan
            assert len(rows) == DLB
            for r in _rows_of(plan, DLB):
                if len(r):
                    lo = max(0, r[0] // Bk - 1) * Bk
                    hi = (r[-1] // Bk + 1) * Bk
                    assert hi - lo <= plan.window, plan
            seen += 1
    assert seen > 100


def test_banded_scan_plan_refused_on_cpu_and_when_it_does_not_fit():
    """plan= sets the CUDA kernel's launch: a CPU tensor refuses it, and
    a plan that does not fit the band's shape or a block is refused
    before anything runs."""
    import dataclasses

    from savtpu_torch.ops.band_plan import forced_band_plan

    _, st = _pair((25, 2, 2))
    P, nc, Bk, _ = st.band_Kd.shape
    d0, dn = _states(st)
    args = (st.band_Kd, st.band_Kl, torch.as_tensor(d0),
            torch.as_tensor(dn), 0.1, st.F_pre, st.lM, st.bc_mask)
    kw = dict(num_steps=5, dt=st.dt, alpha=st.alpha, ramped=True)
    good = forced_band_plan(nc, Bk, torch.float64, 2)
    before = scan_comm_free_banded.launches
    with pytest.raises(ValueError, match="CPU tensor"):
        scan_comm_free_banded(*args, plan=good, **kw)
    bad = [
        forced_band_plan(nc + 1, Bk, torch.float64, 2),   # another shape
        dataclasses.replace(good, resident=good.rows + 1),
        dataclasses.replace(good, smem=good.smem + 16),
        dataclasses.replace(good, blocks=17),
        forced_band_plan(8, 512, torch.float64, 1, 0),    # 359 KB
    ]
    for plan in bad:
        with pytest.raises(ValueError, match="does not fit"):
            scan_comm_free_banded(*args, plan=plan, **kw)
    assert scan_comm_free_banded.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_banded_scan_every_shape_matches_plain(dtype):
    """K4 on the card in every launch shape band_plan can take (forced:
    1, 3, 8, 12 and 16 blocks with resident rows, 5 streamed, and 2 with
    and without), at 25x2x2/2 (two chunks): bit for bit with the band
    zeroed, within RTOL with the band, the control rejected, two launches
    per check."""
    from savtpu_torch.benchmarks.sweep import build_case
    from savtpu_torch.ops.band_plan import cluster_table, forced_band_plan

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    _, sp = build_case(25, 2, 2, 2, "banded", device="cuda", dtype=dtype)
    P, nc, Bk, _ = sp.band_Kd.shape
    smoke = _smoke()
    table = cluster_table("banded_scan", dtype, sp.device)
    refs = smoke.banded_scan_references(
        *smoke.banded_scan_inputs(sp, 200, 2))
    plans = smoke.band_shapes(nc, Bk, dtype, table) + [
        forced_band_plan(nc, Bk, dtype, 2), forced_band_plan(nc, Bk, dtype,
                                                             2, 0)]
    assert len(plans) >= 5
    for plan in plans:
        before = scan_comm_free_banded.launches
        res = smoke.check_banded_scan(sp, 200, 2, plan=plan, refs=refs)
        torch.cuda.synchronize()
        assert scan_comm_free_banded.launches == before + 2, plan
        assert res["failures"] == [], (plan, res)
        assert res["rounding_kernel_max_abs"] == 0.0
