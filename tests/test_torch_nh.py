"""The port's Neo-Hookean path against savtpu's: the material and the
per-element twin, the incident-list and stencil forces, whole
trajectories, the gates of K2-K4, and savtpu problems carried across by
convert.from_savtpu_arrays.

Tolerances: float64 1e-12 of each output's norm (the packages sum the
element math and the assembly in other orders). float32 trajectories:
2e-4 of the norm, the bound tests/test_torch_sharded.py holds the linear
modes to; on these inputs the packages differ by 3.7e-6 to 5.7e-6
(measured), float32's eps over the 1e-2 strain (see ``_inputs``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.ops import element as j_element
from savtpu.ops.material import NeoHookean as JNeoHookean
from savtpu.parallel import ShardedProblem as JShardedProblem
from savtpu.parallel import build_partition_maps as j_maps
from savtpu.parallel.sharded import ShardedSolver as JSolver
from savtpu.solvers import setup_problem as j_setup

from savtpu_torch.config import Config as TConfig
from savtpu_torch.convert import from_savtpu_arrays
from savtpu_torch.mesh import dirichlet_nodes
from savtpu_torch.ops.element import neo_hookean_element_fint
from savtpu_torch.ops.material import NeoHookean as TNeoHookean
from savtpu_torch.parallel import ShardedProblem as TShardedProblem
from savtpu_torch.parallel import ShardedSolver as TSolver
from savtpu_torch.parallel import build_partition_maps as t_maps
from savtpu_torch.parallel import partition_elements
from savtpu_torch.solvers import setup_problem as t_setup

torch.set_num_threads(1)

TOL = {"float64": 1e-12, "float32": 2e-4}
MAT = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)
# (cells, parts, partition method, build keywords): three-axis boxes
# (stencil), the same with the grid exchange, and RCB parts that cut
# cells (incident-list gather)
CASES = {
    "stencil": ((8, 4, 4), 16, "box", {}),
    "stencil_grid": ((8, 4, 4), 16, "box", dict(exchange_mode="grid")),
    "incident": ((7, 2, 2), 3, "rcb", dict(nh_gather="incident")),
}


def _problems(cells, dtype="float64"):
    cfgs = []
    for C in (JConfig, TConfig):
        cfg = C()
        cfg.beam_cells = cells
        cfg.beam_extent = tuple(float(c) for c in cells)
        cfgs.append(cfg)
    return (j_setup(cfgs[0], dtype=getattr(jnp, dtype)),
            t_setup(cfgs[1], dtype=getattr(torch, dtype)))


def _pair(case, dtype="float64", **extra):
    cells, n_parts, method, kw = CASES[case]
    pj, pt = _problems(cells, dtype)
    m = pt.mesh
    ep = partition_elements(m.tetra, m.points, n_parts, method)
    dn = dirichlet_nodes(m.triangles, m.points)
    kw = dict(kw, dtype=None, **extra)
    sj = JShardedProblem.build(
        pj, j_maps(m.tetra, ep, m.num_points, dn),
        material=JNeoHookean.from_engineering(**MAT), **kw)
    st = TShardedProblem.build(
        pt, t_maps(m.tetra, ep, m.num_points, dn),
        material=TNeoHookean.from_engineering(**MAT), **kw, device="cpu")
    assert st.fint_mode == sj.fint_mode == "nh"
    assert st.nhs_dims == sj.nhs_dims
    np.testing.assert_array_equal(st.local_dofs_global, sj.local_dofs_global)
    return pt, sj, st


def _close(a, b, tol, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


def _strained(st, seed=0):
    """A seeded displacement with a strain near 1e-2 (unit cells)."""
    rng = np.random.default_rng(seed)
    return 1e-2 * rng.standard_normal((st.n_parts, st.DL)) * (
        st.dof_mask.numpy())


def test_first_piola_and_element_force_equal_savtpus():
    rng = np.random.default_rng(0)
    F = np.eye(3) + 0.05 * rng.standard_normal((64, 3, 3))
    mj, mt = JNeoHookean.from_engineering(**MAT), TNeoHookean.from_engineering(
        **MAT)
    got = mt.first_piola(torch.as_tensor(F)).numpy()
    want = np.asarray(jax.vmap(mj.first_piola)(jnp.asarray(F)))
    _close(got, want, 1e-12, "first_piola")
    # element twin: reference tets of a beam with seeded displacements
    _, pt = _problems((3, 1, 1))
    P = pt.coords.numpy()
    d_e = 1e-2 * rng.standard_normal((P.shape[0], 12))
    got = neo_hookean_element_fint(mt, torch.as_tensor(P),
                                   torch.as_tensor(d_e)).numpy()
    want = np.asarray(jax.vmap(
        lambda p, d: j_element.neo_hookean_element_fint(mj, p, d))(
        jnp.asarray(P), jnp.asarray(d_e)))
    _close(got, want, 1e-12, "element fint")


@pytest.mark.parametrize("case", list(CASES))
def test_fint_equals_savtpus(case):
    _, sj, st = _pair(case)
    d = _strained(st)
    got = st._fint_stacked(torch.as_tensor(d)).numpy()
    want = np.asarray(sj._fint_stacked(jnp.asarray(d)))
    _close(got, want, 1e-12, case)


def _per_part_global(st, F, ndof):
    """(P, DL) per-part values -> (P, ndof) by global DOF (0 elsewhere)."""
    out = np.zeros((st.n_parts, ndof))
    for p in range(st.n_parts):
        n = int(st.dof_mask[p].sum())
        out[p, st.local_dofs_global[p, :n]] = F[p, :n]
    return out


def test_stencil_equals_incident_and_element_twin():
    """The port's stencil force (lex order) against its own incident-list
    force (first-touch order) and against the per-element twin summed by
    global DOF, part by part."""
    pt, _, ss = _pair("stencil")
    cells, n_parts, method, _ = CASES["stencil"]
    m = pt.mesh
    ep = partition_elements(m.tetra, m.points, n_parts, method)
    maps = t_maps(m.tetra, ep, m.num_points,
                  dirichlet_nodes(m.triangles, m.points))
    mat = TNeoHookean.from_engineering(**MAT)
    si = TShardedProblem.build(pt, maps, material=mat, nh_stencil="off",
                               nh_gather="incident", device="cpu")
    assert si.nhs_dims is None and ss.nhs_dims is not None
    rng = np.random.default_rng(1)
    dg = 1e-2 * rng.standard_normal(pt.ndof)
    fs = ss._fint_stacked(ss.localize(dg)).numpy()
    fi = si._fint_stacked(si.localize(dg)).numpy()
    gs, gi = (_per_part_global(s, f, pt.ndof)
              for s, f in ((ss, fs), (si, fi)))
    _close(gs, gi, 1e-12, "stencil vs incident")
    # the twin: each part's elements, scattered by global DOF
    twin = np.zeros_like(gs)
    fe = neo_hookean_element_fint(mat, pt.coords, torch.as_tensor(
        dg[pt.edofs])).numpy()
    for p in range(n_parts):
        e = maps.local_elements[p]
        np.add.at(twin[p], pt.edofs[e].reshape(-1), fe[e].reshape(-1))
    _close(gs, twin, 1e-12, "stencil vs element twin")


def _inputs(st, steps, seed=0):
    """A seeded state with a strain near 1e-2 and smooth predictions of
    the same size. Near F = I the first Piola stress cancels to O(strain)
    (mu F against mu F^-T), so two sum orders agree to about eps / strain
    relative: 1e-14 here, 1e-12 at the 1e-4 strains of the linear tests'
    inputs."""
    rng = np.random.default_rng(seed)
    d0 = _strained(st, seed)
    P, S3 = st.sld.shape
    t = np.arange(steps)[None, :, None]
    amp = rng.uniform(1e-3, 5e-3, (P, 1, S3))
    w = rng.uniform(0.01, 0.1, (P, 1, S3))
    return d0, amp * np.sin(w * t) * st.smask.numpy()[:, None, :]


def _run_both(case, dtype, compensated, sync):
    _, sj, st = _pair(case, dtype, compensated=compensated)
    steps = 40
    d0, preds = _inputs(st, steps)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(sync=sync, record="all", save_every=5)
    (tj, shj), cj = JSolver(sj).run(
        jnp.asarray(d0, jd), jnp.asarray(d0, jd), 0.0, steps,
        preds=None if sync else jnp.asarray(preds, jd), **kw)
    (tt, sht), ct = TSolver(st).run(
        torch.as_tensor(d0, dtype=td), torch.as_tensor(d0, dtype=td), 0.0,
        steps, preds=None if sync else torch.as_tensor(preds, dtype=td),
        **kw)
    tol = TOL[dtype]
    _close(tt.numpy(), tj, tol, "traj")
    _close(sht.numpy(), shj, tol, "shared")
    for a, b, name in zip(ct[:2], cj[:2], ("d", "d_prev")):
        _close(a.numpy(), b, tol, name)


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_trajectories_equal_savtpus_f64(case, compensated, sync):
    """Exchanged and comm-free with predictions, plain and compensated."""
    _run_both(case, "float64", compensated, sync)


@pytest.mark.parametrize("sync", [True, False])
def test_compensated_trajectories_f32(sync):
    _run_both("stencil_grid", "float32", True, sync)


def test_window_layout_equals_savtpu():
    """nh_gather 'auto' off a box partition is savtpu's windowed layout:
    the port builds it on the same RCM order with the same metadata, and
    its forces equal savtpu's window forces and the port's incident-list
    forces at 1e-12 ('window' is the same layout, and a Neo-Hookean mode
    without a material still raises)."""
    cells, n_parts, method, _ = CASES["incident"]
    pj, pt = _problems(cells)
    m = pt.mesh
    ep = partition_elements(m.tetra, m.points, n_parts, method)
    dn = dirichlet_nodes(m.triangles, m.points)
    mj = j_maps(m.tetra, ep, m.num_points, dn)
    mt = t_maps(m.tetra, ep, m.num_points, dn)
    sj = JShardedProblem.build(pj, mj,
                               material=JNeoHookean.from_engineering(**MAT))
    mat = TNeoHookean.from_engineering(**MAT)
    built = {g: TShardedProblem.build(pt, mt, material=mat, nh_gather=g,
                                      device="cpu")
             for g in ("auto", "window", "incident")}
    st = built["auto"]
    assert st.nhw_W == sj.nhw_W == built["window"].nhw_W
    np.testing.assert_array_equal(st.nhw_w0, np.asarray(sj.nhw_w0))
    np.testing.assert_array_equal(st.nhw_idx, np.asarray(sj.nhw_idx))
    # the port's element slots come in savtpu's chunk order
    G, dJw = np.asarray(sj.nhw_G), np.asarray(sj.nhw_dJw)
    np.testing.assert_array_equal(st.nh_G.numpy().reshape(G.shape), G)
    np.testing.assert_array_equal(st.nh_detJw.numpy().reshape(dJw.shape),
                                  dJw)
    np.testing.assert_array_equal(st.local_dofs_global, sj.local_dofs_global)
    rng = np.random.default_rng(0)
    dg = 1e-3 * rng.standard_normal(pt.ndof)
    want = np.asarray(sj._nh_fint_window(sj.localize(dg)))
    scale = np.abs(want).max()
    for g in ("auto", "window"):
        got = built[g]._fint_stacked(built[g].localize(dg)).numpy()
        assert np.abs(got - want).max() / scale < TOL["float64"], g
    inc = built["incident"]
    fi = np.zeros(pt.ndof)
    fw = np.zeros(pt.ndof)
    for sp, acc in ((inc, fi), (st, fw)):
        F = sp._fint_stacked(sp.localize(dg)).numpy()
        for p in range(sp.n_parts):
            n = int(sp.dof_mask[p].sum())
            acc[sp.local_dofs_global[p, :n]] += F[p, :n]
    assert np.abs(fw - fi).max() / np.abs(fi).max() < TOL["float64"]
    with pytest.raises(ValueError, match="NeoHookean"):
        TShardedProblem.build(pt, mt, fint_mode="nh", device="cpu")


@pytest.mark.parametrize("mode", ["nh", "stencil"])
def test_kernel_gates_refuse_new_modes(mode):
    """K2 (pallas scan), K3 (the online kernel) and K4 (banded scan) are
    refused in the matrix-free modes, as savtpu refuses its Pallas
    kernels there, under the conditions most favourable to each."""
    if mode == "nh":
        _, sj, st = _pair("stencil")
    else:
        from test_torch_stencil import _pair as lin_pair

        _, sj, st = lin_pair((8, 4, 4), 16, fint_mode="stencil",
                             compensated=True)
    js, ts = JSolver(sj), TSolver(st)
    preds = torch.zeros((st.n_parts, 50, st.sld.shape[1]),
                        dtype=torch.float64)
    assert not ts._pallas_scan_ok(False, "none", 1)
    assert not js._pallas_scan_ok(False, "none", 1, 50)
    assert not ts._banded_scan_ok(False, "none", None)
    assert not js._banded_scan_ok(False, "none", None, None)
    comp = dataclasses.replace(st, compensated=True)
    assert not comp._online_ok(False, preds, "all", 5, 50)
    assert not dataclasses.replace(sj, compensated=True)._online_pallas_ok(
        False, jnp.asarray(preds.numpy()), None, "all", 5, 50, jnp.float32)


def _savtpu_arrays(sj):
    """savtpu's problem fields as the numpy the converter takes."""
    out = {}
    for f in dataclasses.fields(sj):
        v = getattr(sj, f.name)
        if f.name in ("maps", "nx_pairs", "grid_pairs") or v is None:
            continue
        if f.name == "nh_material":
            v = dataclasses.asdict(v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("mode", ["nh_incident", "nh_stencil", "stencil",
                                  "grid"])
def test_converted_problem_steps_like_savtpu(mode):
    """savtpu's problem in each new mode, carried across by
    from_savtpu_arrays: one exchanged step of both packages agrees."""
    if mode.startswith("nh"):
        _, sj, _ = _pair("incident" if mode == "nh_incident"
                         else "stencil_grid")
    else:
        from test_torch_stencil import _pair as lin_pair

        _, sj, _ = lin_pair((8, 4, 4), 16,
                            **({"fint_mode": "stencil"} if mode == "stencil"
                               else {"exchange_mode": "grid"}))
    sc, _ = from_savtpu_arrays(_savtpu_arrays(sj), device="cpu")
    assert sc.fint_mode == sj.fint_mode
    assert sc.exchange_mode == sj.exchange_mode
    d0 = _strained(sc)
    for sync in (True, False):
        (tj, _), _ = JSolver(sj).run(jnp.asarray(d0), jnp.asarray(d0), 0.0,
                                     1, sync=sync, record="traj")
        (tt, _), _ = TSolver(sc).run(torch.as_tensor(d0),
                                     torch.as_tensor(d0), 0.0, 1, sync=sync,
                                     record="traj")
        _close(tt.numpy(), tj, 1e-12, (mode, sync))
