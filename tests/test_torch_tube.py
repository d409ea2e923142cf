"""The port's periodic tube against savtpu's: ``tube_mesh``, the
curvilinear detection, the box partition (a seam-wrapped part at 4
parts, a full ring at 3) and the per-cell geometry, equal exactly; the
linear and Neo-Hookean stencil forces (per-cell geometry, the full-ring
part's wrapped corner column) within 1e-12 of their max on a
displacement with a strain near 1e-2, against savtpu's and against the
port's dense K d or incident-list force; and 50 exchanged steps with the
grid exchange across the tube's seam (its part ring adds a seam pair)
within 1e-12 of the trajectory's norm, against savtpu's and the port's
psum. float64 throughout; the packages add a node's element
contributions in other orders, and near F = I the Neo-Hookean stress
cancels to O(strain), so parity is float64's eps over the strain."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.mesh import generator as j_generator
from savtpu.ops.material import NeoHookean as JNeoHookean
from savtpu.parallel import ShardedProblem as JShardedProblem
from savtpu.parallel import build_partition_maps as j_maps
from savtpu.parallel import partition as j_partition
from savtpu.parallel import stencil as j_stencil
from savtpu.parallel.sharded import ShardedSolver as JSolver
from savtpu.solvers import setup_problem as j_setup

from savtpu_torch.config import Config as TConfig
from savtpu_torch.mesh import dirichlet_nodes, tube_mesh
from savtpu_torch.ops.material import NeoHookean as TNeoHookean
from savtpu_torch.parallel import ShardedProblem as TShardedProblem
from savtpu_torch.parallel import ShardedSolver as TSolver
from savtpu_torch.parallel import build_partition_maps as t_maps
from savtpu_torch.parallel import partition as t_partition
from savtpu_torch.parallel import stencil as t_stencil
from savtpu_torch.solvers import setup_problem as t_setup

torch.set_num_threads(1)

TOL = 1e-12
MAT = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)
# the tube of savtpu's tests/test_tube_stencil.py: 4 parts split theta
# and z (a seam-wrapped part), 3 parts are z slabs (full rings)
TUBE = (2, 8, 6)
CELL = 0.25      # its radial cell size, the smallest


def _tubes(dims):
    mt, mj = tube_mesh(*dims), j_generator.tube_mesh(*dims)
    np.testing.assert_array_equal(mt.points, mj.points)
    for k in mt.cells:
        np.testing.assert_array_equal(mt.cells[k], mj.cells[k])
    return mt, mj


def _setup(dims, n_parts):
    mt, mj = _tubes(dims)
    ep = t_partition.partition_elements(mt.tetra, mt.points, n_parts, "box")
    np.testing.assert_array_equal(
        ep, j_partition.partition_elements(mj.tetra, mj.points, n_parts,
                                           "box"))
    dn = dirichlet_nodes(mt.triangles, mt.points, axis=2)
    probs = []
    for C, setup, mesh in ((JConfig, j_setup, mj), (TConfig, t_setup, mt)):
        cfg = C()
        cfg.partition.dirichlet_axis = 2
        probs.append(setup(cfg, mesh=mesh))
    return (probs[0], probs[1], j_maps(mj.tetra, ep, mj.num_points, dn),
            t_maps(mt.tetra, ep, mt.num_points, dn))


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


def _max_rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _by_global(sp, F, ndof):
    F = np.asarray(F)
    out = np.zeros((sp.n_parts, ndof))
    dm = np.asarray(sp.dof_mask)
    for p in range(sp.n_parts):
        n = int(dm[p].sum())
        out[p, np.asarray(sp.local_dofs_global)[p, :n]] = F[p, :n]
    return out


@pytest.mark.parametrize("dims", [(1, 8, 3), (2, 24, 8), TUBE])
def test_tube_mesh_equals_savtpu(dims):
    mt, mj = _tubes(dims)
    assert t_stencil.detect_curvilinear(mt) == j_stencil.detect_curvilinear(
        mj) == (dims[0], dims[1], dims[2])
    assert t_stencil.detect_structured(mt) is None


@pytest.mark.parametrize("n_parts", [4, 3])
def test_box_partition_and_cell_geometry_equal_savtpu(n_parts):
    pj, pt, mj, mt = _setup(TUBE, n_parts)
    bj = j_stencil.detect_box_partition(pj.mesh, mj)
    bt = t_stencil.detect_box_partition(pt.mesh, mt)
    assert dataclasses.asdict(bt) == dataclasses.asdict(bj)
    assert bt.wrap_y and bt.spacing is None
    assert bt.full_ring == (n_parts == 3)
    for a, b in zip(t_stencil.cell_type_geometry(pt.mesh, bt),
                    j_stencil.cell_type_geometry(pj.mesh, bj)):
        np.testing.assert_array_equal(a, b)
    lt = t_stencil.lex_reorder_maps(mt, bt)
    lj = j_stencil.lex_reorder_maps(mj, bj)
    for a, b in zip(lt.local_nodes, lj.local_nodes):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(lt.local_dirichlet, lj.local_dirichlet):
        np.testing.assert_array_equal(a, b)


def _pair(dims, n_parts, material, **kw):
    pj, pt, mj, mt = _setup(dims, n_parts)
    if material == "nh":
        sj = JShardedProblem.build(
            pj, mj, material=JNeoHookean.from_engineering(**MAT), **kw)
        st = TShardedProblem.build(
            pt, mt, material=TNeoHookean.from_engineering(**MAT), **kw,
            device="cpu")
    else:
        sj = JShardedProblem.build(pj, mj, fint_mode="stencil", **kw)
        st = TShardedProblem.build(pt, mt, fint_mode="stencil",
                                   device="cpu", **kw)
    assert st.nhs_dims == sj.nhs_dims and st.nhs_wrap == sj.nhs_wrap
    np.testing.assert_array_equal(st.nhs_Gc.numpy(), np.asarray(sj.nhs_Gc))
    np.testing.assert_array_equal(st.nhs_dJwc.numpy(),
                                  np.asarray(sj.nhs_dJwc))
    np.testing.assert_array_equal(st.local_dofs_global, sj.local_dofs_global)
    return pt, mt, sj, st


@pytest.mark.parametrize("material", ["linear", "nh"])
@pytest.mark.parametrize("n_parts", [4, 3])
def test_stencil_force_equals_savtpu_and_gather_paths(n_parts, material):
    pt, mt, sj, st = _pair(TUBE, n_parts, material)
    assert st.nhs_wrap == (n_parts == 3)
    dg = 1e-2 * CELL * np.random.default_rng(0).standard_normal(pt.ndof)
    d = st.localize(dg)
    got = st._fint_stacked(d).numpy()
    want = np.asarray(sj._fint_stacked(jnp.asarray(d.numpy())))
    assert _max_rel(got, want) < TOL
    # the port's own gather path on its own local order
    if material == "nh":
        ref = TShardedProblem.build(
            pt, mt, material=TNeoHookean.from_engineering(**MAT),
            nh_stencil="off", nh_gather="incident", device="cpu")
    else:
        ref = TShardedProblem.build(pt, mt, fint_mode="dense", device="cpu")
    fr = ref._fint_stacked(ref.localize(dg)).numpy()
    assert _max_rel(_by_global(st, got, pt.ndof),
                    _by_global(ref, fr, pt.ndof)) < TOL


@pytest.mark.parametrize("material", ["linear", "nh"])
def test_seam_grid_trajectory_equals_savtpu_and_psum(material):
    """tube 2x8x4 in 8 box parts: theta is split, so the part ring has a
    seam pair; 50 exchanged steps from a strained state."""
    dims, n_parts, steps = (2, 8, 4), 8, 50
    pt, mt, sj, st = _pair(dims, n_parts, material, exchange_mode="grid")
    assert st.grid_wrap and sj.grid_wrap and st.grid_pdims == sj.grid_pdims
    dg = 1e-2 * CELL * np.random.default_rng(1).standard_normal(pt.ndof)
    d0 = st.localize(dg)
    kw = dict(sync=True, record="all", save_every=5)
    (tt, sht), ct = TSolver(st).run(d0, d0, 0.0, steps, **kw)
    d0j = jnp.asarray(d0.numpy())
    (tj, shj), cj = JSolver(sj).run(d0j, d0j, 0.0, steps, **kw)
    _close(tt.numpy(), tj, TOL, "traj")
    _close(sht.numpy(), shj, TOL, "shared")
    _close(ct[0].numpy(), cj[0], TOL, "d")
    ps = dataclasses.replace(st, exchange_mode="psum")
    (tp, _), _ = TSolver(ps).run(d0, d0, 0.0, steps, **kw)
    _close(tt.numpy(), tp.numpy(), TOL, "grid vs psum")
    # the seam pair carries the exchange: without it the run departs
    nw = dataclasses.replace(st, grid_wrap=False)
    (tn, _), _ = TSolver(nw).run(d0, d0, 0.0, steps, **kw)
    assert np.linalg.norm(tn.numpy() - tp.numpy()) > 1e-6 * np.linalg.norm(
        tp.numpy())
