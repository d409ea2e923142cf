"""The port's structured-box layer against savtpu's: box detection, the
lex reorder, the per-type geometry and the box partitioner (equal
exactly), the grid halo exchange, and the linear stencil force with the
grid exchange through whole trajectories.

Tolerances, float64: the grid exchange 1e-12 of its scale (the packages
and the psum exchange add a corner node's 4-8 contributions in other
orders); trajectories 1e-12 of each output's norm, the limit of
tests/test_torch_sharded.py. savtpu runs stencil mode with save_every > 1
through its face-plane access to shared DOFs; the port keeps its generic
gather and scatter, which must give the same trajectories and traces.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.mesh.generator import tube_mesh
from savtpu.parallel import ShardedProblem as JShardedProblem
from savtpu.parallel import build_partition_maps as j_maps
from savtpu.parallel import partition as j_partition
from savtpu.parallel import stencil as j_stencil
from savtpu.solvers import setup_problem as j_setup

from savtpu_torch.config import Config as TConfig
from savtpu_torch.mesh import beam_mesh, dirichlet_nodes
from savtpu_torch.parallel import ShardedProblem as TShardedProblem
from savtpu_torch.parallel import ShardedSolver as TSolver
from savtpu_torch.parallel import build_partition_maps as t_maps
from savtpu_torch.parallel import partition as t_partition
from savtpu_torch.parallel import stencil as t_stencil
from savtpu_torch.solvers import setup_problem as t_setup

torch.set_num_threads(1)

TOL = 1e-12
# (cells, parts, partition method): a slab, and box grids over two and
# three axes
LAYOUTS = {
    "8x2x2_slab4": ((8, 2, 2), 4, "slab"),
    "12x4x2_box8": ((12, 4, 2), 8, "box"),
    "8x4x4_box16": ((8, 4, 4), 16, "box"),
}


def _mesh_maps(cells, n_parts, method):
    mesh = beam_mesh(*cells, extent=tuple(float(c) for c in cells))
    ep = t_partition.partition_elements(mesh.tetra, mesh.points, n_parts,
                                        method)
    dn = dirichlet_nodes(mesh.triangles, mesh.points)
    return (mesh, ep, j_maps(mesh.tetra, ep, mesh.num_points, dn),
            t_maps(mesh.tetra, ep, mesh.num_points, dn))


def _pair(cells, n_parts, method="box", **kw):
    """savtpu's and the port's problems on the same mesh and partition,
    float64."""
    cfgs = []
    for C in (JConfig, TConfig):
        cfg = C()
        cfg.beam_cells = cells
        cfg.beam_extent = tuple(float(c) for c in cells)
        cfgs.append(cfg)
    pj, pt = j_setup(cfgs[0]), t_setup(cfgs[1])
    m = pt.mesh
    ep = t_partition.partition_elements(m.tetra, m.points, n_parts, method)
    dn = dirichlet_nodes(m.triangles, m.points)
    sj = JShardedProblem.build(pj, j_maps(m.tetra, ep, m.num_points, dn),
                               **kw)
    st = TShardedProblem.build(pt, t_maps(m.tetra, ep, m.num_points, dn),
                               device="cpu", **kw)
    return pt, sj, st


def _close(a, b, tol, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_detection_reorder_and_geometry_equal_savtpus(layout):
    cells, n_parts, method = LAYOUTS[layout]
    mesh, ep, mj, mt = _mesh_maps(cells, n_parts, method)
    np.testing.assert_array_equal(
        ep, j_partition.partition_elements(mesh.tetra, mesh.points,
                                           n_parts, method))
    assert t_stencil.detect_structured(mesh) == j_stencil.detect_structured(
        mesh)
    bt = t_stencil.detect_box_partition(mesh, mt)
    bj = j_stencil.detect_box_partition(mesh, mj)
    assert bt is not None and dataclasses.asdict(bt) == dataclasses.asdict(
        bj)
    rt, rj = t_stencil.lex_reorder_maps(mt), j_stencil.lex_reorder_maps(
        mj, bj)
    for f in ("local_nodes", "shared_nodes", "local_dirichlet"):
        for a, b in zip(getattr(rt, f), getattr(rj, f)):
            np.testing.assert_array_equal(a, b, f)
    for a, b in zip(t_stencil.type_geometry(bt.spacing),
                    j_stencil.type_geometry(bj.spacing)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cells,n_parts", [
    ((12, 4, 2), 8), ((8, 4, 4), 16), ((96, 8, 8), 16), ((7, 3, 2), 4)])
def test_partition_box_equals_savtpus(cells, n_parts):
    """The box factorization, and RCB where no factorization divides the
    grid (7x3x2 over 4 parts); 96x8x8/16 is the nh_box_96 plant
    ((16, 1, 1) boxes of 6x8x8 cells)."""
    mesh = beam_mesh(*cells, extent=tuple(float(c) for c in cells))
    bt = t_partition._partition_box(mesh.tetra, mesh.points, n_parts)
    bj = j_partition._partition_box(mesh.tetra, mesh.points, n_parts)
    assert (bt is None) == (bj is None) == (cells == (7, 3, 2))
    if bt is not None:
        np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(
        t_partition.partition_elements(mesh.tetra, mesh.points, n_parts,
                                       "box"),
        j_partition.partition_elements(mesh.tetra, mesh.points, n_parts,
                                       "box"))


def test_plant_box_dims():
    """96x8x8/16 box parts: 6x8x8 cells, a 7x9x9 node box, DL 1,702."""
    mesh, _, _, mt = _mesh_maps((96, 8, 8), 16, "box")
    box = t_stencil.detect_box_partition(mesh, mt)
    assert box.box_cells == (6, 8, 8) and box.node_dims == (7, 9, 9)
    assert 3 * mt.max_local_nodes + 1 == 1702


def test_tube_box_partition_equals_savtpu():
    """Where savtpu's detection returns a curvilinear (tube) box, the
    port returns the same box (seam-wrapped here: two parts around the
    ring, two along it), and the wrapped lex reorder gives savtpu's local
    order."""
    mesh = tube_mesh(n_r=2, n_theta=8, n_z=6)
    ep = t_partition.partition_elements(mesh.tetra, mesh.points, 4, "box")
    np.testing.assert_array_equal(
        ep, j_partition.partition_elements(mesh.tetra, mesh.points, 4,
                                           "box"))
    dn = dirichlet_nodes(mesh.triangles, mesh.points, axis=2)
    mj = j_maps(mesh.tetra, ep, mesh.num_points, dn)
    mt = t_maps(mesh.tetra, ep, mesh.num_points, dn)
    bj = j_stencil.detect_box_partition(mesh, mj)
    bt = t_stencil.detect_box_partition(mesh, mt)
    assert t_stencil.detect_curvilinear(mesh) == j_stencil.detect_curvilinear(
        mesh)
    assert bj.wrap_y and not bj.full_ring
    assert dataclasses.asdict(bt) == dataclasses.asdict(bj)
    lj = j_stencil.lex_reorder_maps(mj, bj)
    lt = t_stencil.lex_reorder_maps(mt, bt)
    for a, b in zip(lt.local_nodes, lj.local_nodes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cells,n_parts", [((8, 4, 2), 8), ((8, 4, 4), 16)])
def test_grid_exchange_equals_savtpu_and_psum(cells, n_parts):
    """One exchange of seeded per-part forces: the port's grid exchange
    against savtpu's, and against the port's psum on the real slots."""
    _, sj, st = _pair(cells, n_parts, exchange_mode="grid")
    assert st.grid_pdims == sj.grid_pdims and st.grid_ndims == sj.grid_ndims
    rng = np.random.default_rng(0)
    F = rng.standard_normal((st.n_parts, st.DL)) * st.dof_mask.numpy()
    gt = st._exchange_grid(torch.as_tensor(F)).numpy()
    gj = np.asarray(sj._exchange_grid(jnp.asarray(F)))
    pt = st._exchange(torch.as_tensor(F)).numpy()
    n = st.DL - 1  # the dummy slot is no DOF
    scale = np.abs(gj).max()
    assert np.abs(gt - gj).max() <= TOL * scale
    assert np.abs(gt[:, :n] - pt[:, :n]).max() <= TOL * scale


def test_non_box_partition_is_rejected_as_savtpu_rejects_it():
    """RCB over 7x2x2 cells into 3 parts cuts cells: no box. Both
    packages detect none and refuse the grid exchange and the stencil;
    the Neo-Hookean path keeps the incident-list gather."""
    cells = (7, 2, 2)
    mesh = beam_mesh(*cells, extent=tuple(float(c) for c in cells))
    ep = t_partition.partition_elements(mesh.tetra, mesh.points, 3, "rcb")
    dn = dirichlet_nodes(mesh.triangles, mesh.points)
    mj = j_maps(mesh.tetra, ep, mesh.num_points, dn)
    mt = t_maps(mesh.tetra, ep, mesh.num_points, dn)
    assert j_stencil.detect_box_partition(mesh, mj) is None
    assert t_stencil.detect_box_partition(mesh, mt) is None
    cfg = TConfig()
    cfg.beam_cells = cells
    cfg.beam_extent = tuple(float(c) for c in cells)
    jc = JConfig()
    jc.beam_cells, jc.beam_extent = cfg.beam_cells, cfg.beam_extent
    pj, pt = j_setup(jc), t_setup(cfg)
    for kw, match in ((dict(exchange_mode="grid"), "grid"),
                      (dict(fint_mode="stencil"), "stencil")):
        with pytest.raises(ValueError, match=match):
            JShardedProblem.build(pj, mj, **kw)
        with pytest.raises(ValueError, match=match):
            TShardedProblem.build(pt, mt, device="cpu", **kw)


def test_unknown_modes_raise_value_error():
    pt, _, st = _pair((8, 2, 2), 2)
    maps = _mesh_maps((8, 2, 2), 2, "rcb")[3]
    with pytest.raises(ValueError, match="unknown fint_mode"):
        TShardedProblem.build(pt, maps, fint_mode="stencl", device="cpu")
    with pytest.raises(ValueError, match="unknown exchange_mode"):
        TShardedProblem.build(pt, maps, exchange_mode="gird", device="cpu")
    assert TShardedProblem.build(pt, maps, exchange_mode="permute",
                                 device="cpu").nx_pack is not None
    # a mode the step does not know is refused there too, not taken for
    # another one
    bad = dataclasses.replace(st, fint_mode="elll")
    d = torch.zeros((st.n_parts, st.DL), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown fint_mode"):
        bad._fint_stacked(d)


def _inputs(st, steps, seed=0):
    """A seeded initial displacement and smooth sinusoidal shared-DOF
    predictions, as numpy."""
    rng = np.random.default_rng(seed)
    d0 = 1e-4 * rng.standard_normal((st.n_parts, st.DL)) * st.dof_mask.numpy()
    P, S3 = st.sld.shape
    t = np.arange(steps)[None, :, None]
    amp = rng.uniform(1e-5, 5e-5, (P, 1, S3))
    w = rng.uniform(0.01, 0.1, (P, 1, S3))
    return d0, amp * np.sin(w * t) * st.smask.numpy()[:, None, :]


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("fint_mode,exchange_mode,compensated", [
    ("stencil", "psum", False),
    ("stencil", "grid", False),
    ("stencil", "grid", True),
    ("dense", "grid", False),
])
def test_trajectories_equal_savtpus(fint_mode, exchange_mode, compensated,
                                    sync):
    """60 steps at 8x4x2/8 (box parts over two axes), save_every 5:
    exchanged, and comm-free with predictions (savtpu's stencil mode on
    its face planes there)."""
    _, sj, st = _pair((8, 4, 2), 8, fint_mode=fint_mode,
                      exchange_mode=exchange_mode, compensated=compensated)
    assert st.fint_mode == sj.fint_mode == fint_mode
    for k in ("DL", "SD"):
        assert getattr(st, k) == getattr(sj, k)
    np.testing.assert_array_equal(st.sld.numpy(), np.asarray(sj.sld))
    steps = 60
    d0, preds = _inputs(st, steps)
    kw = dict(sync=sync, record="all", save_every=5)
    (tj, shj), cj = sj.stacked_run(
        jnp.asarray(d0), jnp.asarray(d0), 0.0, steps,
        preds=None if sync else jnp.asarray(preds), **kw)
    (tt, sht), ct = TSolver(st).run(
        torch.as_tensor(d0), torch.as_tensor(d0), 0.0, steps,
        preds=None if sync else torch.as_tensor(preds), **kw)
    _close(tt.numpy(), tj, TOL, "traj")
    _close(sht.numpy(), shj, TOL, "shared")
    for a, b, name in zip(ct[:2], cj[:2], ("d", "d_prev")):
        _close(a.numpy(), b, TOL, name)
