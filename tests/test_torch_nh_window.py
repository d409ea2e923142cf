"""The port's windowed Neo-Hookean layout (``nh_gather`` 'auto' or
'window' off a box partition: RCM-ordered local nodes, elements in
chunks of up to 256 sorted by their least node, each chunk reading one
W-node window) against savtpu's, on an irregular Delaunay beam (12x3x3)
in 4 graph parts and on a structured beam (7x2x2) in 3 RCB parts that
cut cells (so no box stencil applies).

- The local order (and so the shared order of the artifacts) and the
  window metadata (w0, relative indices, W, per-chunk G and detJ w)
  equal savtpu's exactly; the port's element slots (the incident-list
  force's edofs, G and detJ w) come in savtpu's chunk order.
- The forces within 1e-12 of their max against savtpu's window force
  and the port's incident-list force (by global DOF), float64, on a
  smooth displacement with a strain near 1e-2 (an irregular mesh's
  slivers turn a random field of that size into inverted elements).
- 50 exchanged steps and 50 comm-free steps with predictions, plain and
  compensated, within 1e-12 of each output's norm against savtpu's.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.ops.material import NeoHookean as JNeoHookean
from savtpu.parallel import ShardedProblem as JShardedProblem
from savtpu.parallel import build_partition_maps as j_maps
from savtpu.parallel.sharded import ShardedSolver as JSolver
from savtpu.solvers import setup_problem as j_setup

from savtpu_torch.config import Config as TConfig
from savtpu_torch.mesh import beam_mesh, dirichlet_nodes, irregular_beam_mesh
from savtpu_torch.ops.material import NeoHookean as TNeoHookean
from savtpu_torch.parallel import ShardedProblem as TShardedProblem
from savtpu_torch.parallel import ShardedSolver as TSolver
from savtpu_torch.parallel import build_partition_maps as t_maps
from savtpu_torch.parallel import partition_elements

torch.set_num_threads(1)

TOL = 1e-12
MAT = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)
CASES = {"irregular_graph": ("graph", 4), "beam_rcb": ("rcb", 3)}


def _mesh(case):
    if case == "irregular_graph":
        return irregular_beam_mesh(12, 3, 3, extent=(12.0, 1.0, 1.0))
    return beam_mesh(7, 2, 2, extent=(7.0, 2.0, 2.0))


def _pair(case, **kw):
    m = _mesh(case)
    probs = [setup(C(), mesh=m) for C, setup in ((JConfig, j_setup),
                                                 (TConfig, t_setup))]
    method, n_parts = CASES[case]
    ep = partition_elements(m.tetra, m.points, n_parts, method)
    dn = dirichlet_nodes(m.triangles, m.points)
    sj = JShardedProblem.build(
        probs[0], j_maps(m.tetra, ep, m.num_points, dn),
        material=JNeoHookean.from_engineering(**MAT), **kw)
    st = TShardedProblem.build(
        probs[1], t_maps(m.tetra, ep, m.num_points, dn),
        material=TNeoHookean.from_engineering(**MAT), **kw, device="cpu")
    assert sj.nhw_W is not None and st.nhw_W == sj.nhw_W
    return probs[1], sj, st


def window_records(st, sj):
    """The port's window records and chunk-ordered element geometry,
    each beside savtpu's window array of the same name."""
    G, dJw = np.asarray(sj.nhw_G), np.asarray(sj.nhw_dJw)
    return {"nhw_w0": (st.nhw_w0, sj.nhw_w0),
            "nhw_idx": (st.nhw_idx, sj.nhw_idx),
            "nhw_G": (st.nh_G.numpy().reshape(G.shape), G),
            "nhw_dJw": (st.nh_detJw.numpy().reshape(dJw.shape), dJw)}


def window_edofs_hold(st):
    """The port's edofs are the windows' nodes (w0 + relative index) in
    chunk order; padded chunk slots (relative index 0) read DL - 1."""
    P = st.n_parts
    e = st.edofs.numpy().reshape(P, -1, 12)
    nodes = st.nhw_w0[:, :, None, None] + st.nhw_idx
    want = (3 * nodes[..., None] + np.arange(3)).reshape(P, -1, 12)
    real = (e != st.DL - 1).all(-1)
    assert ((e == st.DL - 1).all(-1) | real).all()
    np.testing.assert_array_equal(e[real], want[real])
    assert (st.nhw_idx.reshape(P, -1, 4)[~real] == 0).all()


def shift_windows(st):
    """Every chunk's window start moved by one node (on the last node it
    wraps to node 0): the control that the force checks must reject."""
    e = st.edofs
    last = st.DL - 1
    return dataclasses.replace(
        st, edofs=torch.where(e < last, (e + 3) % last, e))


def t_setup(cfg, mesh):
    from savtpu_torch.solvers import setup_problem

    return setup_problem(cfg, mesh=mesh)


def _smooth(pt, seed=0):
    """A smooth global displacement with a strain near 1e-2: an affine
    field plus a long sine."""
    rng = np.random.default_rng(seed)
    x = pt.mesh.points
    L = x.max(0) - x.min(0)
    u = 1e-2 * x @ rng.standard_normal((3, 3)).T
    u += 1e-2 * L.min() * np.sin(2 * np.pi * x[:, :1] / L[0]
                                 + rng.uniform(0, 6, 3))
    return u.reshape(-1)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


@pytest.mark.parametrize("gather", ["auto", "window"])
@pytest.mark.parametrize("case", list(CASES))
def test_window_metadata_equals_savtpu(case, gather):
    pt, sj, st = _pair(case, nh_gather=gather)
    for a, b in zip(st.maps.local_nodes, sj.maps.local_nodes):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(st.maps.shared_nodes, sj.maps.shared_nodes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st.sld.numpy(), np.asarray(sj.sld))
    for name, (a, b) in window_records(st, sj).items():
        np.testing.assert_array_equal(a, np.asarray(b), name)
    assert st.nhw_W % 8 == 0
    window_edofs_hold(st)
    L = (st.DL - 1) // 3
    w0 = st.nhw_w0
    assert (w0 >= 0).all() and (w0 <= L).all()


@pytest.mark.parametrize("case", list(CASES))
def test_window_force_equals_savtpu_and_incident(case):
    pt, sj, st = _pair(case)
    dg = _smooth(pt)
    d = st.localize(dg)
    got = st._fint_stacked(d).numpy()
    want = np.asarray(sj._fint_stacked(jnp.asarray(d.numpy())))
    assert np.abs(got - want).max() / np.abs(want).max() < TOL
    inc = TShardedProblem.build(
        pt, t_maps(pt.mesh.tetra, st.maps.epart, pt.mesh.num_points,
                   dirichlet_nodes(pt.mesh.triangles, pt.mesh.points)),
        material=TNeoHookean.from_engineering(**MAT), nh_gather="incident",
        device="cpu")
    fi = inc._fint_stacked(inc.localize(dg)).numpy()
    gw, gi = np.zeros(pt.ndof), np.zeros(pt.ndof)
    for sp, F, acc in ((st, got, gw), (inc, fi, gi)):
        for p in range(sp.n_parts):
            n = int(sp.dof_mask[p].sum())
            acc[sp.local_dofs_global[p, :n]] += F[p, :n]
    assert np.abs(gw - gi).max() / np.abs(gi).max() < TOL
    # a window start off by one node is caught
    bad = shift_windows(st)
    assert np.abs(bad._fint_stacked(d).numpy() - want).max() > 1e-3 * (
        np.abs(want).max())


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_window_trajectory_equals_savtpu(case, compensated, sync):
    pt, sj, st = _pair(case, compensated=compensated)
    steps = 50
    d0 = st.localize(_smooth(pt)).numpy()
    rng = np.random.default_rng(2)
    P, S3 = st.sld.shape
    t = np.arange(steps)[None, :, None]
    preds = (1e-3 * rng.uniform(1, 5, (P, 1, S3))
             * np.sin(rng.uniform(0.01, 0.1, (P, 1, S3)) * t)
             * st.smask.numpy()[:, None, :])
    kw = dict(sync=sync, record="all", save_every=5)
    (tj, shj), cj = JSolver(sj).run(
        jnp.asarray(d0), jnp.asarray(d0), 0.0, steps,
        preds=None if sync else jnp.asarray(preds), **kw)
    (tt, sht), ct = TSolver(st).run(
        torch.as_tensor(d0), torch.as_tensor(d0), 0.0, steps,
        preds=None if sync else torch.as_tensor(preds), **kw)
    _close(tt.numpy(), tj, TOL, "traj")
    _close(sht.numpy(), shj, TOL, "shared")
    for a, b, name in zip(ct[:2], cj[:2], ("d", "d_prev")):
        _close(a.numpy(), b, TOL, name)
