"""Public functions of savtpu that the port gained last, held to savtpu's
on the same inputs on the CPU:

- ``ShardedProblem.globalize`` (dense, banded, the lexicographically
  reordered stencil on box parts, the tube): exactly, and the inverse of
  ``localize`` on the real slots;
- ``native.native_partition`` (k = 2, 4, 7; refinement passes 0 and 8)
  element for element, with savtpu's own balance and cut properties
  (tests/test_native.py), and ``native.native_first_touch`` exactly;
- ``FIntOperator.dense_matrix`` (every mode), ``owner_counts``,
  ``element_mkf``, ``jacobian`` and ``isoparametric_map``: within 1e-12
  of the largest entry in float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from savtpu import native as j_native
from savtpu.config import Config as JConfig
from savtpu.mesh import beam_mesh as j_beam_mesh
from savtpu.mesh import tube_mesh as j_tube
from savtpu.ops import shape as j_shape
from savtpu.ops.assembly import FIntOperator as JFInt
from savtpu.ops.element import element_mkf as j_element_mkf
from savtpu.ops.material import LinearElastic as JLinearElastic
from savtpu.parallel import ShardedProblem as JShardedProblem
from savtpu.parallel import build_partition_maps as j_maps
from savtpu.parallel.partition import dual_graph as j_dual_graph
from savtpu.pipeline.online_predictor import owner_counts as j_owner_counts
from savtpu.solvers import setup_problem as j_setup

from savtpu_torch import native
from savtpu_torch.mesh import beam_mesh, dirichlet_nodes
from savtpu_torch.ops import shape
from savtpu_torch.ops.assembly import FIntOperator
from savtpu_torch.ops.element import element_mkf
from savtpu_torch.ops.material import LinearElastic
from savtpu_torch.parallel import partition_elements
from savtpu_torch.parallel.partition import dual_graph
from savtpu_torch.pipeline.online_predictor import owner_counts

import torch_mesh_cases as cases

torch.set_num_threads(1)

TOL = 1e-12

LAYOUTS = {
    "dense": cases._beam((8, 1, 1), (8.0, 1.0, 1.0), 4, fint_mode="dense"),
    "banded": cases._beam((12, 2, 2), (6.0, 1.0, 1.0), 4,
                          fint_mode="banded"),
    "stencil": cases._beam((8, 4, 4), (8.0, 4.0, 4.0), 8, "box",
                           fint_mode="stencil"),
    "tube": cases._tube((2, 8, 8), 8, fint_mode="stencil"),
}


def _savtpu_sp(spec):
    """savtpu's ShardedProblem of a spec of tests/torch_mesh_cases.py, on
    the port's partition (which gives savtpu's parts)."""
    cfg = JConfig()
    if spec["mesh"][0] == "beam":
        cfg.beam_cells, cfg.beam_extent = spec["mesh"][1:]
        prob = j_setup(cfg, dtype=jnp.float64)
    else:
        n_r, n_theta, n_z = spec["mesh"][1:]
        prob = j_setup(cfg, mesh=j_tube(n_r=n_r, n_theta=n_theta, n_z=n_z),
                       dtype=jnp.float64)
    m = prob.mesh
    ep = partition_elements(m.tetra, m.points, spec["parts"],
                            method=spec["method"])
    dn = dirichlet_nodes(m.triangles, m.points,
                         axis=spec.get("dirichlet_axis", 0))
    return JShardedProblem.build(prob, j_maps(m.tetra, ep, m.num_points, dn),
                                 dtype=jnp.float64, **spec["build"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_globalize_is_savtpus(layout):
    spec = LAYOUTS[layout]
    prob, sp = cases.build_problem(spec)
    sj = _savtpu_sp(spec)
    np.testing.assert_array_equal(sp.local_dofs_global, sj.local_dofs_global)
    rng = np.random.default_rng(0)
    # duplicates disagree here, so the owner rule decides every shared DOF
    x = rng.standard_normal((sp.n_parts, sp.DL))
    for arg in (x, torch.as_tensor(x)):
        g = sp.globalize(arg, prob.ndof)
        assert g.dtype == np.float64 and g.shape == (prob.ndof,)
        np.testing.assert_array_equal(g, sj.globalize(x, prob.ndof))
    g32 = sp.globalize(torch.as_tensor(x, dtype=torch.float32), prob.ndof)
    assert g32.dtype == np.float32
    np.testing.assert_array_equal(
        g32, sj.globalize(x.astype(np.float32), prob.ndof))
    # the inverse of localize wherever a DOF has a slot
    v = rng.standard_normal(prob.ndof)
    seen = np.zeros(prob.ndof, bool)
    dm = sp.dof_mask.numpy()
    for p in range(sp.n_parts):
        seen[sp.local_dofs_global[p, : int(dm[p].sum())]] = True
    back = sp.globalize(sp.localize(v), prob.ndof)
    np.testing.assert_array_equal(back[seen], v[seen])
    assert not back[~seen].any()


def _edgecut(epart, xadj, adjncy):
    src = np.repeat(np.arange(len(epart)), np.diff(xadj))
    return int(np.sum(epart[src] != epart[adjncy]) // 2)


@pytest.fixture(scope="module")
def graph():
    if native.get_lib() is None or j_native.get_lib() is None:
        pytest.skip("native library unavailable (no g++)")
    mesh = beam_mesh(20, 3, 3, extent=(20.0, 1.0, 1.0))
    xadj, adjncy = dual_graph(mesh.tetra)
    xj, aj = j_dual_graph(j_beam_mesh(20, 3, 3, extent=(20.0, 1.0,
                                                        1.0)).tetra)
    np.testing.assert_array_equal(xadj, xj)
    np.testing.assert_array_equal(adjncy, aj)
    return len(mesh.tetra), xadj, adjncy


@pytest.mark.parametrize("passes", [0, 8])
@pytest.mark.parametrize("k", [2, 4, 7])
def test_native_partition_is_savtpus(graph, k, passes):
    n, xadj, adjncy = graph
    ep = native.native_partition(xadj, adjncy, k, refine_passes=passes)
    assert ep.dtype == np.int64 and ep.shape == (n,)
    np.testing.assert_array_equal(
        ep, j_native.native_partition(xadj, adjncy, k,
                                      refine_passes=passes))
    # savtpu's own properties (tests/test_native.py)
    counts = np.bincount(ep, minlength=k)
    assert counts.sum() == n and counts.min() > 0
    assert counts.max() <= n // k + k


def test_native_refinement_does_not_worsen_the_cut(graph):
    _, xadj, adjncy = graph
    raw = native.native_partition(xadj, adjncy, 4, refine_passes=0)
    ref = native.native_partition(xadj, adjncy, 4, refine_passes=8)
    assert _edgecut(ref, xadj, adjncy) <= _edgecut(raw, xadj, adjncy)


def test_native_first_touch_is_savtpus(graph):
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 50, size=500)
    out = native.native_first_touch(flat, 50)
    np.testing.assert_array_equal(out, j_native.native_first_touch(flat, 50))
    order = list(dict.fromkeys(int(v) for v in flat))
    assert out.tolist() == order


def test_native_entry_points_return_none_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    xadj, adjncy = dual_graph(beam_mesh(4, 1, 1).tetra)
    assert native.native_partition(xadj, adjncy, 2) is None
    assert native.native_first_touch(np.arange(4), 4) is None
    assert native.native_refine(xadj, adjncy, np.zeros(len(xadj) - 1), 2) \
        is None


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * np.abs(b).max())


@pytest.mark.parametrize("mode", ["dense", "ebe", "bcoo"])
def test_dense_matrix_is_savtpus(mode):
    spec = LAYOUTS["banded"]
    prob, _ = cases.build_problem(spec)
    cfg = JConfig()
    cfg.beam_cells, cfg.beam_extent = spec["mesh"][1:]
    pj = j_setup(cfg, dtype=jnp.float64)
    op = FIntOperator(prob.Ke, prob.edofs, prob.ndof, mode=mode)
    K = op.dense_matrix
    assert K.dtype == torch.float64 and K.shape == (prob.ndof, prob.ndof)
    _close(K.numpy(), JFInt(pj.Ke, pj.edofs, pj.ndof, mode=mode).dense_matrix)
    # the matrix the operator applies
    d = torch.as_tensor(np.random.default_rng(1).standard_normal(prob.ndof))
    _close(op(d).numpy(), (K @ d).numpy())


def test_owner_counts_are_savtpus():
    _, sp = cases.build_problem(LAYOUTS["stencil"])
    got = owner_counts(sp.sgi, sp.smask, sp.SD)
    np.testing.assert_array_equal(
        got, j_owner_counts(sp.sgi.numpy(), sp.smask.numpy(), sp.SD))
    P, S3 = sp.smask.shape
    assert got.max() > 2
    np.testing.assert_array_equal(
        got, np.maximum((sp.owners.numpy() < P * S3).sum(1), 1))


@pytest.mark.parametrize("deg", [1, 2])
def test_per_element_functions_are_savtpus(deg):
    rng = np.random.default_rng(deg)
    nb = shape.n_basis(deg)
    P = np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    if deg == 2:
        edges = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]
        P = np.vstack([P, [(P[a] + P[b]) / 2 for a, b in edges]])
    P = P + 0.05 * rng.standard_normal((nb, 3))
    kw = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5, ramped=True)
    Pt = torch.as_tensor(P)
    for got, ref in zip(
            element_mkf(deg, 2 * deg, LinearElastic.from_engineering(**kw),
                        0.3, Pt),
            j_element_mkf(deg, 2 * deg, JLinearElastic.from_engineering(**kw),
                          0.3, jnp.asarray(P))):
        _close(got.numpy(), ref)
    xi = torch.as_tensor([0.2, 0.3, 0.1], dtype=torch.float64)
    N = shape.shape_function(deg, xi)
    dN = shape.shape_derivative(deg, xi)
    _close(shape.jacobian(Pt, dN).numpy(),
           j_shape.jacobian(jnp.asarray(P), jnp.asarray(dN.numpy())))
    _close(shape.isoparametric_map(Pt, N).numpy(),
           j_shape.isoparametric_map(jnp.asarray(P), jnp.asarray(N.numpy())))
    # batched: element by element
    Pb = torch.as_tensor(P + 0.01 * rng.standard_normal((3, nb, 3)))
    for e in range(3):
        _close(shape.jacobian(Pb, dN)[e].numpy(),
               shape.jacobian(Pb[e], dN).numpy())
