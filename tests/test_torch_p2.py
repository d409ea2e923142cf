"""The port's steady-only P2 path against savtpu's, on the CPU in
float64: ``mesh.to_p2``, the P2 basis, P2 element stiffness, stage 1 at
``solver.deg = 2`` and the dynamic layers' refusals.

- ``to_p2``: points, tetra10 and the corner triangles exactly equal;
- the P2 basis and its derivatives at the quadrature points: savtpu's at
  1e-15 (a partition of unity, derivatives summing to 0);
- P2 K_e (30x30): savtpu's at 1e-12 of the max, symmetric, the six
  rigid-body modes in its null space (1e-10 of ||K_e||);
- stage 1 at ``deg = 2``: the steady VTK's displacement equal to
  savtpu's at 1e-10 of the max, the tip deflection within 30% of
  Euler-Bernoulli (as savtpu's tests/test_pipeline.py checks), and
  ``Simulation.steady()`` equal to it;
- ``build_context`` and ``ShardedProblem.build`` refuse ``deg = 2`` with
  savtpu's messages (the package name swapped).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _cfg(C, root, nx=5):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (nx, 1, 1)
    cfg.beam_extent = (float(nx), 1.0, 1.0)
    cfg.solver.deg = 2
    return cfg


@pytest.mark.parametrize("which", ["beam_5x1x1", "beam_4x2x3",
                                   "irregular_4x2x2", "tube_1x8x3"])
def test_to_p2_equals_savtpu(which):
    from savtpu.mesh import generator as jg

    from savtpu_torch.mesh import generator as tg

    kind, dims = which.split("_")
    dims = tuple(int(v) for v in dims.split("x"))
    if kind == "beam":
        mt, mj = tg.beam_mesh(*dims), jg.beam_mesh(*dims)
    elif kind == "irregular":
        mt, mj = tg.irregular_beam_mesh(*dims), jg.irregular_beam_mesh(*dims)
    else:
        mt, mj = tg.tube_mesh(*dims), jg.tube_mesh(*dims)
    a, b = tg.to_p2(mt), jg.to_p2(mj)
    np.testing.assert_array_equal(a.points, b.points)
    assert set(a.cells) == set(b.cells)
    for k in a.cells:
        assert a.cells[k].dtype == b.cells[k].dtype
        np.testing.assert_array_equal(a.cells[k], b.cells[k])


def test_p2_basis_matches_savtpu():
    import jax.numpy as jnp
    from savtpu.ops import shape as js
    from savtpu.ops.quadrature import tet_quadrature

    from savtpu_torch.ops import shape as ts

    for n in (2, 3, 4):
        nodes, _ = tet_quadrature(n)
        for xi in nodes:
            N = ts.shape_function(2, torch.as_tensor(xi)).numpy()
            dN = ts.shape_derivative(2, torch.as_tensor(xi)).numpy()
            np.testing.assert_allclose(
                N, np.asarray(js.shape_function(2, jnp.asarray(xi))),
                rtol=0, atol=1e-15)
            np.testing.assert_allclose(
                dN, np.asarray(js.shape_derivative(2, jnp.asarray(xi))),
                rtol=0, atol=1e-15)
            assert N.shape == (10,) and dN.shape == (10, 3)
            assert abs(N.sum() - 1.0) <= 1e-15
            assert np.abs(dN.sum(axis=0)).max() <= 1e-14
    with pytest.raises(ValueError, match="degree 3"):
        ts.shape_function(3, torch.zeros(3, dtype=torch.float64))


def _p2_coords():
    from savtpu_torch.mesh import beam_mesh, to_p2

    m = to_p2(beam_mesh(2, 1, 1, extent=(2.0, 1.0, 1.0)))
    return m.points[m.cells["tetra10"]]  # (E, 10, 3)


def test_p2_element_stiffness_matches_savtpu():
    import jax.numpy as jnp
    from savtpu.ops.element import batch_element_k as j_k
    from savtpu.ops.element import batch_element_mkf as j_mkf
    from savtpu.ops.material import LinearElastic as JLE

    from savtpu_torch.ops.element import (
        batch_element_k,
        batch_element_mkf,
        element_k,
    )
    from savtpu_torch.ops.material import LinearElastic

    coords = _p2_coords()
    kw = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)
    jm, tm = JLE.from_engineering(**kw), LinearElastic.from_engineering(**kw)
    ct = torch.as_tensor(coords)
    for n_quad in (2, 3):
        Kj = np.asarray(j_k(2, n_quad, jm, jnp.asarray(coords)))
        Kt = batch_element_k(2, n_quad, tm, ct).numpy()
        assert Kt.shape == (len(coords), 30, 30)
        assert np.abs(Kt - Kj).max() <= 1e-12 * np.abs(Kj).max()
        Mj, Kj2, Fj = (np.asarray(a) for a in
                       j_mkf(2, n_quad, jm, 0.0, jnp.asarray(coords)))
        Mt, Kt2, Ft = (a.numpy() for a in
                       batch_element_mkf(2, n_quad, tm, 0.0, ct))
        for a, b in ((Mt, Mj), (Kt2, Kj2), (Ft, Fj)):
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
        Ke0 = element_k(2, n_quad, tm, ct[0]).numpy()
        np.testing.assert_array_equal(Ke0, Kt[0])


def test_p2_rigid_body_null_space():
    from savtpu_torch.ops.element import batch_element_k
    from savtpu_torch.ops.material import LinearElastic

    coords = _p2_coords()
    K = batch_element_k(2, 2, LinearElastic.from_engineering(
        E=1e6, nu=0.3, rho=1.0, fz=0.5), torch.as_tensor(coords)).numpy()
    for e in range(len(coords)):
        x = coords[e]
        modes = []
        for c in range(3):
            t = np.zeros((10, 3))
            t[:, c] = 1.0
            modes.append(t.reshape(-1))
        for axis in np.eye(3):
            modes.append(np.cross(axis, x).reshape(-1))
        R = np.stack(modes, axis=1)  # (30, 6)
        assert np.abs(K[e] @ R).max() <= 1e-10 * np.abs(K[e]).max()
        assert np.abs(K[e] - K[e].T).max() <= 1e-12 * np.abs(K[e]).max()
        # and nothing else: 24 positive eigenvalues
        lam = np.linalg.eigvalsh(K[e])
        assert (lam[6:] > 1e-8 * lam[-1]).all()


def _vtk_displacement(path):
    lines = path.read_text().splitlines()
    out = {}
    for i, ln in enumerate(lines):
        if ln.startswith("SCALARS displacement-"):
            c = ln.split()[1][-1]
            n = int(next(l for l in lines if l.startswith("POINT_DATA"))
                    .split()[1])
            out[c] = np.array(lines[i + 2 : i + 2 + n], dtype=np.float64)
    return np.stack([out["x"], out["y"], out["z"]], axis=1).reshape(-1)


def test_stage1_p2_matches_savtpu(tmp_path):
    from savtpu.config import Config as JConfig
    from savtpu.pipeline import data_prepare as j_dp

    from savtpu_torch.api import Simulation
    from savtpu_torch.config import Config
    from savtpu_torch.mesh import read_vtk
    from savtpu_torch.pipeline import data_prepare

    cj, ct = _cfg(JConfig, tmp_path / "savtpu"), _cfg(Config, tmp_path / "port")
    pj = j_dp.run(cj, verbose=False)
    pt = data_prepare.run(ct, verbose=False, device="cpu")
    assert pt.deg == 2 and pt.edofs.shape[1] == 30 and pt.ndof == pj.ndof
    assert pt.dt == pj.dt
    np.testing.assert_array_equal(pt.dirichlet_dofs, pj.dirichlet_dofs)
    vt = tmp_path / "port" / "Results" / "Static" / "steady_distributed.vtk"
    vj = tmp_path / "savtpu" / "Results" / "Static" / "steady_distributed.vtk"
    mesh = read_vtk(vt)
    assert mesh.num_points == pt.mesh.num_points
    assert mesh.cells["tetra10"].shape == (len(pt.edofs), 10)
    got, want = _vtk_displacement(vt), _vtk_displacement(vj)
    assert np.abs(want).max() > 0.0
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    dy = Simulation(ct, device="cpu", verbose=False).steady()
    np.testing.assert_allclose(dy, got, rtol=0, atol=1e-15 * np.abs(got).max())
    tip = int(np.argmax(pt.mesh.points[:, 0]))
    eb = 0.5 * 5.0**4 / (8 * 1e6 / 12.0)
    assert abs(dy[3 * tip + 1] + eb) / eb < 0.3


def test_dynamic_layers_refuse_p2_with_savtpus_message(tmp_path):
    from savtpu.config import Config as JConfig
    from savtpu.pipeline.common import build_context as j_build

    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu_torch.pipeline.common import build_context
    from savtpu_torch.solvers import setup_problem

    with pytest.raises(NotImplementedError) as ej:
        j_build(_cfg(JConfig, tmp_path / "savtpu"))
    with pytest.raises(NotImplementedError) as et:
        build_context(_cfg(Config, tmp_path / "port"), device="cpu")
    assert str(et.value) == str(ej.value).replace(
        "savtpu.pipeline", "savtpu_torch.pipeline")
    assert "A12c" not in str(et.value)
    cfg = _cfg(Config, tmp_path / "port")
    prob = setup_problem(cfg)
    m = prob.mesh
    tets = m.cells["tetra10"][:, :4]
    ep = partition_elements(tets, m.points, 2, "rcb")
    maps = build_partition_maps(tets, ep, m.num_points,
                                dirichlet_nodes(m.triangles, m.points))
    with pytest.raises(NotImplementedError,
                       match="distributed dynamic path is P1-only; deg=2 is "
                             "steady-only, like the reference"):
        ShardedProblem.build(prob, maps, device="cpu")
