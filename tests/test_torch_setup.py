"""savtpu_torch setup against savtpu: mesh, partition maps (RCB and the
RCM reorder), the banded build arrays, the element integrals and the
assembled vectors, from the same inputs.

The host-side pieces are NumPy copies and must give identical arrays;
the element core is ported to PyTorch and must agree to 1e-12 in float64
(only the sum order of small matrix products differs)."""

import numpy as np
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.mesh import beam_mesh as j_beam_mesh, dirichlet_nodes as j_dnodes
from savtpu.ops.element import batch_element_mkf as j_mkf
from savtpu.ops.material import LinearElastic as JLinearElastic
from savtpu.parallel import (
    ShardedProblem as JShardedProblem,
    build_partition_maps as j_maps,
    partition_elements as j_partition,
)
from savtpu.parallel.halo import rcm_reorder_maps as j_rcm
from savtpu.solvers import setup_problem as j_setup

from savtpu_torch.config import Config as TConfig
from savtpu_torch.mesh import beam_mesh as t_beam_mesh, dirichlet_nodes as t_dnodes
from savtpu_torch.ops.element import batch_element_mkf as t_mkf
from savtpu_torch.ops.material import LinearElastic as TLinearElastic
from savtpu_torch.parallel import (
    ShardedProblem as TShardedProblem,
    build_partition_maps as t_maps,
    partition_elements as t_partition,
    rcm_reorder_maps as t_rcm,
)
from savtpu_torch.solvers import setup_problem as t_setup

torch.set_num_threads(1)

CELLS = (12, 2, 2)
EXTENT = (6.0, 1.0, 1.0)
N_PARTS = 4


def _cfgs():
    out = []
    for C in (JConfig, TConfig):
        cfg = C()
        cfg.beam_cells = CELLS
        cfg.beam_extent = EXTENT
        cfg.partition.n_parts = N_PARTS
        out.append(cfg)
    return out


def _maps_equal(a, b):
    assert a.n_parts == b.n_parts
    np.testing.assert_array_equal(a.epart, b.epart)
    np.testing.assert_array_equal(a.global_shared, b.global_shared)
    for field in ("local_elements", "local_nodes", "shared_nodes",
                  "local_dirichlet"):
        for x, y in zip(getattr(a, field), getattr(b, field)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_mesh_identical():
    a, b = j_beam_mesh(*CELLS, extent=EXTENT), t_beam_mesh(*CELLS, extent=EXTENT)
    np.testing.assert_array_equal(a.points, b.points)
    for k in ("tetra", "triangle"):
        np.testing.assert_array_equal(a.cells[k], b.cells[k])
    np.testing.assert_array_equal(
        j_dnodes(a.triangles, a.points), t_dnodes(b.triangles, b.points)
    )


@pytest.mark.parametrize("method", ["rcb", "slab"])
def test_partition_maps_identical(method):
    m = t_beam_mesh(*CELLS, extent=EXTENT)
    ep_j = j_partition(m.tetra, m.points, N_PARTS, method=method)
    ep_t = t_partition(m.tetra, m.points, N_PARTS, method=method)
    np.testing.assert_array_equal(ep_j, ep_t)
    dn = t_dnodes(m.triangles, m.points)
    mj = j_maps(m.tetra, ep_j, m.num_points, dn)
    mt = t_maps(m.tetra, ep_t, m.num_points, dn)
    _maps_equal(mj, mt)
    _maps_equal(j_rcm(mj, m.tetra), t_rcm(mt, m.tetra))


def test_element_integrals_f64():
    rng = np.random.default_rng(0)
    m = t_beam_mesh(*CELLS, extent=EXTENT)
    coords = m.points[m.tetra] + 0.05 * rng.standard_normal((len(m.tetra), 4, 3))
    kw = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5, ramped=True)
    Mj, Kj, Fj = j_mkf(1, 2, JLinearElastic.from_engineering(**kw), 0.3,
                       np.asarray(coords))
    Mt, Kt, Ft = t_mkf(1, 2, TLinearElastic.from_engineering(**kw), 0.3,
                       torch.as_tensor(coords, dtype=torch.float64))
    for a, b in ((Mj, Mt), (Kj, Kt), (Fj, Ft)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-12 * np.abs(a).max())


def test_setup_problem_f64():
    cj, ct = _cfgs()
    pj, pt = j_setup(cj), t_setup(ct)
    assert pt.dt == pj.dt
    np.testing.assert_array_equal(pt.edofs, pj.edofs)
    np.testing.assert_array_equal(pt.dirichlet_dofs, pj.dirichlet_dofs)
    for name in ("Ke", "lumped_M", "F_pre", "mask", "d0", "dn"):
        a = np.asarray(getattr(pj, name))
        b = getattr(pt, name).numpy()
        np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-12 * max(np.abs(a).max(), 1e-300),
            err_msg=name,
        )


@pytest.mark.parametrize("fint_mode", ["banded", "dense"])
def test_sharded_build_arrays(fint_mode):
    """Banded/dense build on the same maps: identical index arrays (RCM
    order, shared slots) and the same stiffness storage in float64."""
    cj, ct = _cfgs()
    pj, pt = j_setup(cj), t_setup(ct)
    m = pt.mesh
    ep = t_partition(m.tetra, m.points, N_PARTS)
    dn = t_dnodes(m.triangles, m.points)
    maps = t_maps(m.tetra, ep, m.num_points, dn)
    sj = JShardedProblem.build(pj, j_maps(m.tetra, ep, m.num_points, dn),
                               fint_mode=fint_mode, compensated=True)
    st = TShardedProblem.build(pt, maps, fint_mode=fint_mode,
                               compensated=True)
    assert (st.DL, st.SD, st.fint_mode) == (sj.DL, sj.SD, sj.fint_mode)
    _maps_equal(sj.maps, st.maps)
    np.testing.assert_array_equal(st.local_dofs_global, sj.local_dofs_global)
    for name in ("sld", "sgi", "smask", "dof_mask", "bc_mask", "lM", "F_pre"):
        np.testing.assert_array_equal(
            getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
            err_msg=name,
        )
    pairs = (("band_Kd", "band_Kd"), ("band_Kl", "band_Kl")) \
        if fint_mode == "banded" else (("denseK", "denseK"),)
    for tn, jn in pairs:
        a = np.asarray(getattr(sj, jn))
        np.testing.assert_allclose(getattr(st, tn).numpy(), a, rtol=0,
                                   atol=1e-12 * np.abs(a).max(), err_msg=tn)


def test_steady_displacement_f64():
    from savtpu.solvers.steady import steady_displacement as j_steady
    from savtpu_torch.solvers.steady import steady_displacement as t_steady

    cj, ct = _cfgs()
    a = np.asarray(j_steady(j_setup(cj)))
    b = t_steady(t_setup(ct))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-10 * np.abs(a).max())
