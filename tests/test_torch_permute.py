"""The port's neighbour-packed halo exchange (exchange_mode 'permute')
against savtpu's, on the CPU.

- ``build_neighbor_exchange``: rounds, pack and unpack order, masks,
  partners and pairs exactly savtpu's;
- exchanged runs with the permute exchange: savtpu's permute runs at
  1e-12 (the same round order of the additions) and the port's psum runs
  at 1e-12, at 2, 4 and 8 parts (corner nodes shared three ways and more
  from 4 parts), dense and banded;
- a part that would unpack twice into one DOF in a round is refused at
  build (the add is a gather and a scatter, exact only for distinct
  slots).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _meshes(n_parts, cells=(8, 2, 2)):
    """The port's and savtpu's problems and partition maps on one beam."""
    from savtpu.config import Config as JConfig
    from savtpu.mesh import dirichlet_nodes as j_dn
    from savtpu.parallel import build_partition_maps as j_maps
    from savtpu.parallel import partition_elements as j_part
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import build_partition_maps, partition_elements
    from savtpu_torch.solvers import setup_problem

    out = []
    for C, setup, part, bmaps, dn in (
            (Config, setup_problem, partition_elements, build_partition_maps,
             dirichlet_nodes),
            (JConfig, j_setup, j_part, j_maps, j_dn)):
        cfg = C()
        cfg.beam_cells = cells
        cfg.beam_extent = (cells[0] / cells[1], 1.0, 1.0)
        prob = setup(cfg)
        m = prob.mesh
        out.append((prob, bmaps(m.tetra, part(m.tetra, m.points, n_parts,
                                                 "rcb"),
                                m.num_points, dn(m.triangles, m.points))))
    return out


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_neighbor_exchange_equals_savtpus(n_parts):
    from savtpu.parallel.halo import build_neighbor_exchange as j_build

    from savtpu_torch.parallel import build_neighbor_exchange

    (_, mt), (_, mj) = _meshes(n_parts)
    DL = 3 * mt.max_local_nodes + 1
    a, b = build_neighbor_exchange(mt, DL), j_build(mj, DL)
    assert (a.n_rounds, a.buf_len, a.pairs) == (b.n_rounds, b.buf_len,
                                                b.pairs)
    for k in ("pack_idx", "unpack_idx", "mask", "src_of"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, k)


@pytest.mark.parametrize("n_parts,mode", [(2, "dense"), (4, "dense"),
                                          (8, "dense"), (4, "banded")])
def test_permute_run_matches_savtpu_and_psum(n_parts, mode):
    """80 exchanged steps from rest: the port's permute run against
    savtpu's permute run and the port's psum run, recorded trajectory and
    shared rows; duplicated shared DOFs agree across their owners."""
    import jax.numpy as jnp
    from savtpu.parallel.sharded import ShardedProblem as JSP
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedProblem, ShardedSolver

    (pt, mt), (pj, mj) = _meshes(n_parts)
    steps = 80
    runs = {}
    for ex in ("permute", "psum"):
        sp = ShardedProblem.build(pt, mt, fint_mode=mode, exchange_mode=ex,
                                  device="cpu")
        runs[ex] = (sp, ShardedSolver(sp).run(
            sp.localize(pt.d0), sp.localize(pt.dn), 0.0, steps, sync=True))
    sj = JSP.build(pj, mj, fint_mode=mode, exchange_mode="permute",
                   dtype=jnp.float64)
    (jt, js), _ = JSolver(sj).run(sj.localize(pj.d0), sj.localize(pj.dn),
                                  0.0, steps, sync=True)
    sp, ((tp, shp), _) = runs["permute"]
    (ts, shs), _ = runs["psum"][1]
    assert _rel(tp.numpy(), jt) <= 1e-12
    assert _rel(shp.numpy(), js) <= 1e-12
    assert _rel(tp.numpy(), ts.numpy()) <= 1e-12
    assert _rel(shp.numpy(), shs.numpy()) <= 1e-12
    last = tp[:, -1].numpy()
    scale = np.abs(last).max()
    vals = {}
    for p in range(n_parts):
        for slot in np.flatnonzero(sp.smask[p].numpy()):
            g = int(sp.sgi[p, slot])
            v = last[p, int(sp.sld[p, slot])]
            if g in vals:
                assert abs(vals[g] - v) <= 1e-12 * scale
            vals[g] = v


def test_duplicate_unpack_slot_is_refused():
    from savtpu_torch.parallel.sharded import _check_unpack_distinct

    unpack = np.array([[[3, 4, 9, 9]]])
    mask = np.array([[[1.0, 1.0, 0.0, 0.0]]])
    _check_unpack_distinct(unpack, mask)       # padded slots may repeat
    mask[0, 0, 2] = 1.0
    unpack[0, 0, 2] = 4
    with pytest.raises(ValueError, match="unpacks into a DOF twice"):
        _check_unpack_distinct(unpack, mask)
