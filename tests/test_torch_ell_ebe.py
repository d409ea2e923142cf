"""The port's ell and ebe internal forces and ``FIntOperator`` against
savtpu's, on the CPU, and the CUDA default of ``ShardedProblem.build``
and ``convert.from_savtpu_arrays``.

- ``ShardedProblem._fint_stacked`` in every linear mode of savtpu (dense,
  ebe, ell, banded) on the same seeded displacement: 1e-12 of the max in
  float64; 1e-5 in float32 (both packages sum 12 or 27 float32 products
  per row in other orders);
- the ell layout (column nodes and summed 3x3 blocks): exactly savtpu's;
- exchanged runs in ell and ebe: savtpu's trajectories at 1e-12;
- ``FIntOperator`` in dense, ebe, bcoo and auto mode: savtpu's at 1e-12.

On a CUDA tensor the ebe fold is a gather (no atomics), so the ``gpu``
legs hold graph replays of ell, ebe and the permute exchange against the
eager loop bit for bit. This module imports JAX and savtpu only inside
its CPU tests, so on the card it runs as ``python -m pytest --noconftest
-m gpu tests/test_torch_ell_ebe.py``.
"""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MODES = ("dense", "ebe", "ell", "banded")
TOL = {"float64": 1e-12, "float32": 1e-5}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _port(mode, dtype=torch.float64, cells=(8, 2, 2), parts=4,
          exchange="psum", device="cpu", compensated=False):
    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu_torch.solvers import setup_problem

    cfg = Config()
    cfg.beam_cells = cells
    cfg.beam_extent = (cells[0] / cells[1], 1.0, 1.0)
    prob = setup_problem(cfg)
    m = prob.mesh
    maps = build_partition_maps(
        m.tetra, partition_elements(m.tetra, m.points, parts, "rcb"),
        m.num_points, dirichlet_nodes(m.triangles, m.points))
    return prob, ShardedProblem.build(
        prob, maps, fint_mode=mode, dtype=dtype, exchange_mode=exchange,
        compensated=compensated, device=device)


def _savtpu(mode, dtype="float64", cells=(8, 2, 2), parts=4,
            exchange="psum"):
    import jax.numpy as jnp
    from savtpu.config import Config
    from savtpu.mesh import dirichlet_nodes
    from savtpu.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu.solvers import setup_problem

    cfg = Config()
    cfg.beam_cells = cells
    cfg.beam_extent = (cells[0] / cells[1], 1.0, 1.0)
    prob = setup_problem(cfg)
    m = prob.mesh
    maps = build_partition_maps(
        m.tetra, partition_elements(m.tetra, m.points, parts, "rcb"),
        m.num_points, dirichlet_nodes(m.triangles, m.points))
    return prob, ShardedProblem.build(
        prob, maps, fint_mode=mode, dtype=getattr(jnp, dtype),
        exchange_mode=exchange)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", MODES)
def test_fint_matches_savtpu(mode, dtype):
    """F_int of the port and of savtpu on one seeded displacement."""
    import jax.numpy as jnp

    _, st = _port(mode, getattr(torch, dtype))
    _, sj = _savtpu(mode, dtype)
    assert st.fint_mode == mode and st.DL == sj.DL
    d = np.random.default_rng(1).standard_normal((st.n_parts, st.DL))
    d = (d * st.dof_mask.numpy()).astype(dtype)
    got = st._fint_stacked(torch.as_tensor(d)).numpy()
    want = np.asarray(sj._fint_stacked(jnp.asarray(d)))
    assert got.dtype == want.dtype
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)


def test_ell_layout_equals_savtpu():
    """The ELLPACK column nodes and summed blocks are savtpu's exactly."""
    _, st = _port("ell")
    _, sj = _savtpu("ell")
    np.testing.assert_array_equal(st.ell_cols.numpy(),
                                  np.asarray(sj.ell_cols))
    np.testing.assert_array_equal(st.ell_blocks.numpy(),
                                  np.asarray(sj.ell_blocks))


@pytest.mark.parametrize("mode", ["ell", "ebe"])
def test_exchanged_run_matches_savtpu(mode):
    """60 exchanged steps from rest under the ramped load, recorded
    trajectory and shared rows, against savtpu's."""
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedSolver

    prob, st = _port(mode)
    pj, sj = _savtpu(mode)
    (tt, ts), ct = ShardedSolver(st).run(
        st.localize(prob.d0), st.localize(prob.dn), 0.0, 60, sync=True)
    (jt, js), cj = JSolver(sj).run(sj.localize(pj.d0), sj.localize(pj.dn),
                                   0.0, 60, sync=True)
    assert _rel(tt.numpy(), jt) <= 1e-12
    assert _rel(ts.numpy(), js) <= 1e-12
    assert _rel(ct[0].numpy(), cj[0]) <= 1e-12


@pytest.mark.parametrize("mode", ["dense", "ebe", "bcoo", "auto"])
def test_fint_operator_matches_savtpu(mode):
    """The global F_int(d) = K_nobc d in each execution strategy."""
    import jax.numpy as jnp
    from savtpu.ops.assembly import FIntOperator as JOp

    from savtpu_torch.ops.assembly import FIntOperator

    prob, _ = _port("dense", cells=(6, 1, 1), parts=2)
    d = np.random.default_rng(2).standard_normal(prob.ndof)
    op = FIntOperator(prob.Ke, prob.edofs, prob.ndof, mode=mode)
    jop = JOp(jnp.asarray(prob.Ke.numpy()), prob.edofs, prob.ndof,
              mode=mode)
    assert op.mode == jop.mode
    got = op(torch.as_tensor(d)).numpy()
    assert _rel(got, np.asarray(jop(jnp.asarray(d)))) <= 1e-12


def test_fint_operator_rejects_unknown_mode():
    from savtpu_torch.ops.assembly import FIntOperator

    prob, _ = _port("dense", cells=(2, 1, 1), parts=2)
    with pytest.raises(ValueError, match="unknown FIntOperator mode"):
        FIntOperator(prob.Ke, prob.edofs, prob.ndof, mode="csr")


@pytest.mark.parametrize("mode", ["ell", "ebe"])
def test_from_savtpu_arrays_carries_ell_and_ebe(mode):
    """savtpu state in ell or ebe mode continues in the port: the same
    forces from the converted problem."""
    import jax.numpy as jnp

    from savtpu_torch.convert import from_savtpu_arrays

    _, sj = _savtpu(mode)
    keys = ("n_parts", "DL", "SD", "dt", "alpha", "ramped", "fint_mode",
            "compensated", "local_dofs_global", "dof_mask", "bc_mask", "lM",
            "F_pre", "sld", "sgi", "smask", "ell_blocks", "ell_cols", "Ke",
            "edofs")
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k in keys if (v := getattr(sj, k, None)) is not None}
    st, _ = from_savtpu_arrays(arrays, device="cpu")
    d = np.random.default_rng(3).standard_normal((st.n_parts, st.DL))
    d = d * st.dof_mask.numpy()
    assert _rel(st._fint_stacked(torch.as_tensor(d)).numpy(),
                np.asarray(sj._fint_stacked(jnp.asarray(d)))) <= 1e-12


def test_build_and_convert_default_to_cuda():
    """ShardedProblem.build and convert.from_savtpu_arrays put their
    tensors on CUDA unless the caller asks for another device: without
    CUDA a call that names no device raises, as utils.resolve_device
    does; with it the tensors land on the card."""
    from savtpu_torch.convert import from_savtpu_arrays
    from savtpu_torch.parallel import ShardedProblem

    prob, sp = _port("dense", cells=(2, 1, 1), parts=2)
    arrays = {k: getattr(sp, k) for k in (
        "n_parts", "DL", "SD", "dt", "alpha", "ramped", "fint_mode",
        "compensated", "local_dofs_global")}
    arrays.update({k: getattr(sp, k).numpy() for k in (
        "dof_mask", "bc_mask", "lM", "F_pre", "sld", "sgi", "smask",
        "denseK")})
    if torch.cuda.is_available():
        assert ShardedProblem.build(prob, sp.maps).device.type == "cuda"
        assert from_savtpu_arrays(arrays)[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedProblem.build(prob, sp.maps)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_savtpu_arrays(arrays)


FLAGS = list(itertools.product((False, True), ("all", "none"), (1, 5)))


def _inputs(sp, steps, seed=0):
    rng = np.random.default_rng(seed)
    P, DL, S3 = sp.n_parts, sp.DL, sp.sld.shape[1]
    T = lambda a: torch.as_tensor(a, dtype=sp.dtype).to(sp.device)  # noqa
    d0 = T(1e-3 * rng.standard_normal((P, DL))) * sp.dof_mask
    dn = d0 - T(1e-6 * rng.standard_normal((P, DL))) * sp.dof_mask
    preds = T(1e-4 * rng.standard_normal((P, steps, S3))) * sp.smask[:, None]
    blend = T(np.linspace(0.0, 1.0, steps))
    return d0, dn, T(0.05), preds, blend


def _flat(out):
    (traj, shared), carry = out
    return [x for x in (traj, shared, *carry) if x is not None]


def _chunked_vs_eager(sp, steps=25, graph_steps=10):
    d0, dn, t0, preds, blend = _inputs(sp, steps)
    for sync, (use_preds, record, se) in itertools.product(
            (True, False), FLAGS):
        for use_blend in ((False, True) if use_preds else (False,)):
            kw = dict(sync=sync, preds=preds if use_preds else None,
                      blend=blend if use_blend else None, record=record,
                      save_every=se)
            a = _flat(sp._stacked_run_eager(d0, dn, t0, steps, **kw))
            b = _flat(sp._stacked_run_chunked(d0, dn, t0, steps,
                                              graph_steps=graph_steps, **kw))
            if sp.device.type == "cuda":
                torch.cuda.synchronize()
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert torch.equal(x, y), (sync, use_preds, use_blend,
                                           record, se)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("mode,exchange", [("ell", "psum"), ("ebe", "psum"),
                                           ("dense", "permute")])
def test_chunked_stepper_equals_eager_on_cpu(mode, exchange, compensated):
    """The chunked stepper (whose bodies the card captures) gives the
    eager loop's bits in ell, ebe and with the permute exchange, blend
    on and off."""
    _, sp = _port(mode, exchange=exchange, compensated=compensated,
                  cells=(6, 2, 2))
    _chunked_vs_eager(sp)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph path runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("mode,exchange", [("ell", "psum"), ("ebe", "psum"),
                                           ("dense", "permute"),
                                           ("banded", "permute")])
def test_cuda_replay_equals_eager(mode, exchange, compensated):
    """On the card: graph replays of ell, ebe and the permute exchange
    (with blended predictions too) against the eager loop, bit for bit:
    no atomics in the ebe fold or the permute's add."""
    dev = _card()
    _, sp = _port(mode, dtype=torch.float32, cells=(12, 2, 2), parts=4,
                  exchange=exchange, device=dev, compensated=compensated)
    _chunked_vs_eager(sp)
