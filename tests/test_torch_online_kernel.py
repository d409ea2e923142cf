"""The online block's plain version (savtpu_torch/ops/online_banded.py)
against savtpu's Pallas kernel ``pallas_online_chunk`` in interpret mode,
on exactly the inputs savtpu's own online path hands that kernel (captured
from ``ShardedProblem._online_pallas_run``), set up as in
tests/test_online_kernel.py.

Tolerances: float64 1e-12 of each output's norm (the two sum the band
matvec and the translation mean in different orders; everything else
rounds identically). float32 2e-4, the bound of savtpu's own float32
kernel test. Sub-chunking must reproduce a single chunk exactly: the
state passes between chunks unrounded.

The ``gpu`` legs hold the CUDA kernel against the plain version, with
chip_smoke.py's limits (``RTOL`` with the band; bit for bit with the band
zeroed); they skip where no CUDA device is present. It needs neither JAX nor savtpu
(both are imported inside the CPU tests), so on a machine with the card
it runs as ``python -m pytest --noconftest -m gpu
tests/test_torch_online_kernel.py``.
"""

import numpy as np
import pytest
import torch

from savtpu_torch.convert import from_savtpu_arrays
from savtpu_torch.ops.online_banded import (
    RTOL,
    block_distance,
    online_chunk,
    online_chunk_plain,
)

torch.set_num_threads(1)


def _sharded_banded(dtype):
    from savtpu.config import Config
    from savtpu.mesh import dirichlet_nodes
    from savtpu.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu.solvers import setup_problem

    cfg = Config()
    cfg.beam_cells = (12, 2, 2)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    prob = setup_problem(cfg, dtype=dtype)
    epart = partition_elements(
        prob.mesh.tetra, prob.mesh.points, 4, method="rcb"
    )
    dn_nodes = dirichlet_nodes(prob.mesh.triangles, prob.mesh.points)
    maps = build_partition_maps(
        prob.mesh.tetra, epart, prob.mesh.num_points, dn_nodes
    )
    sp = ShardedProblem.build(
        prob, maps, fint_mode="banded", dtype=dtype, compensated=True
    )
    return prob, sp


def _preds(sp, steps, dtype, seed=0):
    """Smooth synthetic shared-DOF rows (sinusoids per slot)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    P, S3 = sp.sld.shape
    t = np.arange(steps)[None, :, None]
    amp = rng.uniform(0.01, 0.05, (P, 1, S3))
    w = rng.uniform(0.001, 0.01, (P, 1, S3))
    return jnp.asarray(amp * np.sin(w * t), dtype=dtype)


def _captured_pallas_call(sp, prob, preds, steps, save_every, monkeypatch):
    """Run savtpu's online path; return the Pallas kernel's inputs and
    outputs of each of its sub-chunks as numpy."""
    import jax.numpy as jnp
    from savtpu.ops import pallas_banded

    calls = []
    real = pallas_banded.pallas_online_chunk

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(([np.asarray(a) for a in args], kw,
                      [np.asarray(o) for o in out]))
        return out

    monkeypatch.setattr(pallas_banded, "pallas_online_chunk", spy)
    d0 = sp.localize(prob.d0) + 1e-3 * jnp.asarray(
        np.random.default_rng(1).standard_normal((sp.n_parts, sp.DL)),
        dtype=sp.lM.dtype,
    ) * sp.dof_mask
    assert sp._online_pallas_ok(False, preds, None, "all", save_every,
                                steps, sp.lM.dtype)
    sp._online_pallas_run(d0, d0, jnp.asarray(0.25, sp.lM.dtype), steps,
                          preds, save_every)
    assert calls
    return calls


def _port_args(sp, args, kw, device="cpu"):
    """The Pallas kernel's inputs in the port's layout."""
    Kd, Kl, hi, lo, v, Fp, lM, bc, mc, csel, sld3, sm3, preds_c = args
    S3 = sp.sld.shape[1]
    dtype = torch.as_tensor(np.array(hi[:1, 0, :1])).dtype
    T = lambda a: torch.as_tensor(np.array(a)).to(device)  # noqa: E731
    vec = lambda a: T(a[:, 0, :])  # noqa: E731
    dm = csel[:, 0] + csel[:, 1] + csel[:, 2]
    targs = (T(Kd), T(Kl), vec(hi), vec(lo), vec(v), vec(Fp), vec(lM),
             vec(bc), T(dm), T(np.asarray(sp.sld, np.int64)),
             T(np.asarray(sp.smask)).to(dtype),
             T(np.ascontiguousarray(preds_c[:, :, :S3])))
    t0, i0 = kw["t0_i0"]
    tkw = dict(t0=float(t0), i0=float(i0), dt=kw["dt"], alpha=kw["alpha"],
               ramped=kw["ramped"], save_every=kw["save_every"])
    return targs, tkw


def _close(a, b, tol, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-30), (
        what, np.linalg.norm(a - b) / max(nb, 1e-30))


def _check(sp, out_t, out_j, tol):
    S3 = sp.sld.shape[1]
    hi, lo, v, shared, traj = out_j
    state = np.linalg.norm(hi)
    _close(out_t[0].numpy(), hi[:, 0, :], tol, "hi")
    # lo is the round-off word of the state: measured on the state's scale
    assert (np.linalg.norm(out_t[1].numpy() - lo[:, 0, :])
            <= tol * state), "lo"
    _close(out_t[2].numpy(), v[:, 0, :], tol, "v")
    _close(out_t[3].numpy(), shared[:, :, :S3], tol, "shared")
    _close(out_t[4].numpy(), traj, tol, "traj")


@pytest.mark.parametrize(
    "save_every,steps",
    [
        (1, 60),
        (5, 60),
        (5, 320),   # savtpu's batched multi-tile path
    ],
)
def test_plain_matches_pallas_f64(save_every, steps, monkeypatch):
    import jax.numpy as jnp

    prob, sp = _sharded_banded(jnp.float64)
    preds = _preds(sp, steps, jnp.float64)
    for args, kw, out_j in _captured_pallas_call(sp, prob, preds, steps,
                                                 save_every, monkeypatch):
        targs, tkw = _port_args(sp, args, kw)
        _check(sp, online_chunk_plain(*targs, **tkw), out_j, 1e-12)


def test_plain_matches_pallas_f32(monkeypatch):
    import jax.numpy as jnp

    prob, sp = _sharded_banded(jnp.float32)
    preds = _preds(sp, 40, jnp.float32)
    for args, kw, out_j in _captured_pallas_call(sp, prob, preds, 40, 1,
                                                 monkeypatch):
        targs, tkw = _port_args(sp, args, kw)
        _check(sp, online_chunk_plain(*targs, **tkw), out_j, 2e-4)


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    import jax.numpy as jnp

    prob, sp = _sharded_banded(jnp.float64)
    preds = _preds(sp, 20, jnp.float64)
    args, kw, _ = _captured_pallas_call(sp, prob, preds, 20, 5,
                                        monkeypatch)[0]
    targs, tkw = _port_args(sp, args, kw)
    before = online_chunk.launches
    a = online_chunk(*targs, **tkw)
    b = online_chunk_plain(*targs, **tkw)
    assert online_chunk.launches == before
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _port_problem():
    """The port's ShardedProblem converted from savtpu's arrays."""
    import jax.numpy as jnp

    prob, sp = _sharded_banded(jnp.float64)
    fields = ("n_parts", "DL", "SD", "dt", "alpha", "ramped", "fint_mode",
              "compensated", "local_dofs_global", "dof_mask", "bc_mask",
              "lM", "F_pre", "sld", "sgi", "smask", "band_Kd", "band_Kl")
    arrays = {k: getattr(sp, k) for k in fields}
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in arrays.items()}
    st, _ = from_savtpu_arrays(arrays, device="cpu")
    return prob, sp, st


def test_subchunking_matches_single():
    import jax.numpy as jnp

    _, sp, st = _port_problem()
    steps, se = 60, 5
    preds = torch.as_tensor(np.array(_preds(sp, steps, jnp.float64)))
    rng = np.random.default_rng(3)
    d0 = torch.as_tensor(1e-3 * rng.standard_normal((st.n_parts, st.DL)))
    d0 = d0 * st.dof_mask
    t0 = torch.tensor(0.1, dtype=torch.float64)
    one = st._online_run(d0, d0, t0, steps, preds, se)
    for chunk in (10, 25, 60):
        if chunk % se:
            continue
        many = st._online_run(d0, d0, t0, steps, preds, se, chunk_steps=chunk)
        for a, b in zip(
            (*one[0], *one[1]), (*many[0], *many[1])
        ):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _port_inputs(dtype, device, steps=60, save_every=5, seed=0,
                 cells=(12, 2, 2), n_parts=4):
    """Online-block inputs from the port's own setup (default a 12x2x2
    beam, 4 parts, banded) with a seeded state and smooth seeded
    predictions."""
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
    prob = setup_problem(cfg, dtype=dtype)
    m = prob.mesh
    maps = build_partition_maps(
        m.tetra, partition_elements(m.tetra, m.points, n_parts),
        m.num_points,
        dirichlet_nodes(m.triangles, m.points),
    )
    sp = ShardedProblem.build(prob, maps, fint_mode="banded", dtype=dtype,
                              compensated=True, device=device)
    P, nc, Bk, _ = sp.band_Kd.shape
    DLB, n = nc * Bk, sp.DL - 1
    rng = np.random.default_rng(seed)

    def fit(a, fill=0.0):
        out = torch.full((P, DLB), fill, dtype=dtype, device=device)
        out[:, :n] = a[:, :n]
        return out

    T = lambda a: torch.as_tensor(a, dtype=dtype).to(device)  # noqa: E731
    bc = fit(sp.bc_mask)
    hi = T(1e-3 * rng.standard_normal((P, DLB))) * bc
    v = T(1e-6 * rng.standard_normal((P, DLB))) * bc
    S3 = sp.sld.shape[1]
    t = np.arange(steps)[None, :, None]
    preds = (T(rng.uniform(1e-4, 5e-4, (P, 1, S3))
               * np.sin(rng.uniform(0.001, 0.01, (P, 1, S3)) * t))
             * sp.smask[:, None, :]).contiguous()
    args = (sp.band_Kd, sp.band_Kl, hi, torch.zeros_like(hi), v,
            fit(sp.F_pre), fit(sp.lM, 1.0), bc, fit(sp.dof_mask), sp.sld,
            sp.smask, preds)
    kw = dict(t0=0.05, i0=100, dt=sp.dt, alpha=sp.alpha, ramped=True,
              save_every=save_every)
    return args, kw


def _zero_band(args):
    return (torch.zeros_like(args[0]), torch.zeros_like(args[1]), *args[2:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against its plain version on the card, with the
    limits of chip_smoke.py: the compensated state, v and the recordings
    within RTOL of their scale."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    args, kw = _port_inputs(dtype, torch.device("cuda"))
    before = online_chunk.launches
    out_k = online_chunk(*args, **kw)
    out_p = online_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert online_chunk.launches == before + 1
    for a in out_k:
        assert bool(a.isfinite().all())
    dist = block_distance(out_k, out_p)
    for name in ("state", "v", "shared", "traj"):
        assert dist[name]["max_rel"] <= RTOL[dtype], (name, dist[name])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_rounds_like_plain(dtype):
    """With the band zeroed no result depends on a sum order: the CUDA
    kernel equals its plain version bit for bit, lo included."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    args, kw = _port_inputs(dtype, torch.device("cuda"))
    args = _zero_band(args)
    out_k = online_chunk(*args, **kw)
    out_p = online_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_checks_reject_uncompensated_control():
    """chip_smoke.py's kernel checks, run on the CPU, where the wrapper is
    the plain version: it passes both checks, and the control that drops
    the compensation fails the bit-for-bit one."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    args, kw = _port_inputs(torch.float32, torch.device("cpu"), steps=40)
    res = smoke.check_online_block(args, kw)
    assert res["failures"] == []
    assert res["rounding_kernel_max_abs"] == 0.0
    assert res["band_kernel_max_rel"] == 0.0
    assert res["rounding_control_max_abs"] > 0.0
    assert res["rounding"]["control"]["lo"]["max_abs"] > 0.0


def test_port_inputs_on_cpu_match_plain():
    """The gpu leg's inputs, made on the CPU: the wrapper and the plain
    version agree exactly and no kernel is launched."""
    args, kw = _port_inputs(torch.float64, torch.device("cpu"), steps=20)
    before = online_chunk.launches
    a = online_chunk(*args, **kw)
    b = online_chunk_plain(*args, **kw)
    assert online_chunk.launches == before
    for x, y in zip(a, b):
        assert bool(x.isfinite().all())
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_online_plan_refused_on_cpu_and_when_it_does_not_fit():
    """plan= sets the CUDA kernel's launch: a CPU tensor refuses it, and
    a plan that does not fit the band's shape or a block is refused
    before anything runs."""
    import dataclasses

    from savtpu_torch.ops.band_plan import forced_band_plan

    args, kw = _port_inputs(torch.float64, torch.device("cpu"), steps=10)
    P, nc, Bk, _ = args[0].shape
    good = forced_band_plan(nc, Bk, torch.float64, 3)
    before = online_chunk.launches
    with pytest.raises(ValueError, match="CPU tensor"):
        online_chunk(*args, plan=good, **kw)
    for plan in (forced_band_plan(nc + 1, Bk, torch.float64, 3),
                 dataclasses.replace(good, resident=good.rows + 1),
                 dataclasses.replace(good, rows=good.rows - 1),
                 dataclasses.replace(good, blocks=0),
                 dataclasses.replace(good, smem=300_000)):
        with pytest.raises(ValueError, match="does not fit"):
            online_chunk(*args, plan=plan, **kw)
    assert online_chunk.launches == before


@pytest.mark.parametrize("compensated", [False, True])
def test_online_gate_agrees_with_savtpu(compensated):
    """The port's K3 gate (ShardedProblem._online_ok) takes the same runs
    as savtpu's _online_pallas_ok over (sync, preds, record, save_every,
    num_steps), on a banded problem, plain and compensated."""
    import itertools

    import jax.numpy as jnp
    from savtpu.config import Config as JConfig
    from savtpu.mesh import dirichlet_nodes
    from savtpu.parallel import ShardedProblem as JShardedProblem
    from savtpu.parallel import build_partition_maps, partition_elements
    from savtpu.solvers import setup_problem

    cfg = JConfig()
    cfg.beam_cells = (12, 2, 2)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    prob = setup_problem(cfg, dtype=jnp.float64)
    m = prob.mesh
    maps = build_partition_maps(
        m.tetra, partition_elements(m.tetra, m.points, 4), m.num_points,
        dirichlet_nodes(m.triangles, m.points))
    sj = JShardedProblem.build(prob, maps, fint_mode="banded",
                               dtype=jnp.float64, compensated=compensated)
    fields = ("n_parts", "DL", "SD", "dt", "alpha", "ramped", "fint_mode",
              "compensated", "local_dofs_global", "dof_mask", "bc_mask",
              "lM", "F_pre", "sld", "sgi", "smask", "band_Kd", "band_Kl")
    arrays = {k: getattr(sj, k) for k in fields}
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in arrays.items()}
    st, _ = from_savtpu_arrays(arrays, device="cpu")
    seen = set()
    for sync, use_preds, record, save_every, steps in itertools.product(
            (True, False), (False, True), ("all", "traj", "shared", "none"),
            (1, 5), (30, 32)):
        preds = np.zeros((1,)) if use_preds else None
        ok = st._online_ok(sync, preds, record, save_every, steps)
        assert ok == sj._online_pallas_ok(sync, preds, None, record,
                                          save_every, steps, jnp.float64)
        seen.add(ok)
    assert seen == ({True, False} if compensated else {False})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_every_shape_matches_plain(dtype):
    """K3 on the card in every launch shape band_plan can take (forced:
    1, 3, 8, 12 and 16 blocks with resident rows, 5 streamed, and 2 with
    and without), at 25x2x2/2 (two chunks): bit for bit with the band
    zeroed (lo included), the compensated state, v and the recordings
    within RTOL with the band, one launch per call."""
    import importlib.util
    from pathlib import Path

    from savtpu_torch.ops.band_plan import cluster_table, forced_band_plan

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    args, kw = _port_inputs(dtype, dev, steps=60, cells=(25, 2, 2),
                            n_parts=2)
    P, nc, Bk, _ = args[0].shape
    assert nc > 1
    table = cluster_table("online_banded", dtype, dev)
    plans = smoke.band_shapes(nc, Bk, dtype, table) + [
        forced_band_plan(nc, Bk, dtype, 2),
        forced_band_plan(nc, Bk, dtype, 2, 0)]
    assert len(plans) >= 5
    zargs = _zero_band(args)
    zref = online_chunk_plain(*zargs, **kw)
    ref = online_chunk_plain(*args, **kw)
    for plan in plans:
        before = online_chunk.launches
        zout = online_chunk(*zargs, plan=plan, **kw)
        out = online_chunk(*args, plan=plan, **kw)
        torch.cuda.synchronize()
        assert online_chunk.launches == before + 2, plan
        for a, b in zip(zout, zref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        dist = block_distance(out, ref)
        for name in ("state", "v", "shared", "traj"):
            assert dist[name]["max_rel"] <= RTOL[dtype], (plan, name,
                                                         dist[name])
