"""Blended re-synchronization: ``stacked_run``'s ``blend`` and stage 4's
resync blocks (``surrogate.resync_blocks``) against savtpu's, on the CPU.

- blend endpoints (tests/test_compensated.py): w = 1 gives the exchanged
  run, w = 0 the comm-free overwrite, plain and compensated, 1e-12;
- an exchanged run blended along the smoothstep ramp: savtpu's at 1e-12,
  plain and compensated;
- stage 4 with ``resync_blocks = 2`` from savtpu's stage 1-3 artifacts
  (its models carried across) against savtpu's stage 4, on the small
  configuration of tests/test_torch_lstm_pipeline.py at 150 steps: two
  predicted blocks, a resync block, two more, a second resync block and a
  ragged tail. The limits are the port's stage-4 tests' own: warm-up
  rows 1e-10; the float64 LSTM 1e-9; expfit and the hybrid 5e-6 (their
  comm-free blocks take the float32 expfit feed of both packages, whose
  transcendentals differ in the last bits; the resync blocks take host
  float64 rows).

The ``gpu`` leg replays a blended run from CUDA graphs against the eager
loop, bit for bit. This module imports JAX and savtpu only inside its CPU
tests, so on the card it runs as ``python -m pytest --noconftest -m gpu
tests/test_torch_resync.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_PARTS = 2
WARM = 1e-10
LIMITS = {"lstm": 1e-9, "expfit": 5e-6, "hybrid": 5e-6}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _port(compensated, dtype=torch.float64, device="cpu", cells=(8, 1, 1)):
    from savtpu_torch.benchmarks.sweep import build_case

    return build_case(*cells, N_PARTS, "dense", compensated=compensated,
                      device=device, dtype=dtype)


def _preds(sp, steps):
    S3 = int(sp.sld.shape[1])
    t = np.linspace(0, 1, steps)[None, :, None]
    return 1e-3 * np.sin(2 * np.pi * t + np.arange(S3)[None, None, :]) \
        * np.ones((sp.n_parts, 1, 1))


def _smoothstep(steps):
    t = np.linspace(0.0, 1.0, steps)
    return t * t * (3.0 - 2.0 * t)


@pytest.mark.parametrize("compensated", [False, True])
def test_blend_endpoints(compensated):
    """blend = 1 equals the exchanged run; blend = 0 the comm-free
    overwrite run."""
    from savtpu_torch.parallel import ShardedSolver

    steps = 80
    prob, sp = _port(compensated)
    sol = ShardedSolver(sp)
    d0, dn = sp.localize(prob.d0), sp.localize(prob.dn)
    preds = torch.as_tensor(_preds(sp, steps))
    ones = torch.ones(steps, dtype=torch.float64)
    (t_sync, _), _ = sol.run(d0, dn, 0.0, steps, sync=True)
    (t_b1, _), _ = sol.run(d0, dn, 0.0, steps, sync=True, preds=preds,
                           blend=ones)
    assert torch.allclose(t_b1, t_sync, rtol=0, atol=1e-12)
    (t_ov, _), _ = sol.run(d0, dn, 0.0, steps, sync=False, preds=preds)
    (t_b0, _), _ = sol.run(d0, dn, 0.0, steps, sync=False, preds=preds,
                           blend=0.0 * ones)
    assert torch.allclose(t_b0, t_ov, rtol=0, atol=1e-12)
    assert float((t_b1 - t_b0).abs().max()) > 1e-6  # the ends differ


@pytest.mark.parametrize("compensated", [False, True])
def test_blended_run_matches_savtpu(compensated):
    """An exchanged run whose shared DOFs move from the prediction to the
    dynamics along the smoothstep: savtpu's trajectory and shared rows."""
    import jax.numpy as jnp
    from savtpu.config import Config as JConfig
    from savtpu.mesh import dirichlet_nodes
    from savtpu.parallel import build_partition_maps, partition_elements
    from savtpu.parallel.sharded import ShardedProblem as JSP
    from savtpu.parallel.sharded import ShardedSolver as JSolver
    from savtpu.solvers import setup_problem

    from savtpu_torch.parallel import ShardedSolver

    steps = 60
    prob, sp = _port(compensated)
    jc = JConfig()
    jc.beam_cells = (8, 1, 1)
    jc.beam_extent = (8.0, 1.0, 1.0)
    pj = setup_problem(jc)
    m = pj.mesh
    mj = build_partition_maps(
        m.tetra, partition_elements(m.tetra, m.points, N_PARTS, "rcb"),
        m.num_points, dirichlet_nodes(m.triangles, m.points))
    sj = JSP.build(pj, mj, fint_mode="dense", dtype=jnp.float64,
                   compensated=compensated)
    preds, w = _preds(sp, steps), _smoothstep(steps)
    (tt, ts), ct = ShardedSolver(sp).run(
        sp.localize(prob.d0), sp.localize(prob.dn), 0.0, steps, sync=True,
        preds=torch.as_tensor(preds), blend=torch.as_tensor(w))
    (jt, js), cj = JSolver(sj).run(
        sj.localize(pj.d0), sj.localize(pj.dn), 0.0, steps, sync=True,
        preds=jnp.asarray(preds), blend=jnp.asarray(w))
    assert _rel(tt.numpy(), jt) <= 1e-12
    assert _rel(ts.numpy(), js) <= 1e-12
    assert _rel(ct[0].numpy(), cj[0]) <= 1e-12


def test_run_streamed_carries_the_blend():
    """run_streamed cuts the blend weights with the predictions: in
    chunks of 25 steps it gives the single run's rows and carry."""
    from savtpu_torch.parallel import ShardedSolver

    steps = 100
    prob, sp = _port(False)
    sol = ShardedSolver(sp)
    d0, dn = sp.localize(prob.d0), sp.localize(prob.dn)
    kw = dict(sync=True, preds=torch.as_tensor(_preds(sp, steps)),
              blend=torch.as_tensor(_smoothstep(steps)), save_every=5)
    (t, s), c = sol.run(d0, dn, 0.0, steps, **kw)
    (th, sh), ch = sol.run_streamed(d0, dn, 0.0, steps, chunk_steps=25,
                                    **kw)
    np.testing.assert_array_equal(th, t.numpy())
    np.testing.assert_array_equal(sh, s.numpy())
    for a, b in zip(ch, c):
        assert torch.equal(a, b)


def test_blend_needs_preds_and_stays_off_the_kernels():
    """A blend without predictions is refused; the K2, K3 and K4 gates
    refuse a blend (their kernels overwrite, they do not blend)."""
    from savtpu_torch.parallel import ShardedSolver

    prob, sp = _port(False)
    d0 = sp.localize(prob.d0)
    w = torch.ones(5, dtype=torch.float64)
    with pytest.raises(ValueError, match="blend needs preds"):
        sp.stacked_run(d0, d0, 0.0, 5, sync=True, blend=w)
    sol = ShardedSolver(sp)
    assert not sol._pallas_scan_ok(False, "none", 1, blend=w)
    assert not sol._banded_scan_ok(False, "none", None, blend=w)
    assert not sp._online_ok(False, d0, "all", 1, 5, blend=w)


def _cfg(C, root, arch, steps=150):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = N_PARTS
    cfg.solver.num_steps = steps
    s = cfg.surrogate
    s.n_past = s.n_future = 4
    s.filter_size = 5
    s.batch_size = 2
    s.num_epochs = 4
    s.hidden_size = 8
    s.learning_rate = 2e-3
    s.dtype = "float64"
    s.resync_blocks = 2
    if arch == "expfit":
        s.arch, s.modal_dim, s.expfit_order, s.cut_off = "expfit", 3, 8, 0.5
    elif arch == "hybrid":
        s.arch, s.modal_dim, s.expfit_order, s.cut_off = "hybrid", 2, 6, 0.5
        s.batch_size = 10
    return cfg


def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return np.array(f["Displacement"])


def _read_msgpack(path, meta):
    from flax import serialization

    return serialization.msgpack_restore(path.read_bytes())


@pytest.mark.parametrize("arch", ["lstm", "expfit", "hybrid"])
def test_stage4_resync_matches_savtpu(arch, tmp_path):
    from savtpu.config import Config as JConfig
    from savtpu.io.artifacts import ArtifactStore as JStore
    from savtpu.io.artifacts import load_displacement as j_load
    from savtpu.pipeline import run_all as j_run_all

    from savtpu_torch.config import Config
    from savtpu_torch.convert import import_savtpu_run
    from savtpu_torch.io.artifacts import ArtifactStore, load_displacement
    from savtpu_torch.pipeline import online_predictor

    jc = _cfg(JConfig, tmp_path / "savtpu", arch)
    j_run_all.run(jc, verbose=False)
    tc = _cfg(Config, tmp_path / "port", arch)
    js = JStore(jc.workdir, jc.model_dir, jc.surrogate.run_tag())
    ts = ArtifactStore(tc.workdir, tc.model_dir, tc.surrogate.run_tag())
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, read_params=_read_msgpack)
    online_predictor.run(tc, verbose=False, device="cpu")
    n_sync = jc.surrogate.i_cri + 1
    for r in range(N_PARTS):
        a, b = load_displacement(ts.modeled_h5(r)), j_load(js.modeled_h5(r))
        assert a.shape == b.shape == (a.shape[0], jc.solver.num_steps)
        assert np.isfinite(a).all()
        scale = np.abs(b).max()
        assert np.abs(a[:, :n_sync] - b[:, :n_sync]).max() <= WARM * scale
        assert np.abs(a - b).max() <= LIMITS[arch] * scale, (
            r, np.abs(a - b).max() / scale)
    import json

    ev = [json.loads(ln) for ln in open(tc.workdir + "/metrics.jsonl")]
    rec = [e for e in ev if e["event"] == "stage4_online"][-1]
    block = tc.surrogate.block_size
    assert rec["n_resync_steps"] == 2 * block
    assert rec["comm_free_fraction"] == pytest.approx(
        (150 - n_sync - 2 * block) / 150, abs=1e-4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph path runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("compensated", [False, True])
def test_cuda_blended_replay_equals_eager(compensated):
    """On the card: a blended exchanged run replayed from CUDA graphs
    against the eager loop, bit for bit; the weights ride as a device
    tensor read by step index, so two ramps through the same captured
    chunks give their own results."""
    dev = _card()
    prob, sp = _port(compensated, dtype=torch.float32, device=dev,
                     cells=(12, 2, 2))
    steps = 250
    d0, dn = sp.localize(prob.d0), sp.localize(prob.dn)
    preds = torch.as_tensor(_preds(sp, steps), dtype=sp.dtype).to(dev)
    t0 = torch.tensor(0.0, dtype=sp.dtype, device=dev)
    for w in (_smoothstep(steps), 1.0 - _smoothstep(steps)):
        blend = torch.as_tensor(w, dtype=sp.dtype).to(dev)
        kw = dict(sync=True, preds=preds, blend=blend, record="all",
                  save_every=5)
        (ta, sa), ca = sp._stacked_run_eager(d0, dn, t0, steps, **kw)
        (tb, sb), cb = sp._stacked_run_chunked(d0, dn, t0, steps, **kw)
        torch.cuda.synchronize()
        for x, y in zip((ta, sa, *ca), (tb, sb, *cb)):
            assert torch.equal(x, y)
