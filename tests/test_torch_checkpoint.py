"""Checkpoint and resume (``utils/checkpoint.py``, stages 1 and 4) on the
CPU: every resume is bit for bit.

- ``run_with_checkpoints`` (tests/test_aux.py) and ``run_streamed_ckpt``:
  an interrupted run resumed from its checkpoint equals the run that was
  not interrupted, plain and compensated; the state file holds savtpu's
  keys;
- stage 1 and stage 4 killed after a checkpoint and run again
  (tests/test_pipeline.py): the artifacts equal an uninterrupted run's
  and the checkpoint directory is gone; stage 4 with resync blocks, so
  the resync counters ride in the checkpoint;
- a stage-4 checkpoint of another surrogate arch is ignored: the run
  starts fresh;
- a hybrid checkpoint keeps its float64 history window under a float32
  state, so its resume is bit for bit too;
- the stage-1 command line (``python -m savtpu_torch.pipeline.
  data_prepare --device cpu``) resumes a killed run.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from savtpu_torch.config import Config
from savtpu_torch.io.artifacts import ArtifactStore, load_displacement
from savtpu_torch.parallel import ShardedSolver
from savtpu_torch.pipeline import data_prepare, online_predictor, run_all
from savtpu_torch.pipeline.common import build_context
from savtpu_torch.utils.checkpoint import (
    load_solver_state,
    run_streamed_ckpt,
    run_with_checkpoints,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


class Kill(RuntimeError):
    pass


def _kill_on_call(obj, name, n, monkeypatch):
    """Make ``obj.name`` raise on its n-th call (an injected kill)."""
    orig = getattr(obj, name)
    calls = {"n": 0}

    def wrapped(*a, **k):
        calls["n"] += 1
        if calls["n"] == n:
            raise Kill("injected kill")
        return orig(*a, **k)

    monkeypatch.setattr(obj, name, wrapped)
    return calls


def _solver(compensated):
    from savtpu_torch.benchmarks.sweep import build_case

    prob, sp = build_case(6, 1, 1, 2, "dense", compensated=compensated,
                          device="cpu",
                          dtype=torch.float32 if compensated
                          else torch.float64)
    return prob, sp, ShardedSolver(sp)


def test_run_with_checkpoints_resume_bit_exact(tmp_path):
    prob, sp, solver = _solver(False)
    d0, dn = sp.localize(prob.d0), sp.localize(prob.dn)
    (traj_ref, _), carry_ref = solver.run(d0, dn, 0.0, 60, sync=True)
    ck = tmp_path / "state.npz"
    outs, carry, start = run_with_checkpoints(
        solver, d0, dn, 0.0, 60, ck, ckpt_every=20, sync=True)
    assert start == 0 and ck.exists()
    assert torch.equal(torch.cat([o[0] for o in outs], dim=1), traj_ref)
    assert torch.equal(carry[0], carry_ref[0])
    assert load_solver_state(ck)[3] == 60
    # the completed checkpoint resumes past the end: nothing recomputed
    outs2, carry2, start2 = run_with_checkpoints(
        solver, d0 * 0, dn * 0, 0.0, 60, ck, ckpt_every=20, sync=True)
    assert start2 == 60 and outs2 == []
    assert torch.equal(carry2[0], carry_ref[0])


@pytest.mark.parametrize("compensated", [False, True])
def test_run_streamed_ckpt_resume_bit_exact(compensated, tmp_path,
                                            monkeypatch):
    """Killed in its third chunk and resumed: the trajectory, shared rows
    and carry of the run that was not interrupted, bit for bit (in
    compensated float32 too: the chunks re-enter folded at the same
    steps)."""
    prob, sp, solver = _solver(compensated)
    d0, dn = sp.localize(prob.d0), sp.localize(prob.dn)
    kw = dict(sync=True, record="all", save_every=5, ckpt_every=20)
    (t_ref, s_ref), c_ref = run_streamed_ckpt(
        solver, d0, dn, 0.0, 100, ckpt_dir=tmp_path / "a", **kw)
    _kill_on_call(solver, "run", 3, monkeypatch)
    with pytest.raises(Kill):
        run_streamed_ckpt(solver, d0, dn, 0.0, 100,
                          ckpt_dir=tmp_path / "b", **kw)
    monkeypatch.undo()
    with np.load(tmp_path / "b" / "state.npz") as z:
        assert int(z["step"]) == 40
        assert set(z.files) == {"d0", "dn", "tn", "step", "num_steps",
                                "save_every", "ckpt_every", "P", "DL",
                                "sync"}
    (t, s), c = run_streamed_ckpt(solver, d0, dn, 0.0, 100,
                                  ckpt_dir=tmp_path / "b", **kw)
    np.testing.assert_array_equal(t, t_ref)
    np.testing.assert_array_equal(s, s_ref)
    for a, b in zip(c, c_ref):
        assert torch.equal(a, b)


def _small(root, steps=110, resync=0, arch="lstm"):
    cfg = Config()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.solver.num_steps = steps
    s = cfg.surrogate
    s.n_past = s.n_future = 4
    s.filter_size = 5
    s.batch_size = 2
    s.num_epochs = 3
    s.hidden_size = 8
    s.resync_blocks = resync
    if arch == "hybrid":
        s.arch, s.modal_dim, s.expfit_order, s.cut_off = "hybrid", 2, 6, 0.5
        s.batch_size = 10
    return cfg


def _modeled(cfg, what="modeled_h5"):
    st = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    return [load_displacement(getattr(st, what)(r)) for r in range(2)], st


def test_stage1_kill_and_resume(tmp_path, monkeypatch):
    """A stage-1 run killed after its first 40-step checkpoint resumes
    there and writes the uninterrupted run's artifacts bit for bit; the
    checkpoint goes once they are written."""
    ref_cfg = _small(tmp_path / "a", steps=100)
    ref_cfg.solver.ckpt_every = 40
    data_prepare.run(ref_cfg, verbose=False, device="cpu")
    ref, _ = _modeled(ref_cfg, "dynamics_h5")

    cfg = _small(tmp_path / "b", steps=100)
    cfg.solver.ckpt_every = 40
    ctx = build_context(cfg, device="cpu")
    _kill_on_call(ctx.solver, "run", 2, monkeypatch)
    with pytest.raises(Kill):
        data_prepare.run(cfg, ctx=ctx, verbose=False)
    store = ArtifactStore(cfg.workdir, cfg.model_dir, "x")
    assert load_solver_state(
        store.ckpt_dir("stage1") / "state.npz")[3] == 40
    monkeypatch.undo()
    data_prepare.run(cfg, ctx=ctx, verbose=False)
    got, _ = _modeled(cfg, "dynamics_h5")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert not store.ckpt_dir("stage1").exists()


@pytest.fixture(scope="module")
def lstm_run(tmp_path_factory):
    """The port's own stage 1-3 artifacts (stacked LSTMs), and its stage 4
    with two resync blocks and no checkpoints."""
    root = tmp_path_factory.mktemp("ckpt_lstm")
    cfg = _small(root, steps=150, resync=2)
    run_all.run(cfg, verbose=False, device="cpu")
    ref, _ = _modeled(cfg)
    return cfg, ref


def test_stage4_kill_and_resume(lstm_run, monkeypatch):
    """Stage 4 with resync blocks, checkpointed after its warm-up and at
    every group boundary, killed in its second block group and resumed:
    the carry, the history window and the resync counters come back, and
    the modeled artifacts equal the run without checkpoints bit for
    bit."""
    cfg, ref = lstm_run
    cfg.solver.ckpt_every = 1
    try:
        ctx = build_context(cfg, device="cpu")
        # calls of sp.stacked_run: the warm-up's chunks, then one for
        # each block: 0, 1, resync, 3, 4, resync, and the ragged tail
        calls = _kill_on_call(ctx.sp, "stacked_run", 10 ** 9, monkeypatch)
        online_predictor.run(cfg, ctx=ctx, verbose=False)
        n_warm = calls["n"] - 7
        monkeypatch.undo()
        ctx = build_context(cfg, device="cpu")
        # killed in block 3: the last checkpoint followed the resync block
        _kill_on_call(ctx.sp, "stacked_run", n_warm + 4, monkeypatch)
        with pytest.raises(Kill):
            online_predictor.run(cfg, ctx=ctx, verbose=False)
        _, store = _modeled(cfg)
        with np.load(store.ckpt_dir("stage4") / "state.npz") as z:
            assert int(z["done_blocks"]) == 3      # 2 predicted + resync
            assert int(z["n_resync_steps"]) == cfg.surrogate.block_size
            assert str(z["arch"]) == "lstm"
        monkeypatch.undo()
        online_predictor.run(cfg, ctx=build_context(cfg, device="cpu"),
                             verbose=False)
        got, store = _modeled(cfg)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert not store.ckpt_dir("stage4").exists()
    finally:
        cfg.solver.ckpt_every = 0


def test_stage4_checkpoint_of_another_arch_starts_fresh(tmp_path,
                                                        monkeypatch):
    """A hybrid stage-4 run killed after its warm-up checkpoint; the same
    artifacts run again as expfit (savtpu's arch downgrade keeps the
    hybrid's base): the checkpoint's arch differs, so the run starts
    fresh and equals an expfit run that found no checkpoint."""
    cfg = _small(tmp_path, steps=200, arch="hybrid")
    run_all.run(cfg, verbose=False, device="cpu")
    cfg.solver.ckpt_every = 1
    ctx = build_context(cfg, device="cpu")
    calls = _kill_on_call(ctx.sp, "stacked_run", 10 ** 9, monkeypatch)
    online_predictor.run(cfg, ctx=ctx, verbose=False)   # count the calls
    full_blocks = (200 - (cfg.surrogate.i_cri + 1)) \
        // cfg.surrogate.block_size
    n_warm = calls["n"] - full_blocks
    monkeypatch.undo()
    ctx = build_context(cfg, device="cpu")
    _kill_on_call(ctx.sp, "stacked_run", n_warm + 2, monkeypatch)
    with pytest.raises(Kill):
        online_predictor.run(cfg, ctx=ctx, verbose=False)
    monkeypatch.undo()
    _, store = _modeled(cfg)
    with np.load(store.ckpt_dir("stage4") / "state.npz") as z:
        assert str(z["arch"]) == "hybrid" and int(z["done_blocks"]) == 0
        assert int(z["step"]) == cfg.surrogate.i_cri + 1
    cfg.surrogate.arch = "expfit"
    online_predictor.run(cfg, verbose=False, device="cpu")
    resumed_elsewhere, _ = _modeled(cfg)
    assert not store.ckpt_dir("stage4").exists()
    cfg.solver.ckpt_every = 0
    online_predictor.run(cfg, verbose=False, device="cpu")
    fresh, _ = _modeled(cfg)
    for a, b in zip(resumed_elsewhere, fresh):
        np.testing.assert_array_equal(a, b)


def test_stage4_hybrid_resume_keeps_a_wider_history(tmp_path,
                                                   monkeypatch):
    """A hybrid run with a float32 state and a float64 history window,
    killed after its warm-up checkpoint and resumed: the window (float64
    residuals, the warm-up's rows minus the expfit base) comes back in
    its own dtype, so the resumed run equals the uninterrupted one bit for
    bit."""
    cfg = _small(tmp_path, steps=200, arch="hybrid")
    cfg.solver.dtype = "float32"
    cfg.surrogate.hist_dtype = "float64"
    run_all.run(cfg, verbose=False, device="cpu")
    ref, _ = _modeled(cfg)
    cfg.solver.ckpt_every = 1
    ctx = build_context(cfg, device="cpu")
    calls = _kill_on_call(ctx.sp, "stacked_run", 10 ** 9, monkeypatch)
    online_predictor.run(cfg, ctx=ctx, verbose=False)   # count the calls
    full_blocks = (200 - (cfg.surrogate.i_cri + 1)) \
        // cfg.surrogate.block_size
    n_warm = calls["n"] - full_blocks
    monkeypatch.undo()
    ctx = build_context(cfg, device="cpu")
    _kill_on_call(ctx.sp, "stacked_run", n_warm + 2, monkeypatch)
    with pytest.raises(Kill):
        online_predictor.run(cfg, ctx=ctx, verbose=False)
    monkeypatch.undo()
    _, store = _modeled(cfg)
    with np.load(store.ckpt_dir("stage4") / "state.npz") as z:
        assert int(z["done_blocks"]) == 0
        assert str(z["hist_dtype"]) == "float64"
    P, S3 = ctx.sp.n_parts, ctx.sp.sld.shape[1]
    W = cfg.surrogate.n_past * cfg.surrogate.filter_size
    assert (store.ckpt_dir("stage4") / "shared.dat").stat().st_size \
        == P * W * S3 * 8
    ctx = build_context(cfg, device="cpu")
    # the resume starts past the warm-up: a second warm-up would raise
    _kill_on_call(ctx.solver, "run_streamed", 1, monkeypatch)
    online_predictor.run(cfg, ctx=ctx, verbose=False)
    monkeypatch.undo()
    got, _ = _modeled(cfg)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert not store.ckpt_dir("stage4").exists()


def test_stage1_cli_resumes(tmp_path, monkeypatch):
    """``python -m savtpu_torch.pipeline.data_prepare --device cpu
    --config cfg.json --ckpt-every 40`` picks up a killed run's
    checkpoint and writes the uninterrupted run's artifacts; stages 2, 3
    and 5 run from their command lines too."""
    ref_cfg = _small(tmp_path / "ref", steps=100)
    ref_cfg.solver.ckpt_every = 40
    data_prepare.run(ref_cfg, verbose=False, device="cpu")
    ref, _ = _modeled(ref_cfg, "dynamics_h5")

    cfg = _small(tmp_path / "cli", steps=100)
    cfg.solver.ckpt_every = 40
    ctx = build_context(cfg, device="cpu")
    _kill_on_call(ctx.solver, "run", 2, monkeypatch)
    with pytest.raises(Kill):
        data_prepare.run(cfg, ctx=ctx, verbose=False)
    monkeypatch.undo()
    cfg.solver.ckpt_every = 0
    path = tmp_path / "cfg.json"
    cfg.to_json(path)

    def cli(module, *args):
        res = subprocess.run(
            [sys.executable, "-m", f"savtpu_torch.pipeline.{module}",
             "--config", str(path), "--device", "cpu", *args],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert res.returncode == 0, res.stdout + res.stderr
        return res.stdout

    out = cli("data_prepare", "--ckpt-every", "40", "--resume")
    assert "resuming at step 40/100" in out
    got, store = _modeled(cfg, "dynamics_h5")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert not store.ckpt_dir("stage1").exists()
    for module, args in (("shared_extraction", ()),
                         ("model_training", ("--epochs", "2"))):
        cli(module, *args)
    assert all(store.model_file(r).exists() for r in range(2))
    # --device defaults to CUDA: without it the command refuses
    res = subprocess.run(
        [sys.executable, "-m", "savtpu_torch.pipeline.plotter",
         "--config", str(path)], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    if not torch.cuda.is_available():
        assert res.returncode != 0 and "no CUDA device" in res.stderr
