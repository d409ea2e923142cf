"""The port's default-arch (LSTM) pipeline against savtpu's, on the CPU:
stage 3 on savtpu's stage-2 traces, and stages 4-5 from savtpu's stage
1-3 artifacts with its trained models carried across (flax msgpack ->
the port's parameter names). The small configuration of
tests/test_pipeline.py: 6x1x1 beam, 2 parts, n_p = n_f = 4, n_s = 5, H 8,
a few epochs, float64 state; 110 steps, so 20 synchronized steps, four
20-step comm-free blocks and a ragged 10-step tail.

Tolerances (max |a - b| over the trajectory's max):
- stage-4 warm-up rows: 1e-10 (the packages differ only in matvec sum
  order);
- comm-free rows with a float64 surrogate: 1e-9. The LSTM predictions
  agree at 1e-15 (tests/test_torch_lstm.py); the comm-free solve, fed
  them at every step, carries that with the sum-order differences of the
  warm-up;
- comm-free rows with the float32 surrogate: 5e-6, the limit of the
  expfit feed (tests/test_torch_pipeline.py): both packages predict in
  float32 and their float32 products and transcendentals differ in the
  last bits.
"""

import json

import numpy as np
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.io.artifacts import ArtifactStore as JStore
from savtpu.io.artifacts import load_displacement as j_load
from savtpu.pipeline import model_training as j_model_training
from savtpu.pipeline import run_all as j_run_all

from savtpu_torch.config import Config as TConfig
from savtpu_torch.convert import import_savtpu_run
from savtpu_torch.io.artifacts import ArtifactStore as TStore
from savtpu_torch.io.artifacts import load_displacement as t_load
from savtpu_torch.pipeline import model_training, online_predictor, plotter

torch.set_num_threads(1)

N_PARTS = 2
EXACT = 1e-10
LIMITS = {"float64": 1e-9, "float32": 5e-6}
CASES = {
    "float64": ("float64", False),
    "float32": ("float32", False),
    "float64_smooth_anchor": ("float64", True),
}


def _cfg(C, root, sur_dtype, refine):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = N_PARTS
    cfg.solver.num_steps = 110
    s = cfg.surrogate
    s.n_past = s.n_future = 4
    s.filter_size = 5
    s.batch_size = 2
    s.num_epochs = 4
    s.hidden_size = 8
    s.learning_rate = 2e-3
    s.dtype = sur_dtype
    if refine:
        s.pred_smooth = 5
        s.pred_anchor = True
    return cfg


def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return np.array(f["Displacement"])


def _read_msgpack(path, meta):
    from flax import serialization

    return serialization.msgpack_restore(path.read_bytes())


def _stores(jc, tc):
    return (JStore(jc.workdir, jc.model_dir, jc.surrogate.run_tag()),
            TStore(tc.workdir, tc.model_dir, tc.surrogate.run_tag()))


@pytest.fixture(scope="module", params=list(CASES))
def savtpu_run(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"lstm_{request.param}")
    jc = _cfg(JConfig, root / "savtpu", *CASES[request.param])
    metrics = j_run_all.run(jc, verbose=False)
    return request.param, jc, metrics


def test_stage4_and_5_from_savtpu_models(savtpu_run, tmp_path):
    """savtpu's stage 1-3 artifacts, its LSTMs converted: the port's
    stage 4 and stage 5 give savtpu's modeled trajectories and metrics."""
    case, jc, j_metrics = savtpu_run
    sur_dtype, refine = CASES[case]
    tc = _cfg(TConfig, tmp_path, sur_dtype, refine)
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, read_params=_read_msgpack)
    online_predictor.run(tc, verbose=False, device="cpu")
    t_metrics = plotter.run(tc, verbose=False)
    n_sync = jc.surrogate.i_cri + 1
    limit = LIMITS[sur_dtype]
    for r in range(N_PARTS):
        a, b = t_load(ts.modeled_h5(r)), j_load(js.modeled_h5(r))
        assert a.shape == b.shape == (a.shape[0], jc.solver.num_steps)
        assert np.isfinite(a).all()
        scale = np.abs(b).max()
        assert np.abs(a[:, :n_sync] - b[:, :n_sync]).max() <= EXACT * scale
        assert np.abs(a - b).max() <= limit * scale, (
            r, np.abs(a - b).max() / scale)
    assert set(t_metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        if "rel_l2" in k:
            assert t_metrics[k] == pytest.approx(
                v, rel=1e-6 if sur_dtype == "float64" else 1e-3), k
        else:
            assert t_metrics[k] == v, k


def test_stage3_on_savtpu_traces(savtpu_run, tmp_path):
    """The port's stage 3 on savtpu's stage-1/2 artifacts: the same
    windows and scale constants, the sidecar keys and architecture of
    savtpu's, and its training-curve files."""
    case, jc, _ = savtpu_run
    tc = _cfg(TConfig, tmp_path, *CASES[case])
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, stages=(1, 2))
    model_training.run(tc, verbose=False, device="cpu")
    eff = model_training.effective_filter(tc)
    assert eff == j_model_training.effective_filter(jc)
    for r in range(N_PARTS):
        trace = t_load(ts.shared_dof_h5(r)).T
        for a, b in zip(
                model_training._phase_windows(trace, tc.surrogate, eff),
                j_model_training._phase_windows(trace, jc.surrogate, eff)):
            np.testing.assert_array_equal(a, b)
        jm = json.loads(js.model_file(r).with_suffix(".json").read_text())
        tm = json.loads(ts.model_file(r).with_suffix(".json").read_text())
        assert set(tm) == set(jm)
        for k, v in jm.items():
            if not k.startswith("final_"):
                assert tm[k] == v, k
        params = dict(np.load(ts.model_file(r)))
        assert params["decoder.Wi"].shape == (jm["input_size"],
                                              8 * jm["hidden_size"])
        for f in ("train_loss.csv", "test_loss.csv", "train_acc_r2.csv",
                  "test_acc_r2.csv", "train_acc_rel.csv",
                  "test_acc_rel.csv"):
            got = np.loadtxt(ts.model_run_dir(r) / f, delimiter=",")
            want = np.loadtxt(js.model_run_dir(r) / f, delimiter=",")
            assert got.shape == want.shape == (jc.surrogate.epochs,), f
            assert np.isfinite(got).all(), f
    # stage 4 then runs from the port's own models
    online_predictor.run(tc, verbose=False, device="cpu")
    for r in range(N_PARTS):
        a = t_load(ts.modeled_h5(r))
        assert a.shape[1] == jc.solver.num_steps and np.isfinite(a).all()


def test_stage3_and_stage4_refuse_what_is_not_ported(tmp_path):
    tc = _cfg(TConfig, tmp_path, "float32", False)
    for attr, val in (("stacked", False), ("ensemble", 2),
                      ("arch", "linear"), ("arch", "hybrid")):
        c = _cfg(TConfig, tmp_path, "float32", False)
        setattr(c.surrogate, attr, val)
        with pytest.raises(NotImplementedError):
            model_training.run(c, verbose=False, device="cpu")
    for attr, val in (("resync_blocks", 2), ("ensemble", 2)):
        c = _cfg(TConfig, tmp_path, "float32", False)
        setattr(c.surrogate, attr, val)
        with pytest.raises(NotImplementedError):
            online_predictor._check_supported(c)
    tc.solver.ckpt_every = 100
    with pytest.raises(NotImplementedError):
        online_predictor._check_supported(tc)


def test_smooth_preds_matches_savtpu():
    """smooth_preds on the same block and history as savtpu's."""
    import jax.numpy as jnp
    from savtpu.pipeline.online_predictor import smooth_preds as j_smooth

    rng = np.random.default_rng(0)
    preds = rng.normal(size=(2, 20, 6))
    hist = rng.normal(size=(2, 12, 6))
    for win in (1, 2, 5, 9):
        got = online_predictor.smooth_preds(
            torch.as_tensor(preds), torch.as_tensor(hist), win).numpy()
        want = np.asarray(j_smooth(jnp.asarray(preds), jnp.asarray(hist),
                                   win))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def test_anchor_block_fixed_point():
    """anchor_block's exchanged-step de-bias leaves exact predictions as
    they are (tests/test_pipeline.py::test_pred_anchor_fixed_point on the
    port)."""
    from savtpu_torch.pipeline.common import build_context

    cfg = TConfig()
    cfg.beam_cells = (8, 1, 1)
    cfg.beam_extent = (8.0, 1.0, 1.0)
    ctx = build_context(cfg, device="cpu")
    sp, solver, prob = ctx.sp, ctx.solver, ctx.prob
    d0, dn = sp.localize(prob.d0), sp.localize(prob.dn)
    (_, _), carry0 = solver.run(d0, dn, 0.0, 10, sync=True, record="none")
    (_, true_rows), _ = solver.run(*carry0, 20, sync=True, record="shared")
    out = online_predictor.anchor_block(sp, carry0, true_rows)
    assert (out - true_rows).abs().max().item() <= 1e-14
