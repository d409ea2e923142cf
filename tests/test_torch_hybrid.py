"""The port's hybrid surrogate (an expfit base per rank plus stacked
LSTMs on the residual mode coefficients: stage 3 ``_run_hybrid``, stage
4's hybrid blocks) against savtpu's, on the CPU; mirrors
tests/test_hybrid.py. The small configuration of tests/test_hybrid.py:
6x1x1 beam, 2 parts, 200 steps, n_p = n_f = 4, n_s = 5, cut_off 0.5,
modal_dim 2, expfit order 6, H 8, one batch an epoch (batch_size 10), so
that savtpu's per-epoch shuffle only reorders a batch.

Tolerances:
- stage 3 on savtpu's traces: the modal basis, the expfit params, the
  residuals and the sidecar 1e-12 (the same NumPy code on the same
  input); the residual LSTMs trained from savtpu's initial parameters
  1e-12 in float64 (tests/test_torch_lstm.py);
- stages 4-5 from savtpu's artifacts: warm-up rows 1e-10; comm-free rows
  5e-6 with the float32 surrogate, the limit of
  tests/test_torch_lstm_pipeline.py, and 5e-6 with the float64 one too:
  the base is the float32 expfit feed in both packages whatever the
  surrogate's dtype (savtpu's ``eval_expfit_device``), and XLA's and
  PyTorch's float32 exp/sin/cos differ by an ulp, which moves the
  prescribed rows by some 1e-7 (measured 1.8e-7 with the float64
  surrogate); tests/test_torch_pipeline.py holds the expfit feed at the
  same 5e-6. The float64 LSTM's own part is held at 1e-12 above and in
  tests/test_torch_lstm.py.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from savtpu.config import Config as JConfig
from savtpu.io.artifacts import ArtifactStore as JStore
from savtpu.io.artifacts import load_displacement as j_load
from savtpu.models.expfit import eval_expfit as j_eval_expfit
from savtpu.models.lstm import init_seq2seq
from savtpu.pipeline import run_all as j_run_all

from savtpu_torch.config import Config as TConfig
from savtpu_torch.convert import import_savtpu_run, lstm_arrays_from_savtpu
from savtpu_torch.io.artifacts import ArtifactStore as TStore
from savtpu_torch.io.artifacts import load_displacement as t_load
from savtpu_torch.io.artifacts import load_params, subtree
from savtpu_torch.models import training as t_training
from savtpu_torch.models.expfit import eval_expfit
from savtpu_torch.models.modal import to_modal
from savtpu_torch.parallel import sharded as t_sharded
from savtpu_torch.pipeline import model_training, online_predictor, plotter
from savtpu_torch.pipeline import run_all as t_run_all

from test_torch_nh_pipeline import _savtpu_run_all

torch.set_num_threads(1)

N_PARTS = 2
EXACT = 1e-12
WARM = 1e-10
FEED = 5e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _cfg(C, root, sur_dtype="float64", steps=200):
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
    s.cut_off = 0.5
    s.arch = "hybrid"
    s.modal_dim = 2
    s.expfit_order = 6
    s.num_epochs = 5
    s.batch_size = 10
    s.hidden_size = 8
    s.learning_rate = 2e-3
    s.dtype = sur_dtype
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


@pytest.fixture(scope="module", params=["float64", "float32"])
def savtpu_run(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"hybrid_{request.param}")
    jc = _cfg(JConfig, root / "savtpu", request.param)
    metrics = j_run_all.run(jc, verbose=False)
    return request.param, jc, metrics


def test_stage3_on_savtpu_traces(savtpu_run, tmp_path, monkeypatch):
    """The port's stage 3 on savtpu's stage-1/2 traces, its residual
    LSTMs started from savtpu's initial parameters (as savtpu's
    fit_stacked draws them)."""
    sur_dtype, jc, _ = savtpu_run
    tc = _cfg(TConfig, tmp_path, sur_dtype)
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, stages=(1, 2))
    s = jc.surrogate
    keys = jax.random.split(jax.random.PRNGKey(s.seed), N_PARTS)
    init = jax.vmap(lambda k: init_seq2seq(
        k, s.modal_dim, s.hidden_size, s.num_layers_encoder, s.bidirectional,
        dtype=jnp.dtype(sur_dtype)))(keys)
    real_fit = t_training.fit_stacked
    monkeypatch.setattr(
        t_training, "fit_stacked", lambda *a, **k: real_fit(
            *a, init_params=lstm_arrays_from_savtpu(
                jax.tree.map(np.asarray, init)), **k))
    model_training.run(tc, verbose=False, device="cpu")
    for r in range(N_PARTS):
        jm = json.loads(js.model_file(r).with_suffix(".json").read_text())
        tm = json.loads(ts.model_file(r).with_suffix(".json").read_text())
        assert set(tm) == set(jm)
        assert tm["arch"] == "hybrid" and tm["expfit_modes"] >= 1
        for k, v in jm.items():
            if k in ("modal_mean", "modal_basis", "scale_max", "scale_min",
                     "expfit_residual_rel"):
                assert _rel(tm[k], v) <= EXACT, k
            elif k.startswith("final_"):
                if sur_dtype == "float64":
                    assert _rel(tm[k], v) <= EXACT, k
            else:
                assert tm[k] == v, k
        got = load_params(ts.model_file(r))
        want = _read_msgpack(js.model_file(r).with_suffix(".msgpack"), jm)
        ef = subtree(got, "expfit")
        assert set(ef) == set(want["expfit"])
        for k, v in want["expfit"].items():
            assert _rel(ef[k], v) <= EXACT, k
        # the residual trace the LSTM trains on
        trace = t_load(ts.shared_dof_h5(r)).T
        mu, basis = np.asarray(tm["modal_mean"]), np.asarray(tm["modal_basis"])
        co = to_modal(trace, mu, basis)
        steps = np.arange(len(co), dtype=float)
        ramp = tm["expfit_ramp_end_row"]
        res = co - eval_expfit(ef, steps, ramp)
        j_res = co - np.asarray(j_eval_expfit(
            {k: np.asarray(v) for k, v in want["expfit"].items()}, steps,
            ramp))
        assert _rel(res, j_res) <= EXACT
        assert np.abs(res).max() < np.abs(co).max()
        if sur_dtype == "float64":
            lstm = subtree(got, "lstm")
            for k, v in lstm_arrays_from_savtpu(want["lstm"]).items():
                assert _rel(lstm[k], v) <= EXACT, k


def test_stage4_and_5_from_savtpu_models(savtpu_run, tmp_path):
    sur_dtype, jc, j_metrics = savtpu_run
    tc = _cfg(TConfig, tmp_path, sur_dtype)
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, read_params=_read_msgpack)
    online_predictor.run(tc, verbose=False, device="cpu")
    t_metrics = plotter.run(tc, verbose=False)
    n_sync = jc.surrogate.i_cri + 1
    for r in range(N_PARTS):
        a, b = t_load(ts.modeled_h5(r)), j_load(js.modeled_h5(r))
        assert a.shape == b.shape and np.isfinite(a).all()
        scale = np.abs(b).max()
        assert np.abs(a[:, :n_sync] - b[:, :n_sync]).max() <= WARM * scale
        assert np.abs(a - b).max() <= FEED * scale, (
            r, np.abs(a - b).max() / scale)
    for k, v in j_metrics.items():
        if "rel_l2" in k:
            assert t_metrics[k] == pytest.approx(
                v, rel=1e-6 if sur_dtype == "float64" else 1e-3), k


@pytest.fixture(scope="module")
def own_run(tmp_path_factory):
    """The port's own stages 1-3 with the hybrid, save_every 5 (so that
    the base's row index is step / save_every)."""
    root = tmp_path_factory.mktemp("hybrid_own")
    cfg = _cfg(TConfig, root)
    cfg.solver.save_every = 5
    t_run_all.run(cfg, verbose=False, device="cpu")
    return root, cfg


def _modeled(cfg):
    st = TStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    return np.stack([t_load(st.modeled_h5(r)) for r in range(N_PARTS)])


def test_zero_residual_equals_expfit(own_run, tmp_path, monkeypatch):
    """With the residual prediction zeroed, the hybrid stage 4 is the
    port's expfit stage 4: the config's arch downgrade on the same
    hybrid artifacts, and an expfit stage 3 + 4 on the same traces
    (tests/test_hybrid.py::test_hybrid_zero_residual_degenerates_to_expfit
    on the port)."""
    root, cfg = own_run
    import copy
    import shutil

    outs = {}
    shutil.copytree(root, tmp_path / "zero")
    c = copy.deepcopy(cfg)
    c.workdir = str(tmp_path / "zero" / "Results")
    c.model_dir = str(tmp_path / "zero" / "Distributed_save")
    real = online_predictor.modal_predict_stacked
    with monkeypatch.context() as m:
        m.setattr(online_predictor, "modal_predict_stacked",
                  lambda *a, **k: real(*a, **k) * 0.0)
        online_predictor.run(c, verbose=False, device="cpu")
    outs["zero"] = _modeled(c)
    shutil.copytree(root, tmp_path / "down")
    c = copy.deepcopy(cfg)
    c.workdir = str(tmp_path / "down" / "Results")
    c.model_dir = str(tmp_path / "down" / "Distributed_save")
    c.surrogate.arch = "expfit"
    online_predictor.run(c, verbose=False, device="cpu")
    outs["downgrade"] = _modeled(c)
    shutil.copytree(root / "Results", tmp_path / "expfit" / "Results")
    c.workdir = str(tmp_path / "expfit" / "Results")
    c.model_dir = str(tmp_path / "expfit" / "Distributed_save")
    model_training.run(c, verbose=False, device="cpu")
    online_predictor.run(c, verbose=False, device="cpu")
    outs["expfit"] = _modeled(c)
    hybrid = _modeled(cfg)
    assert np.isfinite(hybrid).all()
    assert _rel(hybrid, outs["expfit"]) > 1e-9  # the residual LSTM acts
    for k in ("zero", "downgrade"):
        assert _rel(outs[k], outs["expfit"]) <= 1e-6, k
        np.testing.assert_array_equal(outs[k], outs["expfit"])


def test_residual_history_and_projection(own_run, tmp_path, monkeypatch):
    """The three offset traps of the hybrid stage 4, each held directly:
    the residual LSTM projects with a zero mean (mu lives in the base);
    the warm-up window is the recorded rows minus the base at steps
    n_sync - W .. n_sync - 1, evaluated at stored row step / save_every;
    each block rolls its recorded rows minus its base into the window,
    not the rows themselves."""
    import copy
    import shutil

    root, cfg = own_run
    shutil.copytree(root, tmp_path / "run")
    c = copy.deepcopy(cfg)
    c.workdir = str(tmp_path / "run" / "Results")
    c.model_dir = str(tmp_path / "run" / "Distributed_save")
    c.surrogate.pred_consensus = False
    seen = {"hist": [], "modal": [], "resid": [], "preds": [],
            "shared": [], "warm": None}
    real_pred = online_predictor.modal_predict_stacked

    def pred(model, hist, *a, **k):
        out = real_pred(model, hist, *a, **k)
        seen["hist"].append(hist.clone())
        seen["modal"].append(a[3])
        seen["resid"].append(out.clone())
        return out

    real_run = t_sharded.ShardedProblem.stacked_run

    def stacked_run(self, *a, **k):
        out = real_run(self, *a, **k)
        if k.get("preds") is not None and not k.get("sync", True):
            seen["preds"].append(k["preds"].clone())
            seen["shared"].append(out[0][1].clone())
        return out

    real_streamed = t_sharded.ShardedSolver.run_streamed

    def streamed(self, *a, **k):
        out = real_streamed(self, *a, **k)
        seen["warm"] = out[0][1]
        return out

    monkeypatch.setattr(online_predictor, "modal_predict_stacked", pred)
    monkeypatch.setattr(t_sharded.ShardedProblem, "stacked_run", stacked_run)
    monkeypatch.setattr(t_sharded.ShardedSolver, "run_streamed", streamed)
    online_predictor.run(c, verbose=False, device="cpu")
    monkeypatch.undo()

    sur, se = c.surrogate, c.solver.save_every
    W, n_sync, blk = sur.n_past * sur.filter_size, sur.i_cri + 1, \
        sur.block_size
    st = TStore(c.workdir, c.model_dir, sur.run_tag())
    metas = [json.loads(st.model_file(r).with_suffix(".json").read_text())
             for r in range(N_PARTS)]
    efs = [subtree(load_params(st.model_file(r)), "expfit")
           for r in range(N_PARTS)]

    def base_at(steps):
        out = np.zeros((N_PARTS, len(steps), seen["warm"].shape[2]))
        for r, (m, ef) in enumerate(zip(metas, efs)):
            co = eval_expfit(ef, steps, m["expfit_ramp_end_row"])
            mu, basis = np.asarray(m["modal_mean"]), np.asarray(
                m["modal_basis"])
            out[r, :, : mu.shape[0]] = co @ basis + mu
        return out

    # 1. the projection's mean is zero; the ranks' means are not
    assert all(float(md[0].abs().max()) == 0.0 for md in seen["modal"])
    assert max(np.abs(m["modal_mean"]).max() for m in metas) > 0
    assert float(seen["modal"][0][1].abs().max()) > 0
    # 2. the warm-up window: recorded rows minus the base at step / se
    rows = np.arange(n_sync - W, n_sync, dtype=float)
    tail = seen["warm"][:, -W:].astype(np.float64)
    hist0 = seen["hist"][0].numpy()
    want = tail - base_at(rows / se)
    assert _rel(hist0, want) <= EXACT
    for wrong in (rows, rows / se + 1, (rows - 1) / se):
        assert _rel(hist0, tail - base_at(wrong)) > 1e-6
    # 3. block 0's recorded rows minus its base roll into the window
    assert len(seen["preds"]) >= 2
    base0 = (seen["preds"][0].numpy()
             - seen["resid"][0].numpy().astype(np.float32))
    shared0 = seen["shared"][0].numpy()
    hist1 = seen["hist"][1].numpy()[:, -blk:]
    scale = np.abs(base0).max()
    assert np.abs(hist1 - (shared0 - base0)).max() <= 1e-6 * scale
    assert np.abs(hist1 - shared0).max() >= 0.1 * scale


def test_banded_compensated_float32_takes_the_online_kernel(
        savtpu_run, tmp_path, monkeypatch):
    """savtpu's hybrid artifacts through the port's stage 4 in banded,
    compensated float32 state: every full block's hybrid predictions go
    through the online kernel's gate (its plain version on the CPU), and
    the rows stay within float32 state's reach of savtpu's float64 run
    (1e-6 in the warm-up, the feed's 5e-6 over the whole run)."""
    sur_dtype, jc, _ = savtpu_run
    tc = _cfg(TConfig, tmp_path, sur_dtype)
    tc.solver.fint_mode = "banded"
    tc.solver.compensated = True
    tc.solver.dtype = "float32"
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, read_params=_read_msgpack)
    calls = []
    real = t_sharded.online_chunk

    def counted(*a, **k):
        calls.append(tuple(a[11].shape))
        return real(*a, **k)

    monkeypatch.setattr(t_sharded, "online_chunk", counted)
    online_predictor.run(tc, verbose=False, device="cpu")
    monkeypatch.undo()
    sur = tc.surrogate
    n_sync = sur.i_cri + 1
    full = (tc.solver.num_steps - n_sync) // sur.block_size
    assert len(calls) == full and all(s[1] == sur.block_size for s in calls)
    for r in range(N_PARTS):
        a, b = t_load(ts.modeled_h5(r)), j_load(js.modeled_h5(r))
        assert a.dtype == np.float32 and np.isfinite(a).all()
        assert _rel(a[:, :n_sync], b[:, :n_sync]) <= 1e-6
        assert _rel(a, b) <= FEED, (r, _rel(a, b))


def _nh_cfg(C, root):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (8, 2, 2)
    cfg.beam_extent = (4.0, 1.0, 1.0)
    cfg.material.model = "neo_hookean"
    cfg.partition.n_parts = 4
    cfg.partition.method = "box"
    cfg.solver.exchange_mode = "grid"
    cfg.solver.num_steps = 140
    s = cfg.surrogate
    s.n_past = s.n_future = 4
    s.filter_size = 5
    s.cut_off = 0.5
    s.arch = "hybrid"
    s.modal_dim = 3
    s.expfit_order = 6
    s.num_epochs = 3
    s.hidden_size = 8
    s.pred_consensus = False
    return cfg


def test_neo_hookean_box_hybrid(tmp_path):
    """The Neo-Hookean box plant (stencil forces, the grid exchange,
    4 box parts) with the hybrid: savtpu's stage 1-3 artifacts through
    the port's stages 4-5 (warm-up 1e-10 absolute, as
    tests/test_torch_nh_pipeline.py; comm-free rows 5e-6), and the port's
    own stages 1-5 finite."""
    jc = _nh_cfg(JConfig, tmp_path / "savtpu")
    j_metrics = _savtpu_run_all(jc, tmp_path)
    tc = _nh_cfg(TConfig, tmp_path / "port")
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, 4, ts, read_h5=_read_h5,
                      read_params=_read_msgpack)
    online_predictor.run(tc, verbose=False, device="cpu")
    metrics = plotter.run(tc, verbose=False)
    n_sync = jc.surrogate.i_cri + 1
    for r in range(4):
        a, b = t_load(ts.modeled_h5(r)), j_load(js.modeled_h5(r))
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a[:, :n_sync] - b[:, :n_sync]).max() <= WARM
        assert np.abs(a - b).max() <= FEED * np.abs(b).max()
    for k, v in j_metrics.items():
        if "rel_l2" in k:
            assert metrics[k] == pytest.approx(v, rel=1e-3), k
    own = _nh_cfg(TConfig, tmp_path / "own")
    m = t_run_all.run(own, verbose=False, device="cpu")
    assert all(np.isfinite(v) for k, v in m.items() if "rel_l2" in k)
