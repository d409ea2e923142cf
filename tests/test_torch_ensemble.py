"""The port's seed ensembles (``surrogate.ensemble``: E independently
initialized LSTMs per rank, trained on one stacked axis, their
predictions averaged online) against savtpu's, on the CPU; mirrors
tests/test_pipeline.py's ensemble tests. The small configuration of
tests/test_pipeline.py: 6x1x1 beam, 2 parts, 110 steps, n_p = n_f = 4,
n_s = 5, H 8.

Tolerances: the averaged prediction 1e-12 in float64 (a mean of the
members' own predictions); stages 4-5 from savtpu's ensemble artifacts:
warm-up rows 1e-10, comm-free rows 1e-9 with a float64 surrogate and
5e-6 with the float32 one (tests/test_torch_lstm_pipeline.py).
"""

import json

import numpy as np
import pytest
import torch

from savtpu.config import Config as JConfig
from savtpu.io.artifacts import ArtifactStore as JStore
from savtpu.io.artifacts import load_displacement as j_load
from savtpu.pipeline import run_all as j_run_all

from savtpu_torch.config import Config as TConfig
from savtpu_torch.convert import import_savtpu_run, lstm_arrays_from_savtpu
from savtpu_torch.io.artifacts import ArtifactStore as TStore
from savtpu_torch.io.artifacts import load_displacement as t_load
from savtpu_torch.io.artifacts import load_params
from savtpu_torch.models.lstm import StackedSeq2Seq
from savtpu_torch.models.predictor import phase_interleaved_predict_stacked
from savtpu_torch.pipeline import model_training, online_predictor, plotter
from savtpu_torch.pipeline import run_all as t_run_all
from savtpu_torch.pipeline.common import build_context

torch.set_num_threads(1)

EXACT = 1e-12
WARM = 1e-10
LIMITS = {"float64": 1e-9, "float32": 5e-6}


def _cfg(C, root, ens, sur_dtype="float32", modal=0):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.solver.num_steps = 110
    s = cfg.surrogate
    s.n_past = s.n_future = 4
    s.filter_size = 5
    s.batch_size = 2
    s.num_epochs = 3
    s.hidden_size = 8
    s.learning_rate = 2e-3
    s.stacked = True
    s.ensemble = ens
    s.dtype = sur_dtype
    s.modal_dim = modal
    return cfg


def _store(c):
    return TStore(c.workdir, c.model_dir, c.surrogate.run_tag())


@pytest.mark.parametrize("modal", [0, 3])
def test_pipeline_ensemble_surrogate(tmp_path, modal):
    """ensemble=3 through the port's five stages: (3, ...) member stacks
    and savtpu's sidecar key, warm-up rows equal to stage 1's, a bounded
    trajectory."""
    cfg = _cfg(TConfig, tmp_path, 3, modal=modal)
    t_run_all.run(cfg, verbose=False, device="cpu")
    st = _store(cfg)
    n_sync = cfg.surrogate.i_cri + 1
    for r in range(2):
        data = t_load(st.dynamics_h5(r))
        pred = t_load(st.modeled_h5(r))
        assert np.isfinite(pred).all()
        assert np.allclose(pred[:, :n_sync], data[:, :n_sync], atol=1e-10)
        assert np.abs(pred).max() < 10 * max(np.abs(data).max(), 1e-12)
        meta = json.loads(st.model_file(r).with_suffix(".json").read_text())
        assert meta["ensemble"] == 3
        params = load_params(st.model_file(r))
        assert params["decoder.Wi"].shape[0] == 3


def test_ensemble_members_distinct_and_averaged(tmp_path):
    """Members differ (independent draws) and the stacked predictor with
    ens=2 returns the mean of the members' own predictions."""
    cfg = _cfg(TConfig, tmp_path, 2, sur_dtype="float64")
    t_run_all.run(cfg, verbose=False, device="cpu")
    ctx = build_context(cfg, device="cpu")
    m = online_predictor.load_rank_models(ctx)[0]
    assert m.ens == 2
    diffs = [np.abs(v[0] - v[1]).max() for v in m.params.values()]
    assert max(diffs) > 1e-6
    sur = cfg.surrogate
    W = sur.n_past * sur.filter_size
    rng = np.random.default_rng(0)
    hist = torch.as_tensor(rng.normal(size=(1, W, m.input_size)))
    mx = torch.tensor([m.smax], dtype=torch.float64)
    mn = torch.tensor([m.smin], dtype=torch.float64)
    fm = torch.ones((1, m.input_size), dtype=torch.float64)
    net = StackedSeq2Seq.from_arrays(m.params, dtype=torch.float64)
    avg = online_predictor.modal_predict_stacked(net, hist, mx, mn, sur,
                                                 None, fm, ens=2)
    singles = []
    for e in range(2):
        one = StackedSeq2Seq.from_arrays(
            {k: v[e : e + 1] for k, v in m.params.items()},
            dtype=torch.float64)
        with torch.no_grad():
            singles.append(phase_interleaved_predict_stacked(
                one, hist, mx, mn, sur.n_past, sur.n_future,
                sur.filter_size, feat_mask=fm))
    want = ((singles[0] + singles[1]) / 2).numpy()
    assert np.abs(avg.numpy() - want).max() <= EXACT * np.abs(want).max()


def test_ensemble_needs_the_lstm(tmp_path):
    cfg = _cfg(TConfig, tmp_path, 2)
    cfg.surrogate.arch = "linear"
    (tmp_path / "Results" / "sol_on_shared").mkdir(parents=True)
    from savtpu_torch.io.artifacts import save_displacement

    for r in range(2):
        save_displacement(_store(cfg).shared_dof_h5(r),
                          np.random.default_rng(r).normal(size=(6, 110)))
    with pytest.raises(ValueError, match="ensemble"):
        model_training.run(cfg, verbose=False, device="cpu")


# ---- savtpu's ensembles through the port ----

def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return np.array(f["Displacement"])


def _read_msgpack(path, meta):
    from flax import serialization

    return serialization.msgpack_restore(path.read_bytes())


@pytest.fixture(scope="module", params=["float64", "float32"])
def savtpu_run(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"ensemble_{request.param}")
    jc = _cfg(JConfig, root / "savtpu", 2, sur_dtype=request.param)
    metrics = j_run_all.run(jc, verbose=False)
    return request.param, jc, metrics


def test_stage4_and_5_from_savtpu_models(savtpu_run, tmp_path):
    sur_dtype, jc, j_metrics = savtpu_run
    tc = _cfg(TConfig, tmp_path, 2, sur_dtype)
    js = JStore(jc.workdir, jc.model_dir, jc.surrogate.run_tag())
    ts = _store(tc)
    import_savtpu_run(jc.workdir, jc.model_dir, 2, ts, read_h5=_read_h5,
                      read_params=_read_msgpack)
    for r in range(2):
        jm = json.loads(js.model_file(r).with_suffix(".json").read_text())
        want = lstm_arrays_from_savtpu(_read_msgpack(
            js.model_file(r).with_suffix(".msgpack"), jm))
        got = load_params(ts.model_file(r))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape[0] == 2
            np.testing.assert_array_equal(got[k], np.asarray(v))
    online_predictor.run(tc, verbose=False, device="cpu")
    t_metrics = plotter.run(tc, verbose=False)
    n_sync = jc.surrogate.i_cri + 1
    for r in range(2):
        a, b = t_load(ts.modeled_h5(r)), j_load(js.modeled_h5(r))
        assert a.shape == b.shape and np.isfinite(a).all()
        scale = np.abs(b).max()
        assert np.abs(a[:, :n_sync] - b[:, :n_sync]).max() <= WARM * scale
        assert np.abs(a - b).max() <= LIMITS[sur_dtype] * scale, (
            r, np.abs(a - b).max() / scale)
    for k, v in j_metrics.items():
        if "rel_l2" in k:
            assert t_metrics[k] == pytest.approx(
                v, rel=1e-6 if sur_dtype == "float64" else 1e-3), k


def test_stage3_on_savtpu_traces(savtpu_run, tmp_path):
    """The port's ensemble stage 3 on savtpu's traces: savtpu's sidecar
    keys and values, (2, ...) member stacks of distinct members."""
    sur_dtype, jc, _ = savtpu_run
    tc = _cfg(TConfig, tmp_path, 2, sur_dtype)
    js = JStore(jc.workdir, jc.model_dir, jc.surrogate.run_tag())
    ts = _store(tc)
    import_savtpu_run(jc.workdir, jc.model_dir, 2, ts, read_h5=_read_h5,
                      stages=(1, 2))
    model_training.run(tc, verbose=False, device="cpu")
    for r in range(2):
        jm = json.loads(js.model_file(r).with_suffix(".json").read_text())
        tm = json.loads(ts.model_file(r).with_suffix(".json").read_text())
        assert set(tm) == set(jm)
        for k, v in jm.items():
            if not k.startswith("final_"):
                assert tm[k] == v, k
        p = load_params(ts.model_file(r))
        assert p["fc.W"].shape[0] == 2
        assert np.abs(p["fc.W"][0] - p["fc.W"][1]).max() > 1e-6
