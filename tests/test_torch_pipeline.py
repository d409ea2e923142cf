"""The port's five-stage pipeline against savtpu's, end to end, on the
small expfit configuration of tests/test_expfit.py (6x1x1 beam, 2 parts,
100 steps, n_p = n_f = 4, n_s = 5, modal_dim 3, float64), once in the
default dense mode and once banded and compensated (the slice's path).

Tolerances, float64:
- stage-1 and stage-2 traces, and the stage-4 warm-up rows: 1e-10 of the
  trace's max (the packages differ only in matvec sum order);
- expfit params fitted by the port from savtpu's stage-2 traces: 1e-10
  (the fit is the same NumPy code on the same input; on the port's own
  traces, which differ from savtpu's at 1e-15, the matrix pencil moves
  the params by ~1e-8, which is why the fit is held on shared input);
- stage-4 comm-free rows: 5e-6 of the trajectory's max. Both packages
  evaluate the expfit feed in float32 on the device, and XLA's and
  PyTorch's float32 exp/sin/cos/atan2 differ by an ulp or two (~2e-7
  relative), which moves the prescribed interface rows by as much.
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
from savtpu_torch.convert import import_savtpu_run
from savtpu_torch.io.artifacts import ArtifactStore as TStore
from savtpu_torch.io.artifacts import load_displacement as t_load
from savtpu_torch.pipeline import model_training, online_predictor
from savtpu_torch.pipeline import run_all as t_run_all

torch.set_num_threads(1)

N_PARTS = 2
EXACT = 1e-10
FEED = 5e-6


def _cfg(C, root, mode):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = N_PARTS
    cfg.solver.num_steps = 100
    if mode == "banded":
        cfg.solver.fint_mode = "banded"
        cfg.solver.compensated = True
    s = cfg.surrogate
    s.n_past = 4
    s.n_future = 4
    s.filter_size = 5
    s.cut_off = 0.5
    s.arch = "expfit"
    s.modal_dim = 3
    s.expfit_order = 8
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


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-300)


def _check_stage4(js, ts, n_warm):
    for r in range(N_PARTS):
        a, b = t_load(ts.modeled_h5(r)), j_load(js.modeled_h5(r))
        assert a.shape == b.shape and np.isfinite(a).all()
        assert _rel(a[:, :n_warm], b[:, :n_warm]) <= EXACT
        assert np.abs(a - b).max() <= FEED * np.abs(b).max()


@pytest.fixture(scope="module", params=["dense", "banded"])
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"pipeline_{request.param}")
    jc = _cfg(JConfig, root / "savtpu", request.param)
    tc = _cfg(TConfig, root / "port", request.param)
    j_metrics = j_run_all.run(jc, verbose=False)
    t_metrics = t_run_all.run(tc, verbose=False, device="cpu")
    return request.param, jc, tc, j_metrics, t_metrics


def test_stage1_and_stage2_traces(runs):
    _, jc, tc, _, _ = runs
    js, ts = _stores(jc, tc)
    for r in range(N_PARTS):
        for path in ("local_nodes_csv", "shared_csv", "elements_csv"):
            np.testing.assert_array_equal(
                ts.load_int_csv(getattr(ts, path)(r)),
                js.load_int_csv(getattr(js, path)(r)),
            )
        for f in ("dynamics_h5", "shared_dof_h5"):
            a, b = t_load(getattr(ts, f)(r)), j_load(getattr(js, f)(r))
            assert a.shape == b.shape
            assert _rel(a, b) <= EXACT, (f, r)


def test_stage4_and_metrics(runs):
    _, jc, tc, j_metrics, t_metrics = runs
    js, ts = _stores(jc, tc)
    _check_stage4(js, ts, jc.surrogate.i_cri + 1)
    assert set(t_metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        if "rel_l2" in k:
            assert t_metrics[k] == pytest.approx(v, rel=1e-3), k


def test_expfit_fit_on_savtpu_traces(runs, tmp_path):
    """Stage 3 of the port on savtpu's stage-1/2 artifacts reproduces
    savtpu's expfit params and sidecar."""
    mode, jc, _, _, _ = runs
    tc = _cfg(TConfig, tmp_path, mode)
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, stages=(1, 2))
    model_training.run(tc, verbose=False)
    for r in range(N_PARTS):
        jp = _read_msgpack(js.model_file(r), None)
        tp = dict(np.load(ts.model_file(r)))
        assert set(tp) == set(jp)
        for k in tp:
            assert _rel(tp[k], jp[k]) <= EXACT, (r, k)
        jm = json.loads(js.model_file(r).with_suffix(".json").read_text())
        tm = json.loads(ts.model_file(r).with_suffix(".json").read_text())
        assert set(tm) == set(jm)
        for k in ("arch", "input_size", "expfit_modes", "save_every",
                  "expfit_has_post_segment"):
            assert tm[k] == jm[k], k
        assert tm["expfit_ramp_end_row"] == pytest.approx(
            jm["expfit_ramp_end_row"], rel=1e-12)


def test_stage4_from_converted_savtpu_params(runs, tmp_path):
    """Stage 4 of the port from savtpu's stage 1-3 artifacts (params
    converted from flax msgpack) matches savtpu's stage 4."""
    mode, jc, _, _, _ = runs
    tc = _cfg(TConfig, tmp_path, mode)
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, N_PARTS, ts,
                      read_h5=_read_h5, read_params=_read_msgpack)
    online_predictor.run(tc, verbose=False, device="cpu")
    _check_stage4(js, ts, jc.surrogate.i_cri + 1)


def _two_segment_signal(T, ramp_end):
    """An exact expfit signal: in-ramp a + b t/ramp + modes, post-ramp
    c + the same poles (as in tests/test_expfit.py)."""
    t = np.arange(T, dtype=np.float64)
    z = np.array([0.9995 * np.exp(1j * 0.21), 0.9999 * np.exp(1j * 0.043)])
    y = np.empty(T)
    inA = t < ramp_end
    tA, tB = t[inA], t[~inA] - ramp_end
    y[inA] = (0.3 + 1.7 * tA / ramp_end + np.real(0.5 * z[0] ** tA)
              + np.real(0.2j * z[1] ** tA))
    y[~inA] = (2.0 + np.real((0.4 - 0.1j) * z[0] ** tB)
               + np.real(0.25 * z[1] ** tB))
    return y


@pytest.mark.parametrize("ramp,post", [(400.0, True), (1000.0, False)])
def test_expfit_fit_and_feed_match_savtpu(ramp, post):
    """The port's expfit fit gives savtpu's params on both branches: the
    two-segment fit past the load ramp (which the 9,000-step slice never
    reaches: its rows all lie inside the ramp) and the in-ramp fallback.
    The port's float32 device feed, advanced to a block origin, matches
    the host evaluation to savtpu's own bound (1e-4)."""
    from savtpu.models.expfit import fit_expfit as j_fit

    from savtpu_torch.models.expfit import (
        advance_expfit,
        eval_expfit,
        eval_expfit_device,
        fit_expfit,
    )

    ys = np.stack([_two_segment_signal(1200, ramp) * s
                   for s in (1.0, -0.3, 2.5)], axis=1)
    params, info = fit_expfit(ys[:900], ramp, order=6)
    j_params, j_info = j_fit(ys[:900], ramp, order=6)
    assert info == j_info and info["has_post_segment"] is post
    for k in j_params:
        np.testing.assert_array_equal(params[k], np.asarray(j_params[k]), k)
    se, block = 50.0, 3000
    for step0 in (0, int(380 * se), 45000):
        ref = eval_expfit(params, (step0 + np.arange(block)) / se, ramp)
        adv = advance_expfit(params, step0 / se, ramp)
        pack = {k: torch.as_tensor(np.asarray(v)[None], dtype=torch.float32)
                for k, v in adv.items()}
        z = [torch.as_tensor(params[k][None], dtype=torch.float32)
             for k in ("z_re", "z_im")]
        dev = eval_expfit_device(pack, *z, torch.tensor([se]), block)[0]
        err = np.abs(dev.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (step0, err)
