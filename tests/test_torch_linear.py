"""The port's linear (ridge) surrogate (savtpu_torch/models/linear.py,
the linear branches of models/training.py and of stages 3 and 4) against
savtpu's, on the CPU; mirrors tests/test_linear.py.

Tolerances:
- the fit (``fit_linear_arrays``, ``stabilize_spectrum``,
  ``closed_loop_rel``, the ridge ladder): the port's copy is the same
  NumPy code, so on the same windows it picks the same lambda and W, b
  agree at 1e-10 (measured: bit for bit);
- ``linear_predict`` in float64: 1e-12 (one product's sum order);
- the pipeline (the small configuration of tests/test_linear.py: 6x1x1
  beam, 2 parts, n_p = n_f = 4, n_s = 5, cut_off 0.5): the port's stage 3
  on savtpu's stage-2 traces picks savtpu's lambda per rank and its W, b
  at 1e-10; stages 4-5 from savtpu's artifacts: warm-up rows 1e-10, the
  comm-free rows 1e-9 with a float64 surrogate and 5e-6 with the float32
  one (the limits of tests/test_torch_lstm_pipeline.py).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from savtpu.config import Config as JConfig
from savtpu.config import SurrogateConfig as JSur
from savtpu.io.artifacts import ArtifactStore as JStore
from savtpu.io.artifacts import load_displacement as j_load
from savtpu.models import linear as j_linear
from savtpu.models.training import fit_stacked as j_fit_stacked
from savtpu.pipeline import run_all as j_run_all

from savtpu_torch.config import Config as TConfig
from savtpu_torch.config import SurrogateConfig as TSur
from savtpu_torch.convert import import_savtpu_run
from savtpu_torch.io.artifacts import ArtifactStore as TStore
from savtpu_torch.io.artifacts import load_displacement as t_load
from savtpu_torch.io.artifacts import load_params
from savtpu_torch.models import linear as t_linear
from savtpu_torch.models.training import chained_predict, fit, fit_stacked
from savtpu_torch.pipeline import model_training, online_predictor, plotter

torch.set_num_threads(1)

FIT = 1e-10
EXACT = 1e-12
WARM = 1e-10
LIMITS = {"float64": 1e-9, "float32": 5e-6}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _lin_data(G, n_past, n_future, D, rng, noise=0.0):
    """Windows generated by a fixed affine map."""
    W = rng.normal(size=(n_past * D, n_future * D)) / (n_past * D)
    b = rng.normal(size=(n_future * D,))
    X = rng.normal(size=(G, n_past, D))
    Y = (X.reshape(G, -1) @ W + b).reshape(G, n_future, D)
    if noise:
        Y = Y + noise * rng.normal(size=Y.shape)
    return X, Y


def test_ridge_exact_recovery_matches_savtpu():
    rng = np.random.default_rng(0)
    X, Y = _lin_data(200, 5, 4, 3, rng)
    W, b = t_linear.fit_linear_arrays(X, Y, 1e-12)
    jW, jb = j_linear.fit_linear_arrays(X, Y, 1e-12)
    assert _rel(W, jW) <= FIT and _rel(b, jb) <= FIT
    pred = (X.reshape(200, -1) @ W + b).reshape(Y.shape)
    assert np.allclose(pred, Y, atol=1e-8)


@pytest.mark.parametrize("masked", [False, True])
def test_linear_predict_matches_savtpu(masked):
    """StackedLinear.predict on P = 2 maps against savtpu's
    linear_predict per map, float64; padded dims come out zero."""
    rng = np.random.default_rng(1)
    P, B, n_p, n_f, D = 2, 7, 5, 4, 3
    W = rng.normal(size=(P, n_p * D, n_f * D))
    b = rng.normal(size=(P, n_f * D))
    x = rng.normal(size=(P, B, n_p, D))
    fm = np.ones((P, D))
    if masked:
        fm[0, 2:] = 0.0
    model = t_linear.StackedLinear.from_arrays({"lin.W": W, "lin.b": b},
                                               n_p, dtype=torch.float64)
    got = model.predict(torch.as_tensor(x), n_f,
                        torch.as_tensor(fm) if masked else None)
    got = got.detach().numpy()
    for p in range(P):
        want = np.asarray(j_linear.linear_predict(
            {"lin": {"W": jnp.asarray(W[p]), "b": jnp.asarray(b[p])}},
            jnp.asarray(x[p]), n_f,
            feat_mask=jnp.asarray(fm[p]) if masked else None))
        assert _rel(got[p], want) <= EXACT
    if masked:
        assert (got[0, ..., 2:] == 0).all()


def test_fit_dispatch_and_predict_contract():
    """fit() with arch="linear" is the ridge solve (savtpu's numbers),
    and the returned module goes through chained_predict unchanged."""
    rng = np.random.default_rng(1)
    kw = dict(n_past=5, n_future=4, arch="linear", ridge_lambda=1e-10,
              dtype="float64")
    X, Y = _lin_data(100, 5, 4, 3, rng)
    model, hist = fit(TSur(**kw), X[:80], Y[:80], X[80:], Y[80:],
                      device="cpu", log_every=0)
    from savtpu.models.training import fit as j_fit

    j_params, j_hist = j_fit(JSur(**kw), X[:80], Y[:80], X[80:], Y[80:])
    assert hist["val_r2"][0] > 0.999999
    for k in ("train_loss", "val_loss", "val_r2"):
        assert hist[k][0] == pytest.approx(j_hist[k][0], rel=1e-10, abs=1e-20)
    arrays = model.arrays()
    assert _rel(arrays["lin.W"][0], j_params["lin"]["W"]) <= FIT
    with torch.no_grad():
        out = chained_predict(model, torch.as_tensor(X[None, 80:]), 4, 1)
        out2 = chained_predict(model, torch.as_tensor(X[None, :2]), 4, 2)
    assert np.allclose(out[0].numpy(), Y[80:], atol=1e-6)
    assert out2.shape == (1, 2, 8, 3)


def test_linear_feat_mask_zeroes_padding():
    rng = np.random.default_rng(2)
    X, Y = _lin_data(50, 5, 4, 3, rng)
    Xp = np.concatenate([X, np.full((50, 5, 2), 7.0)], axis=-1)
    Yp = np.concatenate([Y, np.zeros((50, 4, 2))], axis=-1)
    fm = np.array([1.0, 1.0, 1.0, 0.0, 0.0])
    kw = dict(n_past=5, n_future=4, arch="linear", ridge_lambda=1e-10)
    params, _ = t_linear.fit_linear(TSur(**kw), Xp[:40], Yp[:40],
                                    feat_mask=fm)
    j_params, _ = j_linear.fit_linear(JSur(**kw), Xp[:40], Yp[:40],
                                      feat_mask=fm)
    assert np.array_equal(params["lin.W"], np.asarray(j_params["lin"]["W"]))
    model = t_linear.StackedLinear.from_arrays(
        {k: v[None] for k, v in params.items()}, 5)
    out = model.predict(torch.as_tensor(Xp[None, 40:], dtype=torch.float32),
                        4, torch.as_tensor(fm[None], dtype=torch.float32))
    out = out.detach().numpy()[0]
    assert np.allclose(out[..., 3:], 0.0)
    assert np.allclose(out[..., :3], Y[40:], atol=1e-3)


def test_stabilize_spectrum_matches_savtpu():
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.normal(size=(10, 10)))
    th = 0.3
    R = np.eye(10)
    R[:2, :2] = 1.06 * np.array([[np.cos(th), -np.sin(th)],
                                 [np.sin(th), np.cos(th)]])
    R[2:, 2:] *= 0.8
    W = Q @ R @ Q.T
    W2, rho = t_linear.stabilize_spectrum(W, 0.999)
    jW2, jrho = j_linear.stabilize_spectrum(W, 0.999)
    assert rho == jrho == pytest.approx(1.06, rel=1e-9)
    assert _rel(W2, jW2) <= FIT
    mags = np.sort(np.abs(np.linalg.eigvals(W2)))
    assert mags[-1] <= 0.999 + 1e-9
    assert np.allclose(mags[:-2], 0.8, atol=1e-9)
    W3, _ = t_linear.stabilize_spectrum(W2, 0.999)
    assert np.allclose(W3, W2)


def test_closed_loop_rel_matches_savtpu():
    D, n = 2, 3
    rng = np.random.default_rng(7)
    A = 0.9 * np.linalg.qr(rng.normal(size=(n * D, n * D)))[0]
    b = rng.normal(size=n * D) * 0.01
    seq = [rng.normal(size=n * D)]
    for _ in range(20):
        seq.append(seq[-1] @ A + b)
    seq = np.concatenate([s.reshape(n, D) for s in seq])
    long = np.tile(seq, (40, 1))[:400]
    for W_, s_, kw in ((A, seq, {"noise_rel": 0.0}), (A, seq, {}),
                       (3.0 * A, long, {}), (0.5 * A, seq, {})):
        got = t_linear.closed_loop_rel(W_, b, s_, n, n, **kw)
        want = j_linear.closed_loop_rel(W_, b, s_, n, n, **kw)
        assert got == want or (np.isinf(got) and np.isinf(want))
    assert t_linear.closed_loop_rel(A, b, seq, n, n, noise_rel=0.0) < 1e-5
    assert t_linear.closed_loop_rel(3.0 * A, b, long, n, n) > 1e10


def test_ladder_picks_savtpu_lambda():
    """The ladder on a damped oscillation with a tiny rank-deficient
    direction: the port picks savtpu's lambda, and the same W, b."""

    class C:
        ridge_lambda = 1e-6
        linear_rho_max = 0.0
        dtype = "float64"

    rng = np.random.default_rng(3)
    D, n = 3, 4
    t = np.arange(400)
    base = np.stack([np.exp(-0.002 * t) * np.sin(0.07 * t * (k + 1))
                     for k in range(D)], axis=1)
    seq = base + 1e-8 * rng.normal(size=base.shape)
    rows = seq[: (len(seq) // (2 * n)) * 2 * n].reshape(-1, 2 * n, D)
    X, Y = rows[:, :n], rows[:, n:]
    params, hist = t_linear.fit_linear(C(), X, Y, seqs=[seq])
    j_params, j_hist = j_linear.fit_linear(C(), X, Y, seqs=[seq])
    assert hist["ridge_lambda"] == j_hist["ridge_lambda"]
    assert hist["ridge_lambda"] in (1e-6, 1e-4, 1e-2, 1e-1, 1.0)
    assert _rel(params["lin.W"], j_params["lin"]["W"]) <= FIT
    assert _rel(params["lin.b"], j_params["lin"]["b"]) <= FIT
    assert np.isfinite(t_linear.closed_loop_rel(
        params["lin.W"], params["lin.b"], seq, n, n))


def test_fit_stacked_linear_matches_savtpu():
    rng = np.random.default_rng(3)
    P, G, n_p, n_f, D = 3, 60, 5, 4, 4
    Xs, Ys = zip(*[_lin_data(G, n_p, n_f, D, rng, noise=1e-6)
                   for _ in range(P)])
    X, Y = np.stack(Xs), np.stack(Ys)
    fm = np.ones((P, D))
    fm[1, 3] = 0.0
    kw = dict(n_past=n_p, n_future=n_f, arch="linear", ridge_lambda=1e-10,
              dtype="float64")
    model, hist = fit_stacked(TSur(**kw), X, Y, fm, device="cpu",
                              log_fn=lambda s: None)
    j_params, j_hist = j_fit_stacked(JSur(**kw), X, Y, fm,
                                     log_fn=lambda s: None)
    arrays = model.arrays()
    assert arrays["lin.W"].shape == (P, n_p * D, n_f * D)
    assert _rel(arrays["lin.W"], j_params["lin"]["W"]) <= FIT
    assert _rel(arrays["lin.b"], j_params["lin"]["b"]) <= FIT
    assert set(hist) == set(j_hist)
    for k in hist:
        assert hist[k].shape == (1, P)
        assert _rel(hist[k], j_hist[k]) <= FIT, k
    assert (hist["val_r2"][0, [0, 2]] > 0.9999).all()  # rank 1 is masked


# ---- the pipeline ----

CASES = {"stacked_f32": (True, "float32"), "per_rank_f64": (False, "float64"),
         "stacked_modal_f64": ("modal", "float64")}


def _cfg(C, root, stacked, sur_dtype):
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
    s.cut_off = 0.5
    s.arch = "linear"
    s.dtype = sur_dtype
    s.stacked = bool(stacked)
    if stacked == "modal":
        s.modal_dim = 3
    return cfg


def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return np.array(f["Displacement"])


def _read_msgpack(path, meta):
    from flax import serialization

    return serialization.msgpack_restore(path.read_bytes())


@pytest.fixture(scope="module", params=list(CASES))
def savtpu_run(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"linear_{request.param}")
    jc = _cfg(JConfig, root / "savtpu", *CASES[request.param])
    metrics = j_run_all.run(jc, verbose=False)
    return request.param, jc, metrics


def _stores(jc, tc):
    return (JStore(jc.workdir, jc.model_dir, jc.surrogate.run_tag()),
            TStore(tc.workdir, tc.model_dir, tc.surrogate.run_tag()))


def test_stage3_on_savtpu_traces(savtpu_run, tmp_path):
    """The port's stage 3 on savtpu's stage-1/2 traces: each rank's
    ladder picks savtpu's lambda, W and b agree, and the sidecar is
    savtpu's."""
    case, jc, _ = savtpu_run
    tc = _cfg(TConfig, tmp_path, *CASES[case])
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, 2, ts, read_h5=_read_h5,
                      stages=(1, 2))
    model_training.run(tc, verbose=False, device="cpu")
    t_rec = [json.loads(ln) for ln in
             (ts.workdir / "metrics.jsonl").read_text().splitlines()]
    j_rec = [json.loads(ln) for ln in
             (js.workdir / "metrics.jsonl").read_text().splitlines()]
    for r in range(2):
        jm = json.loads(js.model_file(r).with_suffix(".json").read_text())
        tm = json.loads(ts.model_file(r).with_suffix(".json").read_text())
        assert set(tm) == set(jm)
        for k, v in jm.items():
            if k.startswith("final_"):
                assert tm[k] == pytest.approx(v, rel=1e-10), k
            else:
                assert tm[k] == v, k
        got = load_params(ts.model_file(r))
        want = _read_msgpack(js.model_file(r).with_suffix(".msgpack"), jm)
        assert set(got) == {"lin.W", "lin.b"}
        assert got["lin.W"].dtype == np.dtype(tc.surrogate.dtype)
        for k in ("W", "b"):
            assert _rel(got[f"lin.{k}"], want["lin"][k]) <= FIT, (r, k)
    if CASES[case][0] is False:
        # the port's own events follow savtpu's (the run log was copied)
        lam = [e["ridge_lambda"] for e in t_rec[len(j_rec):]
               if e["event"] == "stage3_train_rank"]
        assert len(lam) == 2 and set(lam) <= {1e-6, 1e-4, 1e-2, 1e-1, 1.0}


def test_stage4_and_5_from_savtpu_models(savtpu_run, tmp_path):
    case, jc, j_metrics = savtpu_run
    stacked, sur_dtype = CASES[case]
    tc = _cfg(TConfig, tmp_path, stacked, sur_dtype)
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, 2, ts, read_h5=_read_h5,
                      read_params=_read_msgpack)
    online_predictor.run(tc, verbose=False, device="cpu")
    t_metrics = plotter.run(tc, verbose=False)
    ev = [json.loads(ln) for ln in
          (ts.workdir / "metrics.jsonl").read_text().splitlines()]
    s4 = [e for e in ev if e["event"] == "stage4_online"][-1]
    assert s4["stacked_predictor"] is (stacked is not False)
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
