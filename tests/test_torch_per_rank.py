"""The port's per-rank surrogate training with mixed teacher forcing and
dropout (``StackedSeq2Seq.train_decode``, models/training.py ``fit``),
stage 3's per-rank branch and stage 4's per-rank fallback loop, against
savtpu's on the CPU.

The packages draw their coins and dropout masks from different
generators, so the parity tests pass savtpu's draws (``jax.random``, in
the test) into the port, per epoch and per batch, with savtpu's shuffles;
a statistical test checks the port's own draws. Tolerances, float64:
- ``train_decode`` with savtpu's draws: 1e-12 (the op order is
  savtpu's);
- ``fit`` from savtpu's initial parameters, its shuffles and draws, over
  a few epochs of several batches with a ragged tail and batched
  validation: 1e-12 for parameters and history (Adam in optax's
  formulas, tests/test_torch_lstm.py);
- stages 4-5 from savtpu's per-rank artifacts through the fallback loop:
  warm-up rows 1e-10, comm-free rows 1e-9 with a float64 surrogate and
  5e-6 with the float32 one (the limits of
  tests/test_torch_lstm_pipeline.py).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from savtpu.config import Config as JConfig
from savtpu.config import SurrogateConfig as JSur
from savtpu.io.artifacts import ArtifactStore as JStore
from savtpu.io.artifacts import load_displacement as j_load
from savtpu.models.lstm import init_seq2seq, seq2seq_train_decode
from savtpu.models.training import fit as j_fit
from savtpu.pipeline import run_all as j_run_all

from savtpu_torch.config import Config as TConfig
from savtpu_torch.config import SurrogateConfig as TSur
from savtpu_torch.convert import import_savtpu_run, lstm_arrays_from_savtpu
from savtpu_torch.io.artifacts import ArtifactStore as TStore
from savtpu_torch.io.artifacts import load_displacement as t_load
from savtpu_torch.models.lstm import StackedSeq2Seq
from savtpu_torch.models.training import fit, rank_epochs
from savtpu_torch.pipeline import model_training, online_predictor, plotter

torch.set_num_threads(1)

EXACT = 1e-12
WARM = 1e-10
LIMITS = {"float64": 1e-9, "float32": 5e-6}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _init(D, H, L, bi, inc, seed=3):
    tree = init_seq2seq(jax.random.PRNGKey(seed), D, H, L, bi,
                        dtype=jnp.float64, increment=inc)
    return jax.tree.map(np.asarray, tree)


def savtpu_draws(key, B, n_past, H2, L, n_future, p_enc, p_dec):
    """The coins and keep masks ``seq2seq_train_decode`` draws from
    ``key``, in the port's layout (one model)."""
    kenc, kdec, ktf = jax.random.split(key, 3)
    d = {"coins": np.asarray(jax.random.uniform(ktf, (n_future,)))[None]}
    if p_enc > 0 and L > 1:
        enc, k = [], kenc
        for _ in range(L - 1):
            k, sub = jax.random.split(k)
            enc.append(np.asarray(jax.random.bernoulli(
                sub, 1.0 - p_enc, (n_past, B, H2))))
        d["enc"] = np.stack(enc)[:, :, None]
    if p_dec > 0:
        d["dec"] = np.stack([np.asarray(jax.random.bernoulli(
            dk, 1.0 - p_dec, (B, H2)))
            for dk in jax.random.split(kdec, n_future)])[:, None]
    return d


@pytest.mark.parametrize("tf,p_enc,p_dec,inc,L,bi", [
    (0.0, 0.0, 0.0, False, 2, True),
    (1.0, 0.0, 0.0, False, 2, True),
    (0.6, 0.3, 0.2, False, 2, True),
    (0.6, 0.3, 0.2, True, 3, False),
    (0.4, 0.5, 0.0, False, 1, True),
])
def test_train_decode_matches_savtpu(tf, p_enc, p_dec, inc, L, bi):
    rng = np.random.default_rng(0)
    B, n_p, n_f, D, H = 6, 5, 4, 3, 7
    tree = _init(D, H, L, bi, inc)
    x = rng.uniform(-1, 0, (B, n_p, D))
    y = rng.uniform(-1, 0, (B, n_f, D))
    key = jax.random.PRNGKey(11)
    want = np.asarray(seq2seq_train_decode(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(y),
        n_f, key, tf_ratio=tf, dropout_encoder=p_enc,
        dropout_decoder=p_dec))
    H2 = H * (2 if bi else 1)
    d = savtpu_draws(key, B, n_p, H2, L, n_f, p_enc, p_dec)
    model = StackedSeq2Seq.from_arrays(
        {k: v[None] for k, v in lstm_arrays_from_savtpu(tree).items()},
        dtype=torch.float64)
    t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float64))
    with torch.no_grad():
        got = model.train_decode(
            t(x[None]), t(y[None]), n_f, torch.tensor(tf, dtype=torch.float64),
            t(d["coins"]), t(d.get("enc")), t(d.get("dec")), p_enc, p_dec)
    assert _rel(got[0].numpy(), want) <= EXACT
    if tf == 1.0 and p_enc == p_dec == 0:
        # full teacher forcing differs from the free-running decode
        with torch.no_grad():
            free = model.predict(t(x[None]), n_f)
        assert _rel(free[0].numpy(), want) > 1e-6


def _fit_data(G=23, n_p=4, n_f=3, D=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 0, (G, n_p, D))
    Y = rng.uniform(-1, 0, (G, n_f, D))
    return X[:17], Y[:17], X[17:], Y[17:]


@pytest.mark.parametrize("method,tf,p", [
    ("recursive", 0.0, 0.0), ("mtf", 1.0, 0.0), ("mtf", 0.6, 0.0),
    ("mtf", 0.6, 0.25),
])
def test_fit_matches_savtpu(method, tf, p):
    """savtpu's per-rank fit and the port's from savtpu's initial
    parameters, shuffles, coins and masks: 17 training windows in
    batches of 5 (three full, a ragged tail of 2), 6 validation windows
    in batches of 5, 4 epochs."""
    Xtr, Ytr, Xva, Yva = _fit_data()
    H, L = 5, 2
    kw = dict(n_past=4, n_future=3, hidden_size=H, num_layers_encoder=L,
              batch_size=5, num_epochs=4, learning_rate=5e-3,
              dtype="float64", seed=2, training_method=method, tf_ratio=tf,
              dropout_encoder=p, dropout_decoder=p)
    jc, tc = JSur(**kw), TSur(**kw)
    init = _init(3, H, L, True, False, seed=5)
    j_params, j_hist = j_fit(jc, Xtr, Ytr, Xva, Yva,
                             params=jax.tree.map(jnp.asarray, init),
                             log_every=0)
    base_key = jax.random.PRNGKey(jc.seed + 9)
    stochastic = method == "mtf" or p > 0

    def draws(e):
        kperm, kdrop = jax.random.split(jax.random.fold_in(base_key, e))
        out = {"perm": np.asarray(jax.random.permutation(kperm, 17))[None]}
        if stochastic:
            per = [[], [], []]
            key = kdrop
            for B in (5, 5, 5, 2):
                key, sub = jax.random.split(key)
                d = savtpu_draws(sub, B, 4, 2 * H, L, 3, p, p)
                for i, name in enumerate(("coins", "enc", "dec")):
                    per[i].append(d.get(name))
            out.update(coins=per[0], enc=per[1], dec=per[2])
        return out

    model, hist = fit(tc, Xtr, Ytr, Xva, Yva, device="cpu", log_every=0,
                      init_params=lstm_arrays_from_savtpu(init),
                      draws=draws)
    want = lstm_arrays_from_savtpu(jax.tree.map(np.asarray, j_params))
    got = {k: v[0] for k, v in model.arrays().items()}
    for k in want:
        assert _rel(got[k], want[k]) <= EXACT, k
    assert set(hist) == set(j_hist)
    for k in j_hist:
        assert len(hist[k]) == 4
        assert _rel(hist[k], j_hist[k]) <= EXACT, k
    assert _rel(got["fc.W"], lstm_arrays_from_savtpu(init)["fc.W"]) > 1e-3


def test_port_draws_statistics():
    """The port's own draws: keep rates 1 - p and coin frequencies
    within 4 sigma; the ratio decays 0.005 a batch across epochs; the
    same seed repeats them."""
    Xtr, Ytr, Xva, Yva = _fit_data(G=60)
    cfg = TSur(n_past=4, n_future=3, hidden_size=8, batch_size=7,
               num_epochs=6, dtype="float64", training_method="mtf",
               tf_ratio=0.6, dropout_encoder=0.3, dropout_decoder=0.1)
    ep = rank_epochs(cfg, Xtr, Ytr, Xva, Yva, device="cpu")
    ep.load_chunk(0)
    sums = {"enc": [0.0, 0], "dec": [0.0, 0], "coins": [0.0, 0]}
    first = None
    for e in range(6):
        ep.load_epoch(e)
        if first is None:
            first = [b["dec"].clone() for b in ep.draw_bufs]
        for buf in ep.draw_bufs:
            for name, t in buf.items():
                v = (t < 0.6).double() if name == "coins" else t
                sums[name][0] += float(v.sum())
                sums[name][1] += v.numel()
        ep.epoch()
    for name, p in (("enc", 0.7), ("dec", 0.9), ("coins", 0.6)):
        s, n = sums[name]
        assert abs(s / n - p) <= 4 * np.sqrt(p * (1 - p) / n), (name, s / n)
    n_batches = len(ep.batch_sizes())
    assert n_batches == 3  # 17 windows, batches of 7, 7 and 3
    assert float(ep.ratio) == pytest.approx(max(0.6 - 0.005 * 6 * n_batches,
                                                0.0), abs=1e-12)
    ep2 = rank_epochs(cfg, Xtr, Ytr, Xva, Yva, device="cpu")
    ep2.load_chunk(0)
    ep2.load_epoch(0)
    for a, b in zip(first, ep2.draw_bufs):
        assert torch.equal(a, b["dec"])


# ---- the pipeline: per-rank models through stages 3, 4 and 5 ----

CASES = {"mtf_f64": ("float64", 0), "mtf_f32": ("float32", 0),
         "mtf_modal_f64": ("float64", 3)}


def _cfg(C, root, sur_dtype, modal):
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
    s.dtype = sur_dtype
    s.stacked = False
    s.training_method = "mtf"
    s.dropout_encoder = s.dropout_decoder = 0.1
    s.modal_dim = modal
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
    root = tmp_path_factory.mktemp(f"per_rank_{request.param}")
    jc = _cfg(JConfig, root / "savtpu", *CASES[request.param])
    metrics = j_run_all.run(jc, verbose=False)
    return request.param, jc, metrics


def test_stage4_and_5_from_savtpu_models(savtpu_run, tmp_path):
    """savtpu's per-rank (unpadded) models through the port's fallback
    loop."""
    case, jc, j_metrics = savtpu_run
    sur_dtype, modal = CASES[case]
    tc = _cfg(TConfig, tmp_path, sur_dtype, modal)
    js, ts = _stores(jc, tc)
    import_savtpu_run(jc.workdir, jc.model_dir, 2, ts, read_h5=_read_h5,
                      read_params=_read_msgpack)
    online_predictor.run(tc, verbose=False, device="cpu")
    t_metrics = plotter.run(tc, verbose=False)
    ev = [json.loads(ln) for ln in
          (ts.workdir / "metrics.jsonl").read_text().splitlines()]
    assert ev[-2]["event"] == "stage4_online"
    assert ev[-2]["stacked_predictor"] is False
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
    """The port's per-rank stage 3 on savtpu's traces: savtpu's sidecar
    keys and values (scaling, modal basis), unpadded one-model arrays,
    the training curves; then its stage 4 runs the fallback loop."""
    case, jc, _ = savtpu_run
    tc = _cfg(TConfig, tmp_path, *CASES[case])
    js, ts = _stores(jc, tc)
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
        params = dict(np.load(ts.model_file(r)))
        assert params["decoder.Wi"].shape == (jm["input_size"],
                                              8 * jm["hidden_size"])
        got = np.loadtxt(ts.model_run_dir(r) / "test_acc_r2.csv",
                         delimiter=",")
        assert got.shape == (jc.surrogate.epochs,) and np.isfinite(got).all()
    online_predictor.run(tc, verbose=False, device="cpu")
    for r in range(2):
        a = t_load(ts.modeled_h5(r))
        assert a.shape[1] == jc.solver.num_steps and np.isfinite(a).all()
