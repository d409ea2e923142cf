"""The port's LSTM surrogate (savtpu_torch/models/lstm.py, predictor.py,
training.py, data.py) against savtpu's, on the CPU, from the same
numpy-seeded inputs and savtpu's own initial parameters carried across
(savtpu_torch.convert.lstm_arrays_from_savtpu).

Tolerances, float64 (max |a - b| over max |b|):
- ``predict`` and the phase-interleaved predictor: 1e-12. The packages
  differ only in the order of a few additions (the port adds both biases
  to the batched input projection; savtpu adds them after the recurrent
  product), which moves the result at 1e-16.
- ``fit_stacked`` after 5 epochs: 1e-12 for the parameters and the
  history. The Adam update follows optax's operations one for one; what
  remains is the bias corrections' and the learning rate's pow (XLA's
  and libm's may differ in the last bit) and the product sums, measured
  at 1e-15. Each epoch is one batch (batch_size >= n_train), so the
  per-epoch shuffle, which the packages draw from different generators,
  only reorders the batch's windows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from savtpu.config import SurrogateConfig as JSur
from savtpu.models import data as j_data
from savtpu.models.lstm import init_seq2seq, seq2seq_predict
from savtpu.models.predictor import phase_interleaved_predict_stacked as j_pips
from savtpu.models.training import chained_predict as j_chained
from savtpu.models.training import fit_stacked as j_fit_stacked
from savtpu.models.training import masked_metrics as j_masked_metrics

from savtpu_torch.config import SurrogateConfig as TSur
from savtpu_torch.convert import lstm_arrays_from_savtpu, lstm_tree_from_arrays
from savtpu_torch.models import data as t_data
from savtpu_torch.models.lstm import StackedSeq2Seq
from savtpu_torch.models.predictor import (
    phase_interleaved_predict,
    phase_interleaved_predict_stacked,
)
from savtpu_torch.models.training import (
    chained_predict,
    fit_stacked,
    masked_metrics,
)

torch.set_num_threads(1)

EXACT = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _savtpu_stack(P, D, H, L, bi, inc, seed=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), P)
    return jax.vmap(lambda k: init_seq2seq(
        k, D, H, L, bi, dtype=jnp.float64, increment=inc))(keys)


def _port(tree):
    arrays = lstm_arrays_from_savtpu(jax.tree.map(np.asarray, tree))
    return StackedSeq2Seq.from_arrays(arrays, dtype=torch.float64)


def _one(tree, p):
    return jax.tree.map(lambda a: a[p], tree)


@pytest.mark.parametrize("L,bi,inc,windows", [
    (1, False, False, 1), (1, True, False, 1), (2, True, False, 1),
    (2, False, True, 1), (2, True, True, 2), (1, True, False, 3),
])
def test_predict_matches_savtpu(L, bi, inc, windows):
    P, D, H, n_p, n_f = 2, 5, 6, 4, 3
    tree = _savtpu_stack(P, D, H, L, bi, inc)
    model = _port(tree)
    rng = np.random.default_rng(L + 2 * bi + 4 * inc + windows)
    x = rng.uniform(-1.0, 0.0, size=(P, 7, n_p, D))
    fm = np.ones((P, D))
    fm[1, 3:] = 0.0   # ragged widths: shard 1 has 3 real dims
    x *= fm[:, None, None, :]
    out = chained_predict(model, torch.as_tensor(x), n_f, windows,
                          torch.as_tensor(fm)).detach().numpy()
    for p in range(P):
        ref = np.asarray(j_chained(_one(tree, p), jnp.asarray(x[p]), n_f,
                                   windows, feat_mask=jnp.asarray(fm[p])))
        assert out[p].shape == ref.shape == (7, windows * n_f, D)
        assert _rel(out[p], ref) <= EXACT, p
        assert not out[p][..., fm[p] == 0].any()
    # without a mask, one model (P = 1)
    one = StackedSeq2Seq.from_arrays(
        {k: v[:1] for k, v in model.arrays().items()},
        dtype=torch.float64)
    ref = np.asarray(seq2seq_predict(_one(tree, 0), jnp.asarray(x[0]), n_f))
    got = one.predict(torch.as_tensor(x[:1]), n_f)[0].detach().numpy()
    assert _rel(got, ref) <= EXACT


def test_encoder_matches_torch_nn_lstm():
    """The stacked encoder against nn.LSTM with copied weights (an
    oracle independent of savtpu): final states, both directions."""
    P, D, H, L = 2, 4, 5, 2
    tree = _savtpu_stack(P, D, H, L, True, False)
    model = _port(tree)
    x = np.random.default_rng(0).normal(size=(P, 3, 6, D))
    hn, cn = model.encode(torch.as_tensor(x))
    for p in range(P):
        ref = torch.nn.LSTM(D, H, num_layers=L, bidirectional=True,
                            batch_first=True).double()
        with torch.no_grad():
            for l in range(L):
                for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
                    c = getattr(model.encoder[l], d)
                    getattr(ref, f"weight_ih_l{l}{sfx}").copy_(c.Wi[p].T)
                    getattr(ref, f"weight_hh_l{l}{sfx}").copy_(c.Wh[p].T)
                    getattr(ref, f"bias_ih_l{l}{sfx}").copy_(c.bi[p])
                    getattr(ref, f"bias_hh_l{l}{sfx}").copy_(c.bh[p])
            _, (h, c) = ref(torch.as_tensor(x[p]))
        want_h = torch.cat([h[-2], h[-1]], dim=-1).numpy()
        want_c = torch.cat([c[-2], c[-1]], dim=-1).numpy()
        assert _rel(hn[p].detach().numpy(), want_h) <= EXACT
        assert _rel(cn[p].detach().numpy(), want_c) <= EXACT


def test_arrays_round_trip_and_init_ranges():
    """Port names <-> savtpu's pytree, both ways; the module's own
    initialization draws U(-1/sqrt(H), 1/sqrt(H)) per cell and
    U(-1/sqrt(2H), 1/sqrt(2H)) for the head, from its generator."""
    tree = jax.tree.map(np.asarray, _savtpu_stack(2, 3, 4, 2, True, True))
    arrays = lstm_arrays_from_savtpu(tree)
    back = lstm_tree_from_arrays(arrays)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    H = 7
    m1 = StackedSeq2Seq(3, 5, H, generator=torch.Generator().manual_seed(1))
    m2 = StackedSeq2Seq(3, 5, H, generator=torch.Generator().manual_seed(1))
    for (k, v), v2 in zip(m1.arrays().items(), m2.arrays().values()):
        np.testing.assert_array_equal(v, v2)
        bound = (1 / np.sqrt(2 * H) if k.startswith(("decoder", "fc"))
                 else 1 / np.sqrt(H))
        assert np.abs(v).max() <= bound, k
        assert np.abs(v).max() > 0.8 * bound, k


def test_data_copy_is_bit_identical():
    rng = np.random.default_rng(5)
    trace = rng.normal(size=(301, 4))
    for a, b in zip(t_data.strided_windows(trace, 4, 3, 5, 0.5),
                    j_data.strided_windows(trace, 4, 3, 5, 0.5)):
        np.testing.assert_array_equal(a, b)
    X, Y = t_data.strided_windows(trace, 4, 3, 5, 1.0)
    for mode in ("joint", "per_feature"):
        for a, b in zip(t_data.scale_to_zero_one(X, Y, mode),
                        j_data.scale_to_zero_one(X, Y, mode)):
            np.testing.assert_array_equal(a, b)
    a = t_data.train_val_split(40, 0.75, np.random.default_rng(3))
    b = j_data.train_val_split(40, 0.75, np.random.default_rng(3))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_phase_interleaved_predictor_matches_savtpu():
    P, Dmax, H, n_p, n_f, n_s = 2, 6, 5, 3, 4, 5
    tree = _savtpu_stack(P, Dmax, H, 2, True, False, seed=4)
    model = _port(tree)
    rng = np.random.default_rng(2)
    fm = np.ones((P, Dmax))
    fm[0, 4:] = 0.0
    hist = rng.normal(size=(P, n_p * n_s, Dmax)) * fm[:, None, :]
    for smax, smin in ((np.array([1.0, 2.0]), np.array([-1.0, -0.5])),
                       (rng.uniform(1, 2, (P, Dmax)),
                        rng.uniform(-2, -1, (P, Dmax)))):
        ref = np.asarray(j_pips(tree, jnp.asarray(hist), jnp.asarray(smax),
                                jnp.asarray(smin), n_p, n_f, n_s,
                                feat_mask=jnp.asarray(fm)))
        t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
        with torch.no_grad():
            got = phase_interleaved_predict_stacked(
                model, t(hist), t(smax), t(smin), n_p, n_f, n_s,
                feat_mask=t(fm)).numpy()
        assert got.shape == ref.shape == (P, n_f * n_s, Dmax)
        assert _rel(got, ref) <= EXACT
        assert np.abs(got[0, :, 4:]).max() == 0.0
    # the one-model form, a scalar scale and no mask
    one = StackedSeq2Seq.from_arrays(
        {k: v[1:] for k, v in model.arrays().items()}, dtype=torch.float64)
    ref = np.asarray(j_pips(
        _savtpu_stack(P, Dmax, H, 2, True, False, seed=4), jnp.asarray(hist),
        jnp.asarray([1.0, 1.5]), jnp.asarray([0.0, -0.5]), n_p, n_f,
        n_s))[1]
    with torch.no_grad():
        got = phase_interleaved_predict(
            one, torch.as_tensor(hist[1]), 1.5, -0.5, n_p, n_f, n_s).numpy()
    assert _rel(got, ref) <= EXACT


def test_masked_metrics_match_savtpu():
    rng = np.random.default_rng(1)
    out, truth = rng.normal(size=(2, 2, 4, 3, 5))
    fm = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=float)
    got = [m.numpy() for m in masked_metrics(
        torch.as_tensor(out), torch.as_tensor(truth), torch.as_tensor(fm))]
    for p in range(2):
        ref = j_masked_metrics(jnp.asarray(out[p]), jnp.asarray(truth[p]),
                               jnp.asarray(fm[p]))
        for g, r in zip(got, ref):
            assert abs(g[p] - float(r)) <= EXACT * abs(float(r))


def _fit_inputs(G=14, n_p=4, n_f=3, Dmax=5, seed=0):
    rng = np.random.default_rng(seed)
    fm = np.ones((2, Dmax))
    fm[0, 3:] = 0.0   # shard 0 is 3 wide, shard 1 is 5 wide
    X = rng.uniform(-1, 0, size=(2, G, n_p, Dmax)) * fm[:, None, None, :]
    Y = rng.uniform(-1, 0, size=(2, G, n_f, Dmax)) * fm[:, None, None, :]
    return X, Y, fm


@pytest.mark.parametrize("increment", [False, True])
def test_fit_stacked_matches_savtpu(increment):
    X, Y, fm = _fit_inputs()
    kw = dict(hidden_size=6, n_past=4, n_future=3, batch_size=64,
              num_epochs=5, learning_rate=5e-3, decay=0.9, dtype="float64",
              seed=3, target_mode="increment" if increment else "absolute")
    jc, tc = JSur(**kw), TSur(**kw)
    j_params, j_hist = j_fit_stacked(jc, X, Y, fm, log_every=0)
    # savtpu's own initial parameters, as fit_stacked draws them
    init = _savtpu_stack(2, X.shape[-1], 6, 2, True, increment, seed=3)
    model, t_hist = fit_stacked(
        tc, X, Y, fm, device="cpu", log_every=0,
        init_params=lstm_arrays_from_savtpu(jax.tree.map(np.asarray, init)))
    want = lstm_arrays_from_savtpu(jax.tree.map(np.asarray, j_params))
    got = model.arrays()
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= EXACT, k
    assert set(t_hist) == set(j_hist)
    for k in j_hist:
        assert t_hist[k].shape == (5, 2)
        assert _rel(t_hist[k], j_hist[k]) <= EXACT, k
    # the training moved the parameters
    assert _rel(got["fc.W"], lstm_arrays_from_savtpu(
        jax.tree.map(np.asarray, init))["fc.W"]) > 1e-3


def test_fit_stacked_refuses_what_is_not_ported():
    """Mixed teacher forcing, dropout and the linear arch are ported. The
    stacked fit decodes recursively whatever the method and dropouts say,
    as savtpu's fit_stacked does (bit for bit the recursive fit); the
    linear arch fits ridge maps. Stage 4's resync blocks and checkpoints
    pass its check (their runs: tests/test_torch_resync.py and
    test_torch_checkpoint.py); a negative period is refused. What stays
    refused is what savtpu's trainers refuse (a stochastic decode over
    chained windows, targets of the wrong length)."""
    from savtpu_torch.models.linear import StackedLinear
    from savtpu_torch.models.training import fit
    from savtpu_torch.pipeline import online_predictor

    X, Y, fm = _fit_inputs()
    base = dict(n_past=4, n_future=3, num_epochs=2, hidden_size=5,
                dtype="float64")
    ref, h_ref = fit_stacked(TSur(**base), X, Y, fm, device="cpu",
                             log_every=0)
    for kw in ({"training_method": "mtf"}, {"dropout_encoder": 0.1}):
        m, h = fit_stacked(TSur(**base, **kw), X, Y, fm, device="cpu",
                           log_every=0)
        for a, b in zip(m.arrays().values(), ref.arrays().values()):
            np.testing.assert_array_equal(a, b)
    m, h = fit_stacked(TSur(**base, arch="linear"), X, Y, fm, device="cpu",
                       log_fn=lambda s: None)
    assert isinstance(m, StackedLinear) and h["val_loss"].shape == (1, 2)
    with pytest.raises(ValueError):
        fit(TSur(**base, training_method="mtf", rollout_windows=2),
            X[0], np.concatenate([Y[0], Y[0]], axis=1), device="cpu")
    with pytest.raises(ValueError):
        fit_stacked(TSur(**base), X, Y[:, :, :2], fm, device="cpu")
    for attr, val in (("resync_blocks", 2), ("ckpt_every", 100)):
        from savtpu_torch.config import Config

        c = Config()
        setattr(c.surrogate if attr == "resync_blocks" else c.solver, attr,
                val)
        online_predictor._check_supported(c)
        setattr(c.surrogate if attr == "resync_blocks" else c.solver, attr,
                -val)
        with pytest.raises(ValueError):
            online_predictor._check_supported(c)
