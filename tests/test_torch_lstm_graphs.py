"""Stage 3's training loop on the card: ``fit_stacked`` replaying one
captured CUDA graph per epoch (savtpu_torch/models/training.py) against
the same epochs run eagerly, and the LSTM's predict on the card against
the CPU. On the CPU the epochs run eagerly; the CPU tests here hold that
path's own properties (the parity with savtpu is
tests/test_torch_lstm.py). The ``gpu`` legs skip where no CUDA device is
present. The module imports neither JAX nor savtpu, so on the card it
runs as ``python -m pytest --noconftest -m gpu
tests/test_torch_lstm_graphs.py``.
"""

import numpy as np
import pytest
import torch

from savtpu_torch.config import SurrogateConfig as TSur
from savtpu_torch.models.lstm import StackedSeq2Seq
from savtpu_torch.models.training import fit_stacked

torch.set_num_threads(1)


def _fit_inputs(G=24, n_p=4, n_f=3, Dmax=5, seed=0):
    rng = np.random.default_rng(seed)
    fm = np.ones((2, Dmax))
    fm[0, 3:] = 0.0   # shard 0 is 3 wide, shard 1 is 5 wide
    X = rng.uniform(-1, 0, size=(2, G, n_p, Dmax)) * fm[:, None, None, :]
    Y = rng.uniform(-1, 0, size=(2, G, n_f, Dmax)) * fm[:, None, None, :]
    return X, Y, fm


def test_fit_stacked_shuffled_batches_train():
    """Several batches an epoch (the shuffled path, which the packages
    draw differently): the loss falls, the history has savtpu's shape,
    and the same seed repeats bit for bit."""
    X, Y, fm = _fit_inputs()
    cfg = TSur(hidden_size=6, n_past=4, n_future=3, batch_size=4,
               num_epochs=8, learning_rate=1e-2, dtype="float64",
               epoch_chunk=3, input_noise=0.01)
    m1, h1 = fit_stacked(cfg, X, Y, fm, device="cpu", log_every=0)
    m2, h2 = fit_stacked(cfg, X, Y, fm, device="cpu", log_every=0)
    assert h1["train_loss"].shape == (8, 2)
    assert (h1["train_loss"][-1] < h1["train_loss"][0]).all()
    for k in h1:
        np.testing.assert_array_equal(h1[k], h2[k])
    for a, b in zip(m1.arrays().values(), m2.arrays().values()):
        np.testing.assert_array_equal(a, b)



def test_replay_needs_a_card():
    X, Y, fm = _fit_inputs()
    cfg = TSur(n_past=4, n_future=3, num_epochs=1, dtype="float64")
    with pytest.raises(ValueError):
        fit_stacked(cfg, X, Y, fm, device="cpu", replay=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: graph replay runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_cuda_predict_matches_cpu(dtype, tol):
    dev = _card()
    model = StackedSeq2Seq(2, 12, 50, dtype=dtype)
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 0, size=(2, 150, 20, 12)), dtype=dtype)
    with torch.no_grad():
        ref = model.predict(x, 20)
        got = model.to(dev).predict(x.to(dev), 20).cpu()
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_replayed_epochs_equal_eager_epochs(dtype):
    """Shuffled batches, noise, two chunks of epochs: the graph replays
    give the eager epochs' bits, and agree with the CPU."""
    dev = _card()
    X, Y, fm = _fit_inputs()
    cfg = TSur(hidden_size=6, n_past=4, n_future=3, batch_size=4,
               num_epochs=5, epoch_chunk=3, input_noise=0.01, dtype=dtype)
    a, ha = fit_stacked(cfg, X, Y, fm, device=dev, log_every=0,
                        replay=True)
    b, hb = fit_stacked(cfg, X, Y, fm, device=dev, log_every=0,
                        replay=False)
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k])
    for u, v in zip(a.arrays().values(), b.arrays().values()):
        np.testing.assert_array_equal(u, v)
    if dtype == "float64":
        c, hc = fit_stacked(cfg, X, Y, fm, device="cpu", log_every=0)
        for u, v in zip(a.arrays().values(), c.arrays().values()):
            assert np.abs(u - v).max() <= 1e-10 * np.abs(v).max()
