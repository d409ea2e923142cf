"""Surrogate training (port of ``savtpu/models/training.py``: the losses,
``chained_predict`` and ``fit_stacked`` for ``arch="lstm"``).

The loop is the reference's (Model_training.py:65-139, DNN_tools.py:
103-207): MSE over the recursive n_future decode, Adam with
lr = lr0 * decay^epoch, shuffled mini-batches, per-epoch training and
validation metrics (loss, R^2, relative accuracy). ``fit_stacked`` trains
P independent surrogates at once on windows padded to a common width,
with the loss and metrics taken over each shard's real feature dims.

Adam is elementwise, so one Adam over the stacked (P, ...) parameters is
exactly P independent optimizers, and the summed per-shard losses give
each shard's model its own gradient. :class:`StackedAdam` follows
optax.adam's formulas and defaults (b1 0.9, b2 0.999, eps 1e-8, bias
correction computed in float64), with the step count and the learning
rate as tensors on the device. It is written here, not taken from
torch.optim, because torch's capturable Adam runs only on CUDA: this one
is the same operations on the CPU and in a CUDA graph.

On a CUDA device each epoch (its full batches, forward, backward and
Adam step each, and the validation pass) is captured once into a CUDA
graph and replayed for every epoch; the epoch reads its shuffle and
learning rate from device buffers indexed by an epoch counter the graph
advances itself, so a replay needs no host work. On the CPU the same
epoch function runs eagerly; it is also the reference the replayed graph
is held to on the card.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..utils import full_precision_products, resolve_device
from .lstm import StackedSeq2Seq

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def mse(a, b):
    return torch.mean((a - b) ** 2)


def batch_metrics(out, truth):
    """(loss, r2, rel) of one batch (DNN_tools.py:146-157)."""
    loss = mse(out, truth)
    r2 = 1.0 - loss / mse(truth, torch.mean(truth))
    rel = 1.0 - loss / torch.mean(truth ** 2)
    return loss, r2, rel


def chained_predict(model, X, n_future, n_windows, feat_mask=None):
    """Decode ``n_windows`` chained windows of ``n_future`` steps from X
    (P, B, n_past, D): after the first window the encoder reads the
    model's own previous predictions (the online regime, where the
    history after warm-up is model feedback). Returns
    (P, B, n_windows*n_future, D)."""
    n_past = X.shape[2]
    outs = []
    x = X
    for _ in range(n_windows):
        out = model.predict(x, n_future, feat_mask)
        outs.append(out)
        x = torch.cat([x, out], dim=2)[:, :, -n_past:]
    return outs[0] if n_windows == 1 else torch.cat(outs, dim=2)


def masked_mse(out, truth, feat_mask):
    """Per-shard MSE over the real (unmasked) feature dims: out, truth
    (P, B, T, D), feat_mask (P, D) -> (P,). Equals each shard's unpadded
    MSE."""
    diff = (out - truth) * feat_mask[:, None, None, :]
    denom = out.shape[1] * out.shape[2] * feat_mask.sum(-1)
    return (diff * diff).sum((1, 2, 3)) / denom


def masked_metrics(out, truth, feat_mask):
    """Per-shard (loss, r2, rel), each (P,), on the real feature dims
    (batch_metrics under padding)."""
    fm = feat_mask[:, None, None, :]
    loss = masked_mse(out, truth, feat_mask)
    denom = out.shape[1] * out.shape[2] * feat_mask.sum(-1)
    tmean = (truth * fm).sum((1, 2, 3)) / denom
    var = (((truth - tmean[:, None, None, None]) * fm) ** 2).sum(
        (1, 2, 3)) / denom
    ms = ((truth * fm) ** 2).sum((1, 2, 3)) / denom
    return loss, 1.0 - loss / var, 1.0 - loss / ms


class StackedAdam:
    """optax.adam over a list of tensors: mu = (1-b1) g + b1 mu, nu =
    (1-b2) g^2 + b2 nu, p += -lr * mu_hat / (sqrt(nu_hat) + eps) with
    mu_hat = mu / (1 - b1^t), nu_hat = nu / (1 - b2^t)."""

    def __init__(self, params):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        p0 = self.params[0]
        self.count = torch.zeros((), dtype=torch.float64, device=p0.device)

    @torch.no_grad()
    def step(self, grads, neg_lr):
        """One update with the gradients ``grads`` and the learning rate
        -``neg_lr`` (a 0-dim tensor of the parameters' dtype)."""
        dtype = self.params[0].dtype
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - ADAM_B1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - ADAM_B2)
        torch._foreach_mul_(self.nu, ADAM_B2)
        torch._foreach_add_(self.nu, g2)
        self.count += 1
        bc1 = (1 - torch.pow(ADAM_B1, self.count)).to(dtype)
        bc2 = (1 - torch.pow(ADAM_B2, self.count)).to(dtype)
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(self.params, upd)

    def tensors(self):
        return self.mu + self.nu + [self.count]


class _Epochs:
    """The training state on the device and one epoch as a function of
    it: a shuffle and learning rate read from ``perm_buf``/``lr_buf`` at
    the chunk position ``j``, the epoch's metrics written into ``hist`` at
    the epoch counter ``e``, both counters advanced at its end."""

    def __init__(self, cfg, model, Xtr, Ytr, Xva, Yva, fm, *, bs, steps,
                 n_future, n_windows, n_epochs, chunk, noise):
        self.cfg, self.model, self.fm = cfg, model, fm
        self.n_epochs, self.chunk = n_epochs, chunk
        self.Xtr, self.Ytr, self.Xva, self.Yva = Xtr, Ytr, Xva, Yva
        self.bs, self.steps = bs, steps
        self.n_future, self.n_windows = n_future, n_windows
        self.params = list(model.parameters())
        self.adam = StackedAdam(self.params)
        P, n_train = Xtr.shape[:2]
        dev, dtype = Xtr.device, Xtr.dtype
        self.perm_buf = torch.zeros((chunk, P, n_train), dtype=torch.long,
                                    device=dev)
        self.lr_buf = torch.zeros((chunk,), dtype=dtype, device=dev)
        self.noise = noise
        self.noise_buf = (torch.zeros((P, steps * bs) + Xtr.shape[2:],
                                      dtype=dtype, device=dev)
                          if noise > 0.0 else None)
        self.j = torch.zeros((1,), dtype=torch.long, device=dev)
        self.e = torch.zeros((1,), dtype=torch.long, device=dev)
        self.hist = torch.zeros((n_epochs, 2, P, 3), dtype=dtype,
                                device=dev)

    def load_chunk(self, e0: int) -> int:
        """Draw the shuffles and learning rates of epochs e0.. (at most
        one chunk) into the device buffers and rewind ``j``. Returns how
        many epochs the chunk holds. The shuffles come from one torch
        generator seeded cfg.seed + 2, drawn epoch by epoch, shard by
        shard, so the chunking never changes them."""
        cfg = self.cfg
        if e0 == 0:
            self._perm_gen = torch.Generator().manual_seed(cfg.seed + 2)
            self._noise_gen = torch.Generator().manual_seed(cfg.seed + 3)
        n = min(self.chunk, self.n_epochs - e0)
        P, n_train = self.perm_buf.shape[1:]
        perms = torch.stack([
            torch.stack([torch.randperm(n_train, generator=self._perm_gen)
                         for _ in range(P)]) for _ in range(n)])
        lrs = torch.tensor(
            [-(cfg.learning_rate * cfg.decay ** e)
             for e in range(e0, e0 + n)], dtype=torch.float64)
        self.perm_buf[:n].copy_(perms)
        self.lr_buf[:n].copy_(lrs.to(self.lr_buf.dtype))
        self.j.zero_()
        return n

    def load_noise(self) -> None:
        """The next epoch's input noise (cfg.input_noise > 0 only)."""
        if self.noise_buf is not None:
            self.noise_buf.copy_(torch.randn(
                self.noise_buf.shape, generator=self._noise_gen,
                dtype=torch.float64).to(self.noise_buf.dtype))

    def state(self):
        return ([p.data for p in self.params] + self.adam.tensors()
                + [self.j, self.e, self.hist])

    def epoch(self):
        m, fm, bs, T = self.model, self.fm, self.bs, self.steps
        P = self.Xtr.shape[0]
        perm = self.perm_buf.index_select(0, self.j)[0][:, : T * bs]
        neg_lr = self.lr_buf.index_select(0, self.j)[0]

        def shuffled(A):
            idx = perm[:, :, None, None].expand(-1, -1, *A.shape[2:])
            return torch.gather(A, 1, idx)

        Xs, Ys = shuffled(self.Xtr), shuffled(self.Ytr)
        if self.noise_buf is not None:
            # noise-injected training: robustifies the online block
            # recursion against its own feedback error
            Xs = Xs + self.noise * self.noise_buf * fm[:, None, None, :]
        Xs = Xs.view(P, T, bs, *Xs.shape[2:])
        Ys = Ys.view(P, T, bs, *Ys.shape[2:])
        stats = []
        for k in range(T):
            out = chained_predict(m, Xs[:, k], self.n_future,
                                  self.n_windows, fm)
            loss = masked_mse(out, Ys[:, k], fm)
            grads = torch.autograd.grad(loss.sum(), self.params)
            self.adam.step(grads, neg_lr)
            with torch.no_grad():
                stats.append(torch.stack(
                    masked_metrics(out, Ys[:, k], fm), dim=-1))
        with torch.no_grad():
            tl = torch.stack(stats).mean(0)
            out = chained_predict(m, self.Xva, self.n_future,
                                  self.n_windows, fm)
            vl = torch.stack(masked_metrics(out, self.Yva, fm), dim=-1)
            self.hist.index_copy_(0, self.e, torch.stack([tl, vl])[None])
            self.j += 1
            self.e += 1


def capture_epoch(ep: "_Epochs") -> torch.cuda.CUDAGraph:
    """One epoch captured into a CUDA graph. An eager epoch on a side
    stream first sets up autograd's and cuBLAS's state for the capture;
    the training state is restored after it, so the graph's first replay
    is the first epoch."""
    dev = ep.Xtr.device
    saved = [t.clone() for t in ep.state()]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        ep.epoch()
    torch.cuda.current_stream(dev).wait_stream(stream)
    with torch.no_grad():
        for t, s in zip(ep.state(), saved):
            t.copy_(s)
    graph = torch.cuda.CUDAGraph()
    # no collection during the capture: destroying any CUDA graph then
    # would invalidate it
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            ep.epoch()
    finally:
        if gc_was_on:
            gc.enable()
    return graph


def fit_stacked(
    cfg,
    X,            # (P, G, n_past, Dmax) padded with zeros
    Y,            # (P, G, n_future * rollout_windows, Dmax)
    feat_mask,    # (P, Dmax) 1 on real feature dims
    *,
    device=None,
    log_every: int = 50,
    log_fn=print,
    replay: Optional[bool] = None,
    stats: Optional[Dict] = None,
    init_params: Optional[Dict[str, np.ndarray]] = None,
):
    """Train P independent LSTM surrogates at once. Returns (model,
    hist): the :class:`StackedSeq2Seq` on ``device`` (CUDA unless the
    caller asks for the CPU) and hist arrays of shape (epochs, P) under
    the JAX package's keys (train_/val_ loss, r2, rel).

    The per-shard train/validation split is the JAX package's NumPy one
    (``default_rng(seed + 1)``), bit for bit. The per-epoch shuffles and
    the input noise come from torch generators seeded ``seed + 2`` and
    ``seed + 3``; they cannot reproduce ``jax.random``'s bits, so the two
    packages train on the same batches only where a batch is the whole
    training set. The initial parameters come from a torch generator
    seeded ``seed``; ``init_params`` (stacked arrays under the port's
    names, e.g. converted from savtpu) replaces them.

    ``replay`` (default: on a CUDA device) runs the epochs as replays of
    one captured CUDA graph; False runs them eagerly. ``stats``, if
    given, receives the capture and training seconds and the counts of
    epochs and Adam steps."""
    ep = stacked_epochs(cfg, X, Y, feat_mask, device=device,
                        init_params=init_params)
    model, E, steps = ep.model, ep.n_epochs, ep.steps
    replay = ep.Xtr.device.type == "cuda" if replay is None else bool(replay)
    if replay and ep.Xtr.device.type != "cuda":
        raise ValueError("replay=True needs a CUDA device")

    t0 = time.perf_counter()
    graph = capture_epoch(ep) if replay else None
    t1 = time.perf_counter()
    for e0 in range(0, E, ep.chunk):
        n = ep.load_chunk(e0)
        for _ in range(n):
            ep.load_noise()
            if graph is not None:
                graph.replay()
            else:
                ep.epoch()
        if log_every and E > ep.chunk:
            log_fn(f"  [fit_stacked] {e0 + n}/{E} epochs")
    hist_arr = ep.hist.cpu().numpy()  # (E, 2, P, 3); waits for the device
    t2 = time.perf_counter()
    if stats is not None:
        stats.update(capture_s=t1 - t0, train_s=t2 - t1, epochs=E,
                     adam_steps=E * steps, replay=replay)
    hist = {}
    for j, k in enumerate(("loss", "r2", "rel")):
        hist[f"train_{k}"] = hist_arr[:, 0, :, j]
        hist[f"val_{k}"] = hist_arr[:, 1, :, j]
    if log_every:
        for e in range(0, E, log_every):
            log_fn(f"epoch {e}: train mse {hist['train_loss'][e]} | val mse "
                   f"{hist['val_loss'][e]}")
    return model, hist


def stacked_epochs(cfg, X, Y, feat_mask, *, device=None,
                   init_params: Optional[Dict[str, np.ndarray]] = None):
    """The training state of :func:`fit_stacked` on the device, ready to
    run epochs (:class:`_Epochs`): the split windows, the model, Adam and
    the shuffle and learning-rate buffers."""
    if getattr(cfg, "arch", "lstm") != "lstm":
        raise NotImplementedError(
            f"fit_stacked trains arch='lstm'; arch {cfg.arch!r} is not "
            "ported yet")
    if (cfg.training_method != "recursive" or cfg.dropout_encoder > 0
            or cfg.dropout_decoder > 0):
        raise NotImplementedError(
            "mixed teacher forcing and dropout (seq2seq_train_decode) are "
            "not ported yet")
    full_precision_products()
    dev = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    fm_np = np.asarray(feat_mask, dtype=np.float64)
    Pn, G, _, Dmax = X.shape
    # full batches only; clamp bs so tiny window counts still give one
    n_train = max(int(cfg.train_portion * G), 1)
    bs = min(cfg.batch_size, n_train)
    n_train -= n_train % bs
    steps = max(n_train // bs, 1)
    n_future = cfg.n_future
    n_windows = int(getattr(cfg, "rollout_windows", 1) or 1)
    if Y.shape[2] != n_windows * n_future:
        raise ValueError(
            f"targets have {Y.shape[2]} steps; expected rollout_windows * "
            f"n_future = {n_windows * n_future}")

    # fixed per-shard train/val split (random unordered, like the
    # reference), the JAX package's NumPy draws
    rng = np.random.default_rng(cfg.seed + 1)
    train_idx = np.stack(
        [rng.choice(G, size=n_train, replace=False) for _ in range(Pn)])
    val_idx = np.stack([np.setdiff1d(np.arange(G), t) for t in train_idx])
    take = lambda A, idx: torch.as_tensor(  # noqa: E731
        np.take_along_axis(A, idx[:, :, None, None], 1), dtype=dtype).to(dev)
    Xtr, Ytr = take(X, train_idx), take(Y, train_idx)
    Xva, Yva = take(X, val_idx), take(Y, val_idx)
    fm = torch.as_tensor(fm_np, dtype=dtype).to(dev)

    model = StackedSeq2Seq(
        Pn, Dmax, cfg.hidden_size, cfg.num_layers_encoder,
        cfg.bidirectional,
        increment=getattr(cfg, "target_mode", "absolute") == "increment",
        dtype=dtype, generator=torch.Generator().manual_seed(cfg.seed))
    if init_params is not None:
        model.load_arrays(init_params)
    model = model.to(dev)

    E = int(cfg.epochs)
    chunk = max(1, min(int(getattr(cfg, "epoch_chunk", 0) or 250), E))
    noise = float(getattr(cfg, "input_noise", 0.0) or 0.0)
    return _Epochs(cfg, model, Xtr, Ytr, Xva, Yva, fm, bs=bs, steps=steps,
                   n_future=n_future, n_windows=n_windows, n_epochs=E,
                   chunk=chunk, noise=noise)
