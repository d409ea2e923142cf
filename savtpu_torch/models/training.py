"""Surrogate training (port of ``savtpu/models/training.py``: the losses,
``chained_predict``, the per-rank ``fit`` and ``fit_stacked``; the
linear surrogate's closed-form fit is ``models/linear.py``).

The loop is the reference's (Model_training.py:65-139, DNN_tools.py:
103-207): MSE over the recursive n_future decode, Adam with
lr = lr0 * decay^epoch, shuffled mini-batches, per-epoch training and
validation metrics (loss, R^2, relative accuracy). ``fit_stacked`` trains
P independent surrogates at once on windows padded to a common width,
with the loss and metrics taken over each shard's real feature dims, on
full batches only, always by recursive decode (as the JAX package's).
``fit`` trains one rank's model on its own windows: full batches and a
ragged tail batch, validation in batches, and the reference's optional
knobs, mixed teacher forcing and dropout (``StackedSeq2Seq.train_decode``),
whose draws (coins and keep masks) come from a torch generator on the
host, or from the caller, into device buffers the epoch reads.

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
advances itself, and decays the teacher-forcing ratio, a device tensor,
itself; a replay needs at most a copy of the epoch's draws. On the CPU
the same epoch function runs eagerly; it is also the reference the
replayed graph is held to on the card.

``fit_stacked(..., mesh=)`` trains over a device mesh
(``parallel.make_device_mesh``): each rank trains its contiguous block of
the P models, which are independent, so no gradient crosses ranks. The
initial parameters, the split and the shuffle and noise streams are drawn
for all P models on every rank and then cut to the block, so each model
sees what it sees unsharded; the history is gathered across ranks.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import full_precision_products, resolve_device
from .linear import StackedLinear, fit_linear
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
    the epoch counter ``e``, both counters advanced at its end.

    An epoch runs ``steps`` full batches of ``bs`` and, where ``tail`` > 0,
    a last batch of ``tail`` windows (the per-rank fit); validation is
    one batch of every window (``val_bs`` None, the stacked fit) or
    batches of ``val_bs`` with a ragged tail, averaged. ``stochastic``
    decodes with :meth:`StackedSeq2Seq.train_decode` from the draws in
    ``draw_bufs`` (one dict per batch: coins, and the keep masks of
    whichever dropout is on) and decays ``ratio`` by 0.005 a batch."""

    def __init__(self, cfg, model, Xtr, Ytr, Xva, Yva, fm, *, bs, steps,
                 n_future, n_windows, n_epochs, chunk, noise, tail=0,
                 val_bs=None, stochastic=False, ratio0=0.0, draws=None,
                 block=None):
        self.cfg, self.model, self.fm = cfg, model, fm
        # under a mesh (p0, p1, P): the shuffles and the noise are drawn
        # for all P models and cut to models p0 .. p1 - 1
        self.block = block
        self.n_epochs, self.chunk = n_epochs, chunk
        self.Xtr, self.Ytr, self.Xva, self.Yva = Xtr, Ytr, Xva, Yva
        self.bs, self.steps, self.tail, self.val_bs = bs, steps, tail, val_bs
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
        self.stochastic, self.draws = stochastic, draws
        self.ratio = torch.full((), float(ratio0), dtype=dtype, device=dev)
        self.draw_bufs = []
        if stochastic:
            H2 = model.decoder.Wh.shape[1]
            L = len(model.encoder)
            n_past = Xtr.shape[2]
            for nb in self.batch_sizes():
                d = {"coins": torch.zeros((P, n_future), dtype=dtype,
                                          device=dev)}
                if cfg.dropout_encoder > 0 and L > 1:
                    d["enc"] = torch.zeros((L - 1, n_past, P, nb, H2),
                                           dtype=dtype, device=dev)
                if cfg.dropout_decoder > 0:
                    d["dec"] = torch.zeros((n_future, P, nb, H2),
                                           dtype=dtype, device=dev)
                self.draw_bufs.append(d)

    def batch_sizes(self):
        return [self.bs] * self.steps + ([self.tail] if self.tail else [])

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
        n_draw = P if self.block is None else self.block[2]
        perms = torch.stack([
            torch.stack([torch.randperm(n_train, generator=self._perm_gen)
                         for _ in range(n_draw)]) for _ in range(n)])
        if self.block is not None:
            perms = perms[:, self.block[0] : self.block[1]]
        lrs = torch.tensor(
            [-(cfg.learning_rate * cfg.decay ** e)
             for e in range(e0, e0 + n)], dtype=torch.float64)
        self.perm_buf[:n].copy_(perms)
        self.lr_buf[:n].copy_(lrs.to(self.lr_buf.dtype))
        self.j.zero_()
        self._e0 = e0
        return n

    def load_epoch(self, e: int) -> None:
        """Epoch e's host-drawn inputs: the input noise (cfg.input_noise >
        0) and, for a stochastic decode, the coins and keep masks, from
        the caller's ``draws(e)`` where given (which may also replace the
        epoch's shuffle with its "perm" (P, n_train)), else from torch
        generators seeded cfg.seed + 3 (keep = uniform < 1 - dropout)."""
        if self.noise_buf is not None:
            shape = tuple(self.noise_buf.shape)
            if self.block is not None:
                shape = (self.block[2],) + shape[1:]
            noise = torch.randn(shape, generator=self._noise_gen,
                                dtype=torch.float64)
            if self.block is not None:
                noise = noise[self.block[0] : self.block[1]]
            self.noise_buf.copy_(noise.to(self.noise_buf.dtype))
        given = self.draws(e) if self.draws is not None else None
        if given is not None and given.get("perm") is not None:
            self.perm_buf[e - self._e0].copy_(torch.as_tensor(
                np.asarray(given["perm"]), dtype=torch.long))
        if not self.stochastic:
            return
        cfg = self.cfg
        for k, buf in enumerate(self.draw_bufs):
            for name, t in buf.items():
                if given is not None:
                    src = torch.as_tensor(np.asarray(given[name][k]))
                elif name == "coins":
                    src = torch.rand(t.shape, generator=self._noise_gen,
                                     dtype=torch.float64)
                else:
                    p = (cfg.dropout_encoder if name == "enc"
                         else cfg.dropout_decoder)
                    src = torch.rand(t.shape, generator=self._noise_gen,
                                     dtype=torch.float64) < 1.0 - p
                t.copy_(src.reshape(t.shape).to(t.dtype))

    def state(self):
        return ([p.data for p in self.params] + self.adam.tensors()
                + [self.j, self.e, self.hist, self.ratio])

    def _forward(self, Xb, Yb, k):
        m, fm = self.model, self.fm
        if not self.stochastic:
            return chained_predict(m, Xb, self.n_future, self.n_windows, fm)
        d = self.draw_bufs[k]
        return m.train_decode(Xb, Yb, self.n_future, self.ratio,
                              d["coins"], d.get("enc"), d.get("dec"),
                              self.cfg.dropout_encoder,
                              self.cfg.dropout_decoder, fm)

    def _validate(self):
        m, fm = self.model, self.fm
        n_val = self.Xva.shape[1]
        P = self.Xva.shape[0]
        if n_val == 0:
            return self.Xva.new_zeros((P, 3))
        vb = self.val_bs or n_val
        tot = []
        for s in range(0, n_val, vb):
            out = chained_predict(m, self.Xva[:, s : s + vb], self.n_future,
                                  self.n_windows, fm)
            tot.append(torch.stack(
                masked_metrics(out, self.Yva[:, s : s + vb], fm), dim=-1))
        return torch.stack(tot).mean(0)

    def epoch(self):
        fm = self.fm
        sizes = self.batch_sizes()
        n_used = sum(sizes)
        perm = self.perm_buf.index_select(0, self.j)[0][:, :n_used]
        neg_lr = self.lr_buf.index_select(0, self.j)[0]

        def shuffled(A):
            idx = perm[:, :, None, None].expand(-1, -1, *A.shape[2:])
            return torch.gather(A, 1, idx)

        Xs, Ys = shuffled(self.Xtr), shuffled(self.Ytr)
        if self.noise_buf is not None:
            # noise-injected training: robustifies the online block
            # recursion against its own feedback error
            Xs = Xs + self.noise * self.noise_buf * fm[:, None, None, :]
        stats = []
        s0 = 0
        for k, nb in enumerate(sizes):
            Xb, Yb = Xs[:, s0 : s0 + nb], Ys[:, s0 : s0 + nb]
            s0 += nb
            out = self._forward(Xb, Yb, k)
            loss = masked_mse(out, Yb, fm)
            grads = torch.autograd.grad(loss.sum(), self.params)
            self.adam.step(grads, neg_lr)
            with torch.no_grad():
                if self.stochastic:
                    # the teacher-forcing ratio decays per batch
                    # (DNN_tools.py:160-162)
                    self.ratio.copy_(torch.clamp(self.ratio - 0.005,
                                                 min=0.0))
                stats.append(torch.stack(masked_metrics(out, Yb, fm),
                                         dim=-1))
        with torch.no_grad():
            tl = torch.stack(stats).mean(0)
            vl = self._validate()
            self.hist.index_copy_(0, self.e, torch.stack([tl, vl])[None])
            self.j += 1
            self.e += 1


def _train(ep: "_Epochs", replay, log_every, log_fn, stats, what):
    """Run ``ep``'s epochs, as replays of one captured CUDA graph or
    eagerly. Returns the (E, 2, P, 3) history as numpy."""
    E = ep.n_epochs
    replay = ep.Xtr.device.type == "cuda" if replay is None else bool(replay)
    if replay and ep.Xtr.device.type != "cuda":
        raise ValueError("replay=True needs a CUDA device")
    t0 = time.perf_counter()
    graph = capture_epoch(ep) if replay else None
    t1 = time.perf_counter()
    for e0 in range(0, E, ep.chunk):
        n = ep.load_chunk(e0)
        for i in range(n):
            ep.load_epoch(e0 + i)
            if graph is not None:
                graph.replay()
            else:
                ep.epoch()
        if log_every and E > ep.chunk:
            log_fn(f"  [{what}] {e0 + n}/{E} epochs")
    hist_arr = ep.hist.cpu().numpy()  # (E, 2, P, 3); waits for the device
    t2 = time.perf_counter()
    if stats is not None:
        stats.update(capture_s=t1 - t0, train_s=t2 - t1, epochs=E,
                     adam_steps=E * len(ep.batch_sizes()), replay=replay)
    return hist_arr


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


def _model_for(cfg, n_models, input_size, dtype, init_params, dev):
    model = StackedSeq2Seq(
        n_models, input_size, cfg.hidden_size, cfg.num_layers_encoder,
        cfg.bidirectional,
        increment=getattr(cfg, "target_mode", "absolute") == "increment",
        dtype=dtype, generator=torch.Generator().manual_seed(cfg.seed))
    if init_params is not None:
        model.load_arrays(init_params)
    return model.to(dev)


def _chunk(cfg, E):
    return max(1, min(int(getattr(cfg, "epoch_chunk", 0) or 250), E))


def _check_targets(cfg, n_steps):
    n_windows = int(getattr(cfg, "rollout_windows", 1) or 1)
    if n_steps != n_windows * cfg.n_future:
        raise ValueError(
            f"targets have {n_steps} steps; expected rollout_windows * "
            f"n_future = {n_windows * cfg.n_future}")
    return n_windows


def fit(
    cfg,
    X_train,      # (G_train, n_past, D) scaled windows of one rank
    Y_train,      # (G_train, n_future * rollout_windows, D)
    X_val=None,
    Y_val=None,
    *,
    device=None,
    log_every: int = 50,
    log_fn=print,
    replay: Optional[bool] = None,
    stats: Optional[Dict] = None,
    init_params: Optional[Dict[str, np.ndarray]] = None,
    draws: Optional[Callable[[int], Dict]] = None,
    seqs=None,
):
    """Train one rank's surrogate (the JAX package's per-rank ``fit``).
    Returns (model, hist): a one-model :class:`StackedSeq2Seq` (or
    :class:`~savtpu_torch.models.linear.StackedLinear` for
    ``arch="linear"``, fit in closed form by ``fit_linear`` with ``seqs``
    for its ridge ladder) on ``device``, and hist lists per epoch under
    the JAX package's keys (val_* empty without validation windows).

    Each epoch shuffles the training windows (a torch generator seeded
    ``seed + 2``), runs the full batches and the ragged tail batch, then
    validates in batches of the same size. With
    ``training_method="mtf"`` or dropout the decode is
    ``train_decode``: the teacher-forcing ratio starts at cfg.tf_ratio
    (mtf; else 0) and decays 0.005 a batch across the whole run, and the
    coins and keep masks come from a torch generator seeded ``seed + 3``,
    or from ``draws(epoch)`` — a dict of per-batch lists "coins" (1,
    n_future), "enc" (L-1, n_past, 1, B, D*H), "dec" (n_future, 1, B,
    D*H) and optionally "perm" (1, n_train) — so that a test can pass
    another package's draws in. ``init_params`` are one model's arrays
    (a per-rank ``model.npz``); by default a torch generator seeded
    ``seed`` draws them. On a CUDA device the epochs replay one captured
    CUDA graph (``replay``)."""
    full_precision_products()
    dev = resolve_device(device)
    n_future = cfg.n_future
    if getattr(cfg, "arch", "lstm") == "linear":
        if Y_train.shape[1] != n_future:
            raise ValueError(
                "arch='linear' fits one direct n_past->n_future map; set "
                "rollout_windows = 1")
        params, hist = fit_linear(
            cfg, np.asarray(X_train), np.asarray(Y_train),
            None if X_val is None else np.asarray(X_val),
            None if Y_val is None else np.asarray(Y_val), seqs=seqs)
        model = StackedLinear.from_arrays(
            {k: v[None] for k, v in params.items()}, X_train.shape[1],
            dtype=_DTYPES[cfg.dtype], device=dev)
        return model, hist
    ep = rank_epochs(cfg, X_train, Y_train, X_val, Y_val, device=dev,
                     init_params=init_params, draws=draws)
    E = ep.n_epochs
    has_val = ep.Xva.shape[1] > 0
    hist_arr = _train(ep, replay, log_every, log_fn, stats, "fit")
    hist = {}
    for j, k in enumerate(("loss", "r2", "rel")):
        hist[f"train_{k}"] = hist_arr[:, 0, 0, j].tolist()
        hist[f"val_{k}"] = hist_arr[:, 1, 0, j].tolist() if has_val else []
    if log_every:
        for e in range(0, E, log_every):
            msg = (f"epoch {e}: train mse {hist['train_loss'][e]:.5e} "
                   f"r2 {hist['train_r2'][e]:.4f}")
            if has_val:
                msg += (f" | val mse {hist['val_loss'][e]:.5e} "
                        f"r2 {hist['val_r2'][e]:.4f}")
            log_fn(msg)
    return ep.model, hist


def rank_epochs(cfg, X_train, Y_train, X_val=None, Y_val=None, *,
                device=None, init_params=None, draws=None):
    """The training state of :func:`fit` on the device, ready to run
    epochs (:class:`_Epochs` with one model)."""
    full_precision_products()
    dev = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    method = getattr(cfg, "training_method", "recursive")
    stochastic = (method == "mtf" or cfg.dropout_encoder > 0
                  or cfg.dropout_decoder > 0)
    n_windows = _check_targets(cfg, Y_train.shape[1])
    if n_windows > 1 and stochastic:
        raise ValueError(
            "rollout_windows > 1 requires the deterministic recursive "
            "training method (no mtf/dropout)")
    as_dev = lambda A: torch.as_tensor(  # noqa: E731
        np.asarray(A, np.float64)[None], dtype=dtype).to(dev)
    Xtr, Ytr = as_dev(X_train), as_dev(Y_train)
    D = Xtr.shape[-1]
    if X_val is not None and len(X_val) > 0:
        Xva, Yva = as_dev(X_val), as_dev(Y_val)
    else:
        Xva, Yva = Xtr[:, :0], Ytr[:, :0]
    n_train = Xtr.shape[1]
    bs = min(cfg.batch_size, n_train)
    steps, tail = divmod(n_train, bs)
    model = _model_for(cfg, 1, D, dtype, None if init_params is None else
                       {k: np.asarray(v)[None] for k, v in
                        init_params.items()}, dev)
    E = int(cfg.epochs)
    return _Epochs(cfg, model, Xtr, Ytr, Xva, Yva,
                   torch.ones((1, D), dtype=dtype, device=dev), bs=bs,
                   steps=steps, tail=tail, val_bs=bs, n_future=cfg.n_future,
                   n_windows=n_windows, n_epochs=E, chunk=_chunk(cfg, E),
                   noise=0.0, stochastic=stochastic,
                   ratio0=cfg.tf_ratio if method == "mtf" else 0.0,
                   draws=draws)


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
    seqs=None,
    mesh=None,
):
    """Train P independent surrogates at once. Returns (model, hist): the
    :class:`StackedSeq2Seq` on ``device`` (CUDA unless the caller asks for
    the CPU) and hist arrays of shape (epochs, P) under the JAX package's
    keys (train_/val_ loss, r2, rel). ``arch="linear"`` fits P ridge maps
    in closed form instead (:func:`_fit_stacked_linear`, ``seqs`` the
    per-rank sequences of its ladder) and returns a
    :class:`~savtpu_torch.models.linear.StackedLinear`.

    As in the JAX package, the stacked fit decodes recursively whatever
    ``training_method`` and the dropouts say (those act in the per-rank
    :func:`fit` only). A seed ensemble is P = ranks x members on this
    axis (stage 3 tiles the windows).

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
    epochs and Adam steps.

    ``mesh`` (a ``DeviceMesh`` over the ranks, every rank calling with
    the whole X, Y and feat_mask): the returned model holds this rank's
    contiguous block of the P models (P a multiple of the ranks) on its
    device, trained as in the unsharded fit, and the history covers all
    P, gathered across ranks. ``init_params`` holds all P models. With
    ``arch="linear"`` every rank fits all P maps on the host, as the JAX
    package's fit does whatever its mesh, and keeps its block."""
    if getattr(cfg, "arch", "lstm") == "linear":
        block = None
        if mesh is not None:
            device, block = _model_block(mesh, np.shape(X)[0])
        return _fit_stacked_linear(cfg, X, Y, feat_mask, device=device,
                                   log_fn=log_fn, seqs=seqs, block=block)
    ep = stacked_epochs(cfg, X, Y, feat_mask, device=device,
                        init_params=init_params, mesh=mesh)
    hist_arr = _train(ep, replay, log_every, log_fn, stats, "fit_stacked")
    if mesh is not None:
        hist_arr = _gather_models(hist_arr, mesh, ep.Xtr.device)
    hist = {}
    for j, k in enumerate(("loss", "r2", "rel")):
        hist[f"train_{k}"] = hist_arr[:, 0, :, j]
        hist[f"val_{k}"] = hist_arr[:, 1, :, j]
    if log_every:
        for e in range(0, ep.n_epochs, log_every):
            log_fn(f"epoch {e}: train mse {hist['train_loss'][e]} | val mse "
                   f"{hist['val_loss'][e]}")
    return ep.model, hist


def _fit_stacked_linear(cfg, X, Y, feat_mask, *, device=None, log_fn=print,
                        seqs=None, block=None):
    """P independent closed-form ridge fits on the host (each a
    (n_past*D)^2 normal-equation solve), stacked into one
    :class:`StackedLinear` on the device. Each rank's train/validation
    split is drawn in turn from ``default_rng(seed + 1)``, the JAX
    package's. History arrays are (1, P), with the chosen ridge lambdas
    under "ridge_lambda". ``block`` (p0, p1, P) keeps models p0 .. p1 - 1
    in the module; the history still covers all P."""
    if Y.shape[2] != cfg.n_future:
        raise ValueError(
            "arch='linear' fits one direct n_past->n_future map; set "
            "rollout_windows = 1")
    full_precision_products()
    dev = resolve_device(device)
    Pn, G = X.shape[0], X.shape[1]
    n_train = max(int(cfg.train_portion * G), 1)
    rng = np.random.default_rng(cfg.seed + 1)
    params_l, tl, vl, lams = [], [], [], []
    for r in range(Pn):
        tr = rng.choice(G, size=n_train, replace=False)
        va = np.setdiff1d(np.arange(G), tr)
        p_r, h_r = fit_linear(
            cfg, X[r][tr], Y[r][tr], X[r][va], Y[r][va],
            feat_mask=np.asarray(feat_mask[r]),
            seqs=None if seqs is None else seqs[r])
        lams.append(h_r.get("ridge_lambda", cfg.ridge_lambda))
        params_l.append(p_r)
        tl.append([h_r["train_loss"][0], h_r["train_r2"][0],
                   h_r["train_rel"][0]])
        vl.append([h_r["val_loss"][0], h_r["val_r2"][0], h_r["val_rel"][0]])
    p0, p1 = (0, Pn) if block is None else block[:2]
    model = StackedLinear.from_arrays(
        {k: np.stack([p[k] for p in params_l[p0:p1]]) for k in params_l[0]},
        X.shape[2], dtype=_DTYPES[cfg.dtype], device=dev)
    tl = np.asarray(tl)[None]  # (1, P, 3)
    vl = np.asarray(vl)[None]
    hist = {}
    for j, k in enumerate(("loss", "r2", "rel")):
        hist[f"train_{k}"] = tl[:, :, j]
        hist[f"val_{k}"] = vl[:, :, j]
    log_fn(f"ridge fit: train mse {tl[0, :, 0]} | val mse {vl[0, :, 0]}"
           + (f" | lambda {lams}" if seqs is not None else ""))
    hist["ridge_lambda"] = np.asarray(lams, np.float64)[None]  # (1, P)
    return model, hist


def _model_block(mesh, Pn: int):
    """(this rank's device, (p0, p1, Pn)): its contiguous block of the
    ``Pn`` models, ``Pn`` a multiple of the mesh's ranks."""
    from ..parallel.sharded import mesh_device

    n, r = mesh.size(), mesh.get_local_rank()
    if Pn % n:
        raise ValueError(
            f"mesh has {n} devices; the model count {Pn} must be a multiple")
    return mesh_device(mesh), (r * Pn // n, (r + 1) * Pn // n, Pn)


def _gather_models(hist_arr: np.ndarray, mesh, dev) -> np.ndarray:
    """The (E, 2, P_local, 3) history of every rank joined on its model
    axis."""
    group = mesh.get_group()
    t = torch.as_tensor(np.ascontiguousarray(hist_arr)).to(dev)
    out = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(out, t, group=group)
    return torch.cat(out, dim=2).cpu().numpy()


def stacked_epochs(cfg, X, Y, feat_mask, *, device=None,
                   init_params: Optional[Dict[str, np.ndarray]] = None,
                   mesh=None):
    """The training state of :func:`fit_stacked` on the device, ready to
    run epochs (:class:`_Epochs`): the split windows, the model, Adam and
    the shuffle and learning-rate buffers; under ``mesh`` those of the
    rank's block of models."""
    full_precision_products()
    dev = resolve_device(device)
    block = None
    if mesh is not None:
        dev, block = _model_block(mesh, np.shape(X)[0])
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
    n_windows = _check_targets(cfg, Y.shape[2])

    # fixed per-shard train/val split (random unordered, like the
    # reference), the JAX package's NumPy draws
    rng = np.random.default_rng(cfg.seed + 1)
    train_idx = np.stack(
        [rng.choice(G, size=n_train, replace=False) for _ in range(Pn)])
    val_idx = np.stack([np.setdiff1d(np.arange(G), t) for t in train_idx])
    if block is None:
        model = _model_for(cfg, Pn, Dmax, dtype, init_params, dev)
    else:
        # all P models' initial parameters, then the rank's block
        p0, p1 = block[:2]
        full = _model_for(cfg, Pn, Dmax, dtype, init_params, "cpu")
        model = StackedSeq2Seq.from_arrays(
            {k: v[p0:p1] for k, v in full.arrays().items()}, dtype=dtype,
            device=dev)
        X, Y, fm_np = X[p0:p1], Y[p0:p1], fm_np[p0:p1]
        train_idx, val_idx = train_idx[p0:p1], val_idx[p0:p1]
    take = lambda A, idx: torch.as_tensor(  # noqa: E731
        np.take_along_axis(A, idx[:, :, None, None], 1), dtype=dtype).to(dev)
    Xtr, Ytr = take(X, train_idx), take(Y, train_idx)
    Xva, Yva = take(X, val_idx), take(Y, val_idx)
    fm = torch.as_tensor(fm_np, dtype=dtype).to(dev)
    E = int(cfg.epochs)
    noise = float(getattr(cfg, "input_noise", 0.0) or 0.0)
    return _Epochs(cfg, model, Xtr, Ytr, Xva, Yva, fm, bs=bs, steps=steps,
                   n_future=cfg.n_future, n_windows=n_windows, n_epochs=E,
                   chunk=_chunk(cfg, E), noise=noise, block=block)
