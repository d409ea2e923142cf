"""Surrogate training throughput of the port (counterpart of the JAX
package's ``benchmarks/train_bench.py``): the port's ``models.fit`` on the
device against a reference-style PyTorch loop (per-batch Python
dispatch) on the host CPU.

    python -m savtpu_torch.benchmarks.train_bench [--epochs 50] \\
        [--device cpu] [--out PATH]

Same architecture (2-layer bidirectional LSTM encoder H = 50, decoder 2H,
linear head), same data (``make_data``: 221 training windows of 20 -> 20
at D = 27), batch size 10, Adam 5e-4, seed 0. It runs on CUDA unless
``--device`` asks for another device, and raises when CUDA is asked for
and absent. It prints the JAX package's JSON keys; the ``savtpu_*`` keys
hold the port's ``fit`` (as the sweep keeps the JAX package's keys), and
``device_savtpu`` names the device it ran on. The JSON is written only to
``--out``; without it nothing is written.

Two fits of the same length: the first pays the one-time costs (on a card
the CUDA-graph capture of the epoch and the libraries' set-up;
``savtpu_seconds_incl_compile`` is its wall time), the second gives the
steady per-epoch time, its training seconds from ``fit``'s ``stats`` (the
replays, without the capture) over its epochs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..config import SurrogateConfig
from ..models.training import fit
from ..utils import resolve_device
from .sweep import device_info


def make_data(G=295, n_past=20, n_future=20, D=27, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 40, (G + n_past + n_future) * 2)
    base = np.stack(
        [np.sin(0.5 * t + 0.2 * d) + 0.1 * rng.normal(size=t.shape)
         for d in range(D)],
        axis=1,
    )
    idx = np.arange(G)
    X = base[idx[:, None] + np.arange(n_past)[None, :]]
    Y = base[idx[:, None] + n_past + np.arange(n_future)[None, :]]
    return X.astype(np.float32), Y.astype(np.float32)


def bench_port(X, Y, epochs, device):
    """Two fits of ``epochs`` epochs. Returns (the first fit's wall
    seconds, the second's final training loss, its steady seconds an
    epoch)."""

    def run(n):
        cfg = SurrogateConfig(
            hidden_size=50, n_past=20, n_future=20, batch_size=10,
            learning_rate=5e-4, num_epochs=n, seed=0,
        )
        n_train = int(0.75 * len(X))
        stats = {}
        t0 = time.perf_counter()
        _, hist = fit(cfg, X[:n_train], Y[:n_train], device=device,
                      log_every=0, stats=stats)
        return time.perf_counter() - t0, hist["train_loss"][-1], stats

    t_cold, _, _ = run(epochs)
    _, loss, stats = run(epochs)
    steady = stats["train_s"] / epochs
    return t_cold, loss, steady


def bench_torch(X, Y, epochs):
    import torch.nn as nn

    D, H = X.shape[-1], 50
    enc = nn.LSTM(D, H, num_layers=2, batch_first=True, bidirectional=True)
    dec = nn.LSTM(D, 2 * H, num_layers=1, batch_first=True)
    fc = nn.Linear(2 * H, D)
    params = (
        list(enc.parameters()) + list(dec.parameters()) + list(fc.parameters())
    )
    opt = torch.optim.Adam(params, lr=5e-4)
    crit = nn.MSELoss()
    n_train = int(0.75 * len(X))
    Xt = torch.tensor(X[:n_train])
    Yt = torch.tensor(Y[:n_train])
    n_future = Y.shape[1]
    bs = 10
    t0 = time.perf_counter()
    last = None
    B_total = Xt.shape[0]
    for ep in range(epochs):
        perm = torch.randperm(B_total)
        for s in range(0, B_total, bs):
            xb = Xt[perm[s : s + bs]]
            yb = Yt[perm[s : s + bs]]
            opt.zero_grad()
            _, (hn, cn) = enc(xb)
            h = torch.cat((hn.view(2, 2, len(xb), H)[-1][0],
                           hn.view(2, 2, len(xb), H)[-1][1]), 1).unsqueeze(0)
            c = torch.cat((cn.view(2, 2, len(xb), H)[-1][0],
                           cn.view(2, 2, len(xb), H)[-1][1]), 1).unsqueeze(0)
            xi = xb[:, -1, :]
            outs = []
            for _ in range(n_future):
                o, (h, c) = dec(xi.unsqueeze(1), (h, c))
                y = fc(o.squeeze(1))
                outs.append(y)
                xi = y
            out = torch.stack(outs, dim=1)
            loss = crit(out, yb)
            loss.backward()
            opt.step()
            last = float(loss.detach())
    return time.perf_counter() - t0, last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the port's fit (default: cuda, "
                         "which must exist)")
    ap.add_argument("--out", type=Path, default=None,
                    help="the JSON file to write (none written without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    X, Y = make_data()

    port_s, port_loss, port_steady = bench_port(X, Y, args.epochs, dev)
    torch_s, torch_loss = bench_torch(X, Y, args.epochs)

    torch_per_epoch = torch_s / args.epochs
    out = {
        "epochs": args.epochs,
        "device_savtpu": device_info(dev),
        "savtpu_seconds_incl_compile": port_s,
        "savtpu_steady_sec_per_epoch": port_steady,
        "savtpu_steady_epochs_per_sec": 1.0 / port_steady,
        "torch_cpu_sec_per_epoch": torch_per_epoch,
        "torch_cpu_epochs_per_sec": 1.0 / torch_per_epoch,
        "steady_speedup_vs_torch_cpu": torch_per_epoch / port_steady,
        "reference_3450_epochs_projection_s": {
            "savtpu": (port_steady * 3450
                       + (port_s - port_steady * args.epochs)),
            "torch_cpu": torch_per_epoch * 3450,
        },
        "final_losses": {"savtpu": port_loss, "torch": torch_loss},
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
