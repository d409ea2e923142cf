"""LSTM encoder-decoder surrogate (port of ``savtpu/models/lstm.py``).

The architecture is the reference surrogate's (Tools/DNN_tools.py:16-98):
a stacked (default 2-layer) bidirectional LSTM encoder whose last-layer
final (h, c) states, forward and backward concatenated, seed a one-layer
LSTM decoder of hidden size 2H with a Linear(2H -> input) head, decoded
recursively (each output fed back as the next input). Gate order and
initialization follow PyTorch's nn.LSTM (i, f, g, o; U(-1/sqrt(H),
1/sqrt(H)) for a cell of hidden size H, U(-1/sqrt(2H), 1/sqrt(2H)) for
the head), so nn.LSTM with copied weights is an independent oracle.

:class:`StackedSeq2Seq` holds P independent encoder-decoders at once:
every parameter carries a leading model axis, the counterpart of the JAX
package's ``jax.vmap`` over a stacked parameter pytree. The cells are
plain tensor ops (one batched product for a layer's input projection
over all T steps, then one ``baddbmm`` and the gate nonlinearities per
step), with both directions of a bidirectional layer stepped together,
so the number of launches does not grow with P. P = 1 is the single
model. ``nn.LSTM`` cannot hold P different weight sets.

Parameter names (the module's ``state_dict`` and the per-rank
``model.npz`` of stage 3, where the model axis is dropped):

    encoder.<l>.fwd.{Wi, Wh, bi, bh}    layer l's forward cell
    encoder.<l>.bwd.{Wi, Wh, bi, bh}    its backward cell (bidirectional)
    decoder.{Wi, Wh, bi, bh}            the decoder cell
    fc.{W, b}                           the head
    ginc                                1 with target_mode="increment"

with Wi (in, 4H), Wh (H, 4H), bi and bh (4H,), fc.W (2H, in), fc.b (in,),
ginc a scalar: the JAX package's pytree leaves, by the same names.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

CELL_KEYS = ("Wi", "Wh", "bi", "bh")


class _Cell(nn.Module):
    """One LSTM cell of P models: Wi (P, in, 4H), Wh (P, H, 4H), bi and
    bh (P, 4H)."""

    def __init__(self, P, input_size, hidden_size, dtype, gen):
        super().__init__()
        k = 1.0 / math.sqrt(hidden_size)
        for name, shape in (("Wi", (P, input_size, 4 * hidden_size)),
                            ("Wh", (P, hidden_size, 4 * hidden_size)),
                            ("bi", (P, 4 * hidden_size)),
                            ("bh", (P, 4 * hidden_size))):
            setattr(self, name, nn.Parameter(_uniform(shape, k, dtype, gen)))


class _Head(nn.Module):
    def __init__(self, P, hidden, out, dtype, gen):
        super().__init__()
        k = 1.0 / math.sqrt(hidden)
        self.W = nn.Parameter(_uniform((P, hidden, out), k, dtype, gen))
        self.b = nn.Parameter(_uniform((P, out), k, dtype, gen))


def _uniform(shape, k, dtype, gen):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return ((2.0 * u - 1.0) * k).to(dtype)


def lstm_cell(z, c):
    """Gates z (N, B, 4H) and cell state c (N, B, H) -> (h', c'); gate
    order i, f, g, o."""
    H = c.shape[-1]
    sg = torch.sigmoid(z)
    g = torch.tanh(z[..., 2 * H : 3 * H])
    c2 = torch.addcmul(sg[..., H : 2 * H] * c, sg[..., :H], g)
    return sg[..., 3 * H :] * torch.tanh(c2), c2


class StackedSeq2Seq(nn.Module):
    """P independent LSTM encoder-decoders (``init_seq2seq`` of the JAX
    package, stacked). ``increment=True`` makes the head emit step deltas
    (SurrogateConfig.target_mode="increment"): y_t = y_{t-1} + head, with
    the gate kept as the constant buffer ``ginc``."""

    def __init__(self, n_models: int, input_size: int, hidden_size: int,
                 num_layers_encoder: int = 2, bidirectional: bool = True, *,
                 increment: bool = False, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        P, H = int(n_models), int(hidden_size)
        gen = generator or torch.Generator().manual_seed(0)
        self.n_models, self.input_size, self.hidden_size = P, input_size, H
        self.bidirectional = bool(bidirectional)
        D = 2 if bidirectional else 1
        layers = []
        in_size = input_size
        for _ in range(num_layers_encoder):
            dirs = {"fwd": _Cell(P, in_size, H, dtype, gen)}
            if bidirectional:
                dirs["bwd"] = _Cell(P, in_size, H, dtype, gen)
            layers.append(nn.ModuleDict(dirs))
            in_size = D * H
        self.encoder = nn.ModuleList(layers)
        self.decoder = _Cell(P, input_size, D * H, dtype, gen)
        self.fc = _Head(P, D * H, input_size, dtype, gen)
        if increment:
            self.register_buffer("ginc", torch.ones((P,), dtype=dtype))
        else:
            self.ginc = None

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], dtype=torch.float32,
                    device=None) -> "StackedSeq2Seq":
        """A module holding the given stacked parameters ({name: (P, ...)},
        the names of the module docstring)."""
        n_layers = 1 + max(int(k.split(".")[1]) for k in arrays
                           if k.startswith("encoder."))
        Wi = np.asarray(arrays["decoder.Wi"])
        P, in_size = Wi.shape[:2]
        model = cls(P, in_size, np.shape(arrays["encoder.0.fwd.Wh"])[1],
                    n_layers, "encoder.0.bwd.Wi" in arrays,
                    increment="ginc" in arrays, dtype=dtype)
        model.load_arrays(arrays)
        return model.to(device) if device is not None else model

    def arrays(self) -> Dict[str, np.ndarray]:
        """{name: (P, ...) numpy array} of every parameter (and ginc)."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.state_dict().items()}

    def load_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        state = self.state_dict()
        if set(arrays) != set(state):
            raise KeyError(
                f"parameter names differ: missing "
                f"{sorted(set(state) - set(arrays))}, unexpected "
                f"{sorted(set(arrays) - set(state))}")
        with torch.no_grad():
            for k, t in state.items():
                a = torch.as_tensor(np.array(arrays[k]))
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"{k}: shape {tuple(a.shape)}, "
                                     f"expected {tuple(t.shape)}")
                t.copy_(a.to(t.dtype))

    # ------------------------------------------------------------------
    def encode(self, x):
        """x (P, B, T, in) -> the last layer's final (hn, cn), each
        (P, B, D*H), forward and backward concatenated (PyTorch
        semantics: the backward direction's final state is the one after
        consuming x[:, :, 0])."""
        P, B, T, _ = x.shape
        H = self.hidden_size
        xs = x.permute(2, 0, 1, 3)  # (T, P, B, F)
        hn = cn = None
        for layer in self.encoder:
            cells = list(layer.values())
            D = len(cells)
            F = xs.shape[-1]
            # the input projection of every step and direction at once
            Wi = torch.cat([c.Wi for c in cells], dim=-1)   # (P, F, D*4H)
            bias = torch.cat([c.bi + c.bh for c in cells], dim=-1)
            xp = torch.baddbmm(bias[:, None, :],
                               xs.permute(1, 0, 2, 3).reshape(P, T * B, F),
                               Wi)
            xp = xp.view(P, T, B, D, 4 * H).permute(1, 3, 0, 2, 4)
            if D == 2:
                # the backward direction consumes time in reverse
                xp = torch.stack([xp[:, 0], xp[:, 1].flip(0)], dim=1)
            xrec = xp.reshape(T, D * P, B, 4 * H)
            Wh = torch.cat([c.Wh for c in cells], dim=0)    # (D*P, H, 4H)
            h = c = x.new_zeros((D * P, B, H))
            outs = []
            for s in range(T):
                h, c = lstm_cell(torch.baddbmm(xrec[s], h, Wh), c)
                outs.append(h)
            hs = torch.stack(outs).view(T, D, P, B, H)
            if D == 2:
                xs = torch.cat([hs[:, 0], hs[:, 1].flip(0)], dim=-1)
                hn = torch.cat(h.view(D, P, B, H).unbind(0), dim=-1)
                cn = torch.cat(c.view(D, P, B, H).unbind(0), dim=-1)
            else:
                xs = hs[:, 0]
                hn, cn = h, c
        return hn, cn

    def predict(self, x, n_future: int, feat_mask=None):
        """Encode x (P, B, n_past, in) and decode ``n_future`` steps
        recursively from the last input step (``seq2seq_predict``).
        ``feat_mask`` (P, in) of 0/1 zeroes padded feature dims before
        each feed-back, so a padded model is exactly the unpadded one.
        Returns (P, B, n_future, in)."""
        h, c = self.encode(x)
        xi = x[:, :, -1, :]
        dec, fc = self.decoder, self.fc
        bias = (dec.bi + dec.bh)[:, None, :]
        fcb = fc.b[:, None, :]
        ginc = None if self.ginc is None else self.ginc[:, None, None]
        fm = None if feat_mask is None else feat_mask[:, None, :]
        ys = []
        for _ in range(n_future):
            z = torch.baddbmm(torch.baddbmm(bias, xi, dec.Wi), h, dec.Wh)
            h, c = lstm_cell(z, c)
            y = torch.baddbmm(fcb, h, fc.W)
            if ginc is not None:
                y = y + ginc * xi
            if fm is not None:
                y = y * fm
            ys.append(y)
            xi = y
        return torch.stack(ys, dim=2)
