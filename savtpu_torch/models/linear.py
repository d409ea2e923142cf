"""Linear (ridge-regression) surrogate (port of ``savtpu/models/linear.py``).

``arch="linear"`` (SurrogateConfig.arch) replaces the LSTM with one
affine map of the flattened window,

    y = flat(X) @ W + b,     W: (n_past*D, n_future*D),

fit in closed form on the host in float64 (no epochs, no optimizer) and
applied on the device as one batched product per block. The plant is
linear elastodynamics, so on the coarse sampling grid the map from the
n_past window to the n_future window of the true shared-DOF trace is
near-affine.

The fitting code (``fit_linear_arrays``, ``stabilize_spectrum``,
``closed_loop_rel``, ``fit_linear`` with its ridge ladder) is a NumPy
copy of the JAX package's, so both packages pick the same ridge lambda
and the same W, b on the same windows. :class:`StackedLinear` holds P
such maps as parameters with a leading model axis and has the
``predict`` of :class:`~savtpu_torch.models.lstm.StackedSeq2Seq`, so the
phase-interleaved predictor takes either.

Parameter names (the module's ``state_dict`` and a rank's ``model.npz``):
``lin.W`` (n_past*D, n_future*D) and ``lin.b`` (n_future*D,), the JAX
package's ``{"lin": {"W", "b"}}`` pytree with dotted paths.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

LIN_KEYS = ("lin.W", "lin.b")
_NP_DTYPES = {"float32": np.float32, "float64": np.float64,
              "bfloat16": np.float32}


def init_linear(n_past: int, n_future: int, D: int,
                dtype=np.float32) -> Dict[str, np.ndarray]:
    """Zero parameters of one map, under the port's names."""
    return {"lin.W": np.zeros((n_past * D, n_future * D), dtype),
            "lin.b": np.zeros((n_future * D,), dtype)}


class _Lin(nn.Module):
    def __init__(self, P, n_in, n_out, dtype):
        super().__init__()
        self.W = nn.Parameter(torch.zeros((P, n_in, n_out), dtype=dtype))
        self.b = nn.Parameter(torch.zeros((P, n_out), dtype=dtype))


class StackedLinear(nn.Module):
    """P independent window maps: W (P, n_past*D, n_future*D), b (P,
    n_future*D)."""

    def __init__(self, n_models: int, n_past: int, n_future: int,
                 input_size: int, dtype=torch.float32):
        super().__init__()
        self.n_models, self.input_size = int(n_models), int(input_size)
        self.n_past, self.n_future = int(n_past), int(n_future)
        self.lin = _Lin(self.n_models, n_past * input_size,
                        n_future * input_size, dtype)

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], n_past: int,
                    dtype=torch.float32, device=None) -> "StackedLinear":
        """A module holding the given stacked maps ({"lin.W": (P, n_past*D,
        n_future*D), "lin.b": (P, n_future*D)})."""
        P, n_in, n_out = np.shape(arrays["lin.W"])
        D = n_in // n_past
        model = cls(P, n_past, n_out // D, D, dtype=dtype)
        model.load_arrays(arrays)
        return model.to(device) if device is not None else model

    def arrays(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy()
                for k, v in self.state_dict().items()}

    def load_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        if set(arrays) != set(LIN_KEYS):
            raise KeyError(f"linear parameters are {LIN_KEYS}, got "
                           f"{sorted(arrays)}")
        with torch.no_grad():
            for k, t in self.state_dict().items():
                a = torch.as_tensor(np.array(arrays[k]))
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"{k}: shape {tuple(a.shape)}, "
                                     f"expected {tuple(t.shape)}")
                t.copy_(a.to(t.dtype))

    def predict(self, x, n_future: int, feat_mask=None):
        """x (P, B, n_past, D) scaled windows -> (P, B, n_future, D): the
        direct multi-horizon map (``linear_predict``). ``feat_mask`` (P, D)
        zeroes padded feature dims of input and output. On the card the
        product runs in full float32 (``utils.full_precision_products``):
        the ridge W has large near-cancelling coefficients and stage 4
        feeds the output back."""
        P, B, n_past, D = x.shape
        if feat_mask is not None:
            x = x * feat_mask[:, None, None, :]
        y = torch.baddbmm(self.lin.b[:, None, :], x.reshape(P, B, n_past * D),
                          self.lin.W)
        y = y.reshape(P, B, n_future, D)
        if feat_mask is not None:
            y = y * feat_mask[:, None, None, :]
        return y


# ----------------------------------------------------------------------
# the closed-form fit (host float64, NumPy)
# ----------------------------------------------------------------------

def fit_linear_arrays(
    X: np.ndarray,          # (G, n_past, D) scaled training windows
    Y: np.ndarray,          # (G, n_future, D) scaled targets
    lam_rel: float,
    feat_mask: Optional[np.ndarray] = None,   # (D,) 0/1
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form ridge fit in float64; returns (W, b).

    Features and targets are centered so the penalty never shrinks the
    mean; the bias is recovered exactly. ``lam_rel`` scales the penalty by
    the mean feature energy (dimensionless). Masked (padded) feature dims
    are zeroed first, which with centering forces their W rows and
    columns to 0."""
    G = X.shape[0]
    Xf = np.asarray(X, np.float64).reshape(G, -1)
    Yf = np.asarray(Y, np.float64).reshape(G, -1)
    if feat_mask is not None:
        fm = np.asarray(feat_mask, np.float64)
        Xf = Xf * np.tile(fm, X.shape[1])
        Yf = Yf * np.tile(fm, Y.shape[1])
    xm = Xf.mean(axis=0)
    ym = Yf.mean(axis=0)
    Xc = Xf - xm
    Yc = Yf - ym
    A = Xc.T @ Xc
    n = A.shape[0]
    lam = lam_rel * max(np.trace(A) / n, 1e-300)
    W = np.linalg.solve(A + lam * np.eye(n), Xc.T @ Yc)
    b = ym - xm @ W
    return W, b


def stabilize_spectrum(W: np.ndarray,
                       rho_max: float) -> Tuple[np.ndarray, float]:
    """Clip the eigenvalue magnitudes of the square window map to
    ``rho_max``. With n_past == n_future the online recursion is
    x_{b+1} = x_b @ W per phase offset, so closed-loop stability is
    rho(W) <= 1; only the expansive eigenvalues are clipped. Returns
    (W_stable, rho_before)."""
    lam, V = np.linalg.eig(W)
    mag = np.abs(lam)
    rho = float(mag.max())
    if rho <= rho_max:
        return W, rho
    lam = lam * np.minimum(1.0, rho_max / np.maximum(mag, 1e-300))
    W2 = np.real(V @ np.diag(lam) @ np.linalg.inv(V))
    return W2, rho


def closed_loop_rel(
    W: np.ndarray,
    b: np.ndarray,
    seq: np.ndarray,        # (Tc, D) scaled coarse-grid sequence
    n_past: int,
    n_future: int,
    noise_rel: float = 1e-5,
) -> float:
    """Autoregressive replay error of the window map on one coarse
    sequence: start from the first n_past rows, predict the next
    n_future, feed the prediction back (stage 4's recursion per phase
    offset), and compare the rollout with the true continuation. Returns
    the rel-L2; divergence maps to inf.

    As in the JAX package: the rollout runs in float32 (what stage 4
    feeds back), continues past the end of ``seq`` to at least 48 blocks
    with a magnitude tripwire, and injects ``noise_rel``-scaled
    pseudo-noise (fixed seed; white and constant-in-time) into the
    feedback, so the score measures the closed loop's transfer gain and
    not only the clean orbit."""
    Tc, D = seq.shape
    n_blocks = (Tc - n_past) // n_future
    if n_blocks < 1:
        return float("inf")
    min_blocks = 48
    W32 = W.astype(np.float32)
    b32 = b.astype(np.float32)
    bound = 20.0 * max(float(np.abs(seq).max()), 1.0)
    rng = np.random.default_rng(0)
    sig = noise_rel * float(np.sqrt(np.mean(seq.astype(np.float64) ** 2)))
    hist = seq[:n_past].astype(np.float32).copy()
    err2 = 0.0
    den2 = 0.0
    t = n_past
    for k in range(max(n_blocks, min_blocks)):
        y = (hist.reshape(1, -1) @ W32 + b32).reshape(n_future, D)
        if sig > 0:
            y = y + rng.normal(size=y.shape).astype(np.float32) * sig
            y = y + rng.normal(size=(1, D)).astype(np.float32) * sig
        if not np.all(np.isfinite(y)) or float(np.abs(y).max()) > bound:
            return float("inf")
        if k < n_blocks:
            truth = seq[t : t + n_future]
            err2 += float(((y.astype(np.float64) - truth) ** 2).sum())
            den2 += float((truth**2).sum())
            t += n_future
        hist = np.concatenate([hist, y])[-n_past:]
    if not np.isfinite(err2):
        return float("inf")
    return float(np.sqrt(err2 / max(den2, 1e-300)))


def _metrics(out, truth, feat_mask=None) -> Tuple[float, float, float]:
    """(loss, r2, rel) with the trainers' batch-metric semantics."""
    out = np.asarray(out, np.float64)
    truth = np.asarray(truth, np.float64)
    if feat_mask is None:
        loss = np.mean((out - truth) ** 2)
        var = np.mean((truth - truth.mean()) ** 2)
        ms = np.mean(truth**2)
    else:
        fm = np.asarray(feat_mask, np.float64)
        denom = out.shape[0] * out.shape[1] * fm.sum()
        d = (out - truth) * fm
        loss = (d * d).sum() / denom
        tmean = (truth * fm).sum() / denom
        var = (((truth - tmean) * fm) ** 2).sum() / denom
        ms = ((truth * fm) ** 2).sum() / denom
    return float(loss), float(1.0 - loss / var), float(1.0 - loss / ms)


def fit_linear(cfg, X_train, Y_train, X_val=None, Y_val=None,
               feat_mask=None, dtype=None, seqs=None):
    """The ridge fit with the trainers' history keys (one "epoch": the
    exact solve). Returns ({"lin.W", "lin.b"} in the surrogate's dtype,
    history).

    ``seqs`` (optional): scaled coarse-grid sequences (Tc, D) of the
    trace's training portion, one per phase offset. With them the fit is
    a ridge ladder: each candidate lambda (cfg.ridge_lambda and 1e-6,
    1e-4, 1e-2, 1e-1, 1, strongest first) is fit, the stability guard
    (cfg.linear_rho_max) applied, and the candidate scored by the RMS of
    ``closed_loop_rel`` over the sequences; the smallest score wins, the
    first (strongest) on a tie."""
    np_dtype = _NP_DTYPES[dtype or cfg.dtype]
    n_future = Y_train.shape[1]
    D = X_train.shape[-1]
    rho_max = float(getattr(cfg, "linear_rho_max", 0.0) or 0.0)

    def fit_one(lam):
        W, b = fit_linear_arrays(X_train, Y_train, lam, feat_mask=feat_mask)
        if rho_max > 0 and W.shape[0] == W.shape[1]:
            W, _ = stabilize_spectrum(W, rho_max)
        return W, b

    chosen_lam = float(cfg.ridge_lambda)
    if seqs:
        ladder = sorted({float(cfg.ridge_lambda), 1e-6, 1e-4, 1e-2, 1e-1,
                         1.0}, reverse=True)
        best = None
        for lam in ladder:
            W_c, b_c = fit_one(lam)
            score = float(np.sqrt(np.mean([
                closed_loop_rel(W_c, b_c, s, X_train.shape[1], n_future) ** 2
                for s in seqs])))
            if best is None or score < best[0]:
                best = (score, lam, W_c, b_c)
        _, chosen_lam, W, b = best
    else:
        W, b = fit_one(chosen_lam)
    params = {"lin.W": np.asarray(W, np_dtype),
              "lin.b": np.asarray(b, np_dtype)}
    G = X_train.shape[0]
    out_tr = (np.asarray(X_train, np.float64).reshape(G, -1) @ W
              + b).reshape(G, n_future, D)
    tl, tr2, trel = _metrics(out_tr, Y_train, feat_mask)
    hist = {"train_loss": [tl], "train_r2": [tr2], "train_rel": [trel],
            "val_loss": [], "val_r2": [], "val_rel": [],
            "ridge_lambda": chosen_lam}
    if X_val is not None and len(X_val) > 0:
        Gv = X_val.shape[0]
        out_va = (np.asarray(X_val, np.float64).reshape(Gv, -1) @ W
                  + b).reshape(Gv, n_future, D)
        vl, vr2, vrel = _metrics(out_va, Y_val, feat_mask)
        hist["val_loss"], hist["val_r2"], hist["val_rel"] = [vl], [vr2], [vrel]
    return params, hist
