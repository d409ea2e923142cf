"""Prony / matrix-pencil interface surrogate (SurrogateConfig.arch="expfit").

A NumPy copy of ``savtpu/models/expfit.py``; only the device evaluation
of the stage-4 feed (``eval_expfit_device``) is ported to PyTorch.

The plant is LINEAR elastodynamics under a ramped body load
(ops/material.py: linear_ramp ends at t = 1 s, reference
Tools/commons.py:7-11). That makes the interface motion an exact
two-segment exponential sum:

  in-ramp   d(t) = a + b*(t/t_ramp) + sum_k Re(A_k z_k^t)
            (the particular solution of  M d'' + K d = c*t  is linear
            in t, exactly), and
  post-ramp d(t) = c + sum_k Re(B_k z_k^(t - t_ramp)),

with the SAME system poles z_k in both segments. So the surrogate is
system identification, not sequence regression: estimate z_k once from
the post-ramp portion of the training half (matrix pencil on a Hankel of
the stored rows), least-squares the per-segment amplitudes, and the
prediction at ANY future step is closed-form — open loop in time, no
autoregression, hence exactly zero closed-loop drift. Measured on the
96x8x8/16 stage-1 trace (scripts/expfit_lab.py): shared-row
reconstruction 0.001-0.03% over the full deployment span including the
pure-extrapolation second half, ~3 orders of magnitude below the LSTM
surrogate's in-band drift plateau (docs/STATUS_r3.md).

All fitting and evaluation here is host-side float64 in stored-ROW time
units (the stage-4 feed evaluates at fractional rows step/save_every and
ships the finished coefficient blocks to the device once). The LSTM and
linear arches remain for nonlinear / nonstationary problems where LTI
identification does not apply (e.g. material.py's Neo-Hookean option).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "matrix_pencil",
    "fit_expfit",
    "eval_expfit",
    "init_expfit",
    "advance_expfit",
    "eval_expfit_device",
]


def matrix_pencil(y: np.ndarray, order: int, pencil: int | None = None):
    """Estimate complex per-sample ratios z_k of y_j ~ sum_k c_k z_k^j
    via the matrix-pencil method (Hua & Sarkar 1990: SVD-truncate a
    Hankel to the signal subspace, eigenvalues of the shift operator).
    |z| is clipped to <= 1: the physical system is non-growing and a
    spurious |z| > 1 root explodes at 1e5-step horizons."""
    y = np.asarray(y, np.float64)
    N = len(y)
    if N < 8:
        return np.zeros(0, complex)
    L = pencil or min(max(2 * order, N // 3), N // 2)
    L = max(min(L, N - 2), 1)
    H = np.lib.stride_tricks.sliding_window_view(y, L + 1)  # (N-L, L+1)
    U, s, Vt = np.linalg.svd(H, full_matrices=False)
    M = int(min(order, len(s)))
    V = Vt[:M].conj().T          # (L+1, M)
    A = np.linalg.pinv(V[:-1]) @ V[1:]
    z = np.linalg.eigvals(A)
    mag = np.abs(z)
    return np.where(mag > 1.0, z / mag, z)


def _design(t: np.ndarray, z: np.ndarray, ramp_cols: bool, ramp_end: float):
    """Complex design matrix [1 (, t/ramp_end) | z_k^t]."""
    cols = [np.ones((len(t), 1), complex)]
    if ramp_cols:
        cols.append((t / max(ramp_end, 1.0))[:, None].astype(complex))
    cols += [np.power(zk, t)[:, None] for zk in z]
    return np.concatenate(cols, axis=1)


def _ls_amplitudes(y: np.ndarray, V: np.ndarray) -> np.ndarray:
    """Real least squares y ~ Re(V c); returns complex c."""
    Vr = np.concatenate([V.real, -V.imag], axis=1)
    c, *_ = np.linalg.lstsq(Vr, y, rcond=None)
    m = V.shape[1]
    return c[:m] + 1j * c[m:]


def fit_expfit(co: np.ndarray, ramp_end_row: float, order: int = 24):
    """Fit the two-segment exponential model to each channel of the
    TRAINING rows ``co`` (T_cut, C). Returns a params dict of real
    numpy arrays (msgpack-serializable):

      z_re/z_im     (M,)      shared per-step... per-ROW pole ratios
      ccA_re/ccA_im (C, 2+M)  in-ramp amplitudes   [1, t/ramp | modes]
      ccB_re/ccB_im (C, 1+M)  post-ramp amplitudes [1 | modes]

    If the training rows end before the ramp does (short smoke runs),
    the post-ramp segment is unobserved: poles come from the linearly
    detrended in-ramp rows and ccB falls back to the segment-A model
    frozen at the ramp end (continuous, approximate — flagged in the
    returned info dict)."""
    co = np.asarray(co, np.float64)
    Tc, C = co.shape
    ramp_end_row = float(ramp_end_row)
    post = co[int(ramp_end_row):] if ramp_end_row < Tc else co[:0]
    has_post = len(post) >= max(4 * order, 32)

    # poles from the autonomous segment when observed; otherwise from the
    # detrended ramp segment (same homogeneous dynamics)
    if has_post:
        src = post - post.mean(axis=0)
    else:
        t = np.arange(Tc, dtype=np.float64)
        A = np.stack([np.ones(Tc), t], axis=1)
        src = co - A @ np.linalg.lstsq(A, co, rcond=None)[0]
    # one shared pole set across channels: stack channel Hankels by
    # estimating from the energy-dominant channel mix (channel 0 holds
    # ~all modal energy by construction; add a few for robustness)
    w = np.linalg.norm(src, axis=0)
    mix = src @ (w / max(w.sum(), 1e-300))
    z = matrix_pencil(mix, order)
    M = len(z)

    tA = np.arange(0, int(min(ramp_end_row, Tc)), dtype=np.float64)
    VA = _design(tA, z, True, ramp_end_row)
    ccA = np.stack(
        [_ls_amplitudes(co[: len(tA), c], VA) for c in range(C)]
    ) if len(tA) else np.zeros((C, 2 + M), complex)

    if has_post:
        tB = np.arange(int(ramp_end_row), Tc, dtype=np.float64) - ramp_end_row
        VB = _design(tB, z, False, ramp_end_row)
        ccB = np.stack(
            [_ls_amplitudes(co[int(ramp_end_row):, c], VB) for c in range(C)]
        )
    else:
        # freeze the A model at the ramp end: constant = a + b, modes
        # continued with their in-ramp amplitudes advanced to t_ramp
        adv = (
            np.power(z[None, :], ramp_end_row) * ccA[:, 2:]
            if M else np.zeros((C, 0), complex)
        )
        ccB = np.concatenate(
            [(ccA[:, 0] + ccA[:, 1])[:, None], adv], axis=1
        )

    params = {
        "z_re": z.real.astype(np.float64),
        "z_im": z.imag.astype(np.float64),
        "ccA_re": ccA.real.astype(np.float64),
        "ccA_im": ccA.imag.astype(np.float64),
        "ccB_re": ccB.real.astype(np.float64),
        "ccB_im": ccB.imag.astype(np.float64),
    }
    return params, {"has_post_segment": bool(has_post), "n_modes": int(M)}


def eval_expfit(params, rows: np.ndarray, ramp_end_row: float) -> np.ndarray:
    """Evaluate the fitted model at (possibly fractional) row indices.
    Returns (len(rows), C) float64. Fractional rows take the principal
    branch of z^t — valid because the stored-row grid is unaliased (the
    truth's above-row-Nyquist content is ~0.003%, docs/STATUS_r3.md)."""
    rows = np.asarray(rows, np.float64)
    z = params["z_re"] + 1j * params["z_im"]
    ccA = params["ccA_re"] + 1j * params["ccA_im"]
    ccB = params["ccB_re"] + 1j * params["ccB_im"]
    C = ccA.shape[0]
    out = np.empty((len(rows), C))
    inA = rows < ramp_end_row
    if inA.any():
        VA = _design(rows[inA], z, True, ramp_end_row)
        out[inA] = (VA @ ccA.T).real
    if (~inA).any():
        VB = _design(rows[~inA] - ramp_end_row, z, False, ramp_end_row)
        out[~inA] = (VB @ ccB.T).real
    return out


def advance_expfit(params, r0_row: float, ramp_end_row: float):
    """Advance the fitted two-segment model to a block origin ``r0_row``
    so the remaining evaluation is a function of the SMALL in-block row
    offset only. Host float64 — this is the precision-preserving split
    behind the on-device stage-4 feed (pipeline/online_predictor.py):
    the absolute advance z^{r0} (r0 up to ~4e3 rows, where float32 phase
    error would be ~1e-4 relative) happens here in f64; the device only
    ever computes z^{delta} for delta < block/save_every (~60 rows),
    where f32 is exact to ~1e-5.

    Returns a dict of f64 arrays for ``eval_expfit_device``:
      constA (C,)  in-ramp constant folded with the linear term at r0
      linA   (C,)  per-row linear slope (in-ramp only)
      aA_re/aA_im (C, M)  in-ramp mode amplitudes advanced by z^{r0}
      constB (C,), aB_re/aB_im (C, M)  post-ramp, advanced by
                   z^{max(r0-ramp, 0)} (never a negative power — a
                   straddling block evaluates B from the ramp end)
      gap    ()    rows from r0 to the ramp end, clipped at 0: steps
                   with delta < gap are in-ramp
    """
    z = params["z_re"] + 1j * params["z_im"]
    ccA = params["ccA_re"] + 1j * params["ccA_im"]
    ccB = params["ccB_re"] + 1j * params["ccB_im"]
    ramp = float(ramp_end_row)
    r0 = float(r0_row)
    denom = max(ramp, 1.0)
    constA = ccA[:, 0].real + ccA[:, 1].real * (r0 / denom)
    linA = ccA[:, 1].real / denom
    aA = ccA[:, 2:] * np.power(z, r0)[None, :]
    aB = ccB[:, 1:] * np.power(z, max(r0 - ramp, 0.0))[None, :]
    return {
        "constA": constA, "linA": linA,
        "aA_re": aA.real, "aA_im": aA.imag,
        "constB": ccB[:, 0].real.copy(),
        "aB_re": aB.real, "aB_im": aB.imag,
        "gap": np.float64(max(ramp - r0, 0.0)),
    }


def eval_expfit_device(pack, z_re, z_im, save_every, n_steps: int,
                       dtype=torch.float32):
    """Evaluation of an advanced block pack at in-block step offsets
    0..n_steps-1 (fractional rows delta = i / save_every), on the pack's
    device. Batched over a leading parts axis: pack leaves are (P, C) /
    (P, C, M) / (P,) tensors, ``z_re``/``z_im`` (P, M), ``save_every``
    (P,). Returns (P, n_steps, C). Segment selection per step: in-ramp
    while delta < gap, post-ramp after (the post-ramp offset is delta -
    gap, clamped at 0 — those steps are masked to the in-ramp value
    anyway). Float32 by default, as in the JAX package's stage-4 feed."""
    dev = z_re.device
    i = torch.arange(n_steps, dtype=dtype, device=dev)
    delta = i[None, :] / save_every.to(dtype)[:, None]  # (P, T)
    logmag = torch.log(torch.clamp(torch.hypot(z_re, z_im), min=1e-30))
    theta = torch.atan2(z_im, z_re)  # (P, M)

    def modes(d):
        mag = torch.exp(d[:, :, None] * logmag[:, None, :])
        ang = d[:, :, None] * theta[:, None, :]
        return mag * torch.cos(ang), mag * torch.sin(ang)  # (P, T, M)

    vAr, vAi = modes(delta)
    coA = (
        pack["constA"][:, None, :]
        + delta[:, :, None] * pack["linA"][:, None, :]
        + torch.einsum("pkm,ptm->ptk", pack["aA_re"], vAr)
        - torch.einsum("pkm,ptm->ptk", pack["aA_im"], vAi)
    )
    gap = pack["gap"][:, None]
    dB = torch.clamp(delta - gap, min=0.0)
    vBr, vBi = modes(dB)
    coB = (
        pack["constB"][:, None, :]
        + torch.einsum("pkm,ptm->ptk", pack["aB_re"], vBr)
        - torch.einsum("pkm,ptm->ptk", pack["aB_im"], vBi)
    )
    return torch.where((delta < gap)[:, :, None], coA, coB)


def init_expfit(order: int, channels: int):
    """Zero template matching fit_expfit's params tree (for
    load_params)."""
    return {
        "z_re": np.zeros(order), "z_im": np.zeros(order),
        "ccA_re": np.zeros((channels, 2 + order)),
        "ccA_im": np.zeros((channels, 2 + order)),
        "ccB_re": np.zeros((channels, 1 + order)),
        "ccB_im": np.zeros((channels, 1 + order)),
    }
