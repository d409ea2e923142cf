"""Online phase-interleaved predictor (port of
``savtpu/models/predictor.py``).

Each comm-free block of n_f*n_s steps is refilled by n_s phase-offset
predictions at once. For offset i in [0, n_s), the encoder reads the
trailing-window rows i + j*n_s (j < n_p) and the decode fills the block
rows i + j*n_s (j < n_f); together the n_s offsets cover every row of the
(n_f*n_s, D) block. In a window of n_p*n_s rows both index sets are
reshapes: the history is ``hist.view(n_p, n_s, D).transpose(0, 1)`` and
the block is ``Y.transpose(0, 1).reshape(n_f*n_s, D)`` — no gather and no
scatter.
"""

from __future__ import annotations

import torch

from .data import scale_back, scale_forward


def phase_interleaved_predict_stacked(
    model,              # StackedSeq2Seq of P models
    histories,          # (P, n_p*n_s, Dmax) padded trailing windows
    smax,               # (P,) or (P, Dmax)
    smin,
    n_past: int,
    n_future: int,
    filter_size: int,
    feat_mask=None,     # (P, Dmax)
):
    """All shards' next (n_f*n_s, Dmax) blocks in one batched call:
    (P, n_f*n_s, Dmax). Padded dims are zeroed again after
    ``scale_back`` (which maps a scaled 0 to smax, not 0)."""
    P, W, D = histories.shape
    n_s = filter_size
    if W != n_past * n_s:
        raise ValueError(f"history has {W} rows; expected n_past * "
                         f"filter_size = {n_past * n_s}")
    mx = smax.reshape(P, 1, 1, -1)
    mn = smin.reshape(P, 1, 1, -1)
    X = histories.reshape(P, n_past, n_s, D).transpose(1, 2)
    Y = model.predict(scale_forward(X, mx, mn), n_future, feat_mask)
    Y = scale_back(Y, mx, mn)
    if feat_mask is not None:
        Y = Y * feat_mask[:, None, None, :]
    return Y.transpose(1, 2).reshape(P, n_future * n_s, D)


def phase_interleaved_predict(model, history, smax, smin, n_past: int,
                              n_future: int, filter_size: int,
                              feat_mask=None):
    """One model's next (n_f*n_s, D) block from its trailing
    (n_p*n_s, D) history: the stacked call with P = 1 (``model`` holds
    one model; ``smax``/``smin`` scalars or (D,), ``feat_mask`` (D,))."""
    def as_row(v):
        if v is None:
            return None
        return torch.as_tensor(v, dtype=history.dtype,
                               device=history.device).reshape(1, -1)

    return phase_interleaved_predict_stacked(
        model, history[None], as_row(smax), as_row(smin), n_past, n_future,
        filter_size, as_row(feat_mask))[0]
