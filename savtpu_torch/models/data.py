"""Trace windowing, feature scaling, train/val split.

A NumPy copy of ``savtpu/models/data.py``, so that the port gives the
same windows, scaling constants and splits, bit for bit.

Reproduces the reference data pipeline (Tools/DNN_tools.py:259-313):

- ``strided_windows``: keep the first ``cut_off`` fraction of the (T, D)
  trace, subsample every ``filter_size`` steps, slide (n_past -> n_future)
  windows (Dis_data_filtered_subset_coronary).
- ``scale_to_zero_one``: joint-min/max affine map onto [-1, 0]:
  X' = (X - max) / (max - min)  (Scale_to_zero_one).
- ``train_val_split``: random unordered ``portion`` split, remainder
  ordered (Model_training.py:100-109).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def strided_windows(
    trace: np.ndarray,
    n_past: int,
    n_future: int,
    filter_size: int,
    cut_off: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """trace (T, D) -> X (G, n_past, D), Y (G, n_future, D)."""
    data = np.asarray(trace)
    data = data[: int(cut_off * len(data))]
    data = data[::filter_size]
    total = data.shape[0] - n_future - n_past + 1
    if total <= 0:
        raise ValueError(
            f"trace too short: {data.shape[0]} strided rows for "
            f"{n_past}->{n_future} windows"
        )
    idx = np.arange(total)
    X = data[idx[:, None] + np.arange(n_past)[None, :]]
    Y = data[idx[:, None] + n_past + np.arange(n_future)[None, :]]
    return X, Y


def scale_to_zero_one(X, Y, mode: str = "joint"):
    """Scale X, Y onto [-1, 0]; returns (X', Y', smax, smin).

    mode="joint" is the reference's Scale_to_zero_one (one global min/max
    pair). mode="per_feature" scales each feature by its own min/max —
    a savtpu extension: with joint scaling, small-amplitude interface DOFs
    (e.g. near the clamped wall) contribute ~nothing to the MSE and the
    surrogate never learns them (measured 26% teacher-forced error on the
    wall-adjacent shard at 16 parts, runs/scale_96/diagnosis.json); smax
    and smin are then (D,) arrays. Features whose range is < 1e-3 of the
    global range keep a floored denominator so near-constant channels
    don't amplify noise."""
    if mode == "joint":
        smin = min(float(X.min()), float(Y.min()))
        smax = max(float(X.max()), float(Y.max()))
        X = (X - smax) / (smax - smin)
        Y = (Y - smax) / (smax - smin)
        return X, Y, smax, smin
    if mode != "per_feature":
        raise ValueError(f"unknown scale mode {mode!r}")
    ax = tuple(range(np.ndim(X) - 1))
    smin = np.minimum(np.asarray(X).min(axis=ax), np.asarray(Y).min(axis=ax))
    smax = np.maximum(np.asarray(X).max(axis=ax), np.asarray(Y).max(axis=ax))
    floor = 1e-3 * max(float(smax.max() - smin.min()), 1e-30)
    smin = np.where(smax - smin < floor, smax - floor, smin)
    X = (X - smax) / (smax - smin)
    Y = (Y - smax) / (smax - smin)
    return X, Y, smax, smin


def scale_forward(X, smax, smin):
    return (X - smax) / (smax - smin)


def scale_back(X, smax, smin):
    return X * (smax - smin) + smax


def train_val_split(n: int, portion: float, rng: np.random.Generator):
    """Random unordered train slice + ordered complement
    (Model_training.py:101-102)."""
    train = rng.choice(n, size=int(portion * n), replace=False)
    val = np.setdiff1d(np.arange(n), train)
    return train, val
