"""Spatial-mode (PCA) representation of shared-DOF traces.

The cantilever's interface motion is spatially near-rank-1: the first
right-singular vector of the (T, D) shared trace carries >99.99% of the
energy on every mesh studied (docs/STATUS_r3.md). ``modal_dim = k``
trains the surrogate on the k mode coefficients instead of the D raw
DOFs (SurrogateConfig.modal_dim): the learning problem shrinks ~100x and
any prediction error orthogonal to the basis — the high-gain direction
for the comm-free solver — is eliminated by construction.

Basis convention: ``basis`` is (k, D) row-orthonormal; coefficients are
``(trace - mu) @ basis.T``; reconstruction is ``coef @ basis + mu``.
"""

from __future__ import annotations

import numpy as np


def modal_basis(trace: np.ndarray, k: int):
    """(T, D) training trace -> (mu (D,), basis (k, D)).

    The basis comes from the SVD of the mean-removed trace; k is clamped
    to min(T, D). Columns that are identically zero (padding) produce
    zero basis entries, so reconstruction leaves pad slots at exactly 0
    when mu is 0 there."""
    trace = np.asarray(trace, dtype=np.float64)
    mu = trace.mean(axis=0)
    X = trace - mu
    k = int(min(k, min(X.shape)))
    _, _, Vt = np.linalg.svd(X, full_matrices=False)
    return mu, Vt[:k]


def to_modal(trace, mu, basis):
    """(..., D) -> (..., k)."""
    return (np.asarray(trace) - mu) @ np.asarray(basis).T


def from_modal(coef, mu, basis):
    """(..., k) -> (..., D)."""
    return np.asarray(coef) @ np.asarray(basis) + mu
