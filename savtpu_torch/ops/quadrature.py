"""Gauss quadrature rules on the reference tetrahedron.

Same three rules the reference carries (Tools/Qudrature.py:6-45, constants
originally from FIAT / Zienkiewicz-Taylor): key n=2 is the 4-point O(h^2)
rule used by the dynamic pipeline (Mat_construction.py:29-31); n=3 the
5-point O(h^3); n=4 the 14-point O(h^4). Weights sum to 1/6 = |ref tet|.
"""

from __future__ import annotations

import numpy as np


def tet_quadrature(n: int):
    """Return (nodes (Q,3), weights (Q,)) float64 numpy arrays."""
    if n == 2:
        a, b = 0.5854101966249685, 0.1381966011250105
        nodes = np.array(
            [[a, b, b], [b, a, b], [b, b, a], [b, b, b]], dtype=np.float64
        )
        weights = np.full(4, 0.25 / 6.0, dtype=np.float64)
    elif n == 3:
        nodes = np.array(
            [
                [0.25, 0.25, 0.25],
                [0.5, 1.0 / 6.0, 1.0 / 6.0],
                [1.0 / 6.0, 0.5, 1.0 / 6.0],
                [1.0 / 6.0, 1.0 / 6.0, 0.5],
                [1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0],
            ],
            dtype=np.float64,
        )
        weights = (
            np.array([-4.0 / 5.0, 0.45, 0.45, 0.45, 0.45], dtype=np.float64)
            / 6.0
        )
    elif n == 4:
        c, d = 0.6984197043243866, 0.1005267652252045
        e, f = 0.0568813795204234, 0.3143728734931922
        nodes = np.array(
            [
                [0.0, 0.5, 0.5],
                [0.5, 0.0, 0.5],
                [0.5, 0.5, 0.0],
                [0.5, 0.0, 0.0],
                [0.0, 0.5, 0.0],
                [0.0, 0.0, 0.5],
                [c, d, d],
                [d, d, d],
                [d, d, c],
                [d, c, d],
                [e, f, f],
                [f, f, f],
                [f, f, e],
                [f, e, f],
            ],
            dtype=np.float64,
        )
        weights = (
            np.concatenate(
                [
                    np.full(6, 0.0190476190476190),
                    np.full(4, 0.0885898247429807),
                    np.full(4, 0.1328387466855907),
                ]
            )
            / 6.0
        )
    else:
        raise ValueError(f"no tet quadrature rule for accuracy key n={n}")
    return nodes, weights
