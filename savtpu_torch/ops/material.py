"""Linear elastic material (port of ``savtpu/ops/material.py``:
``LinearElastic`` and ``linear_ramp``). Voigt 6x6 stiffness D from Lame
parameters and the volumetric load f(X, t) = (0, -fz, -fz), optionally
multiplied by linear_ramp(t). The Neo-Hookean model waits for a later
slice."""

from __future__ import annotations

from dataclasses import dataclass

import torch


def linear_ramp(t):
    """min(t, 1): the load ramp ends at t = 1 s."""
    return torch.clamp(t, max=1.0)


@dataclass(frozen=True)
class LinearElastic:
    lmd: float
    mu: float
    rho: float
    fz: float
    ramped: bool = True

    @classmethod
    def from_engineering(cls, E, nu, rho, fz, ramped=True):
        return cls(
            lmd=E * nu / ((1 + nu) * (1 - 2 * nu)),
            mu=E / (2 * (1 + nu)),
            rho=rho,
            fz=fz,
            ramped=ramped,
        )

    def D(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """Voigt 6x6 elasticity matrix, ordering (xx, yy, zz, yz, zx, xy)."""
        l, m = self.lmd, self.mu
        return torch.tensor(
            [
                [l + 2 * m, l, l, 0, 0, 0],
                [l, l + 2 * m, l, 0, 0, 0],
                [l, l, l + 2 * m, 0, 0, 0],
                [0, 0, 0, m, 0, 0],
                [0, 0, 0, 0, m, 0],
                [0, 0, 0, 0, 0, m],
            ],
            dtype=dtype,
            device=device,
        )

    def body_force(self, t: float, dtype=torch.float64, device=None):
        """Volumetric load density (3,) at time t (uniform in space)."""
        f = torch.tensor([0.0, -self.fz, -self.fz], dtype=dtype,
                         device=device)
        if self.ramped:
            f = f * linear_ramp(torch.tensor(t, dtype=dtype, device=device))
        return f
