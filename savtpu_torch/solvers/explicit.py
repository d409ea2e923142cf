"""The serial explicit central-difference runner (port of
``savtpu/solvers/explicit.py``: ``make_step_fn``, ``run_explicit``).

The displacement-form update with mass-proportional damping C = alpha M
and a lumped (diagonal) M:

    d1 = (dt^2 (F_ext - F_int) + 2 M d0 - M dn + dt/2 alpha M dn)
         / (M + alpha dt/2 M),        d1[Dirichlet] = 0,

with F_int(d0) from any operator (``ops.assembly.FIntOperator`` in its
dense, ebe or bcoo mode, ``solvers.nonlinear.NeoHookeanFIntOperator``) and
F_ext = F_pre * ramp(t) at the step's start time. It is the whole mesh in
one numbering, with no parts and no exchange: the oracle the partitioned
runs are held to.

The loop is an eager Python loop on the operator's device. The JAX
package's ``run_explicit_jit`` (a ``jax.jit`` of the scan) has no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops.material import linear_ramp


def make_step_fn(fint: Callable, F_pre, lumped_M, mask, alpha: float,
                 dt: float, ramped: bool = True) -> Callable:
    """Per-step function (d0, dn, tn) -> d1 on ``fint``'s device (its
    ``device`` attribute, else F_pre's); the vectors are moved there."""
    dev = getattr(fint, "device", F_pre.device)
    F_pre, lM, mask = (t.to(dev) for t in (F_pre, lumped_M, mask))
    denom = lM + 0.5 * alpha * dt * lM

    def step(d0, dn, tn):
        F_int = fint(d0)
        ramp = linear_ramp(tn) if ramped else torch.ones_like(tn)
        F_ext = F_pre * ramp
        d1 = (
            dt * dt * (F_ext - F_int)
            + 2.0 * lM * d0
            - lM * dn
            + 0.5 * dt * alpha * lM * dn
        ) / denom
        return d1 * mask

    step.device = dev
    return step


def run_explicit(step_fn: Callable, d0, dn, t0: float, dt: float,
                 num_steps: int, save_every: int = 1
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Run ``num_steps`` steps from (d0, dn, t0) on the step's device.

    Returns (trajectory (num_steps // save_every, ndof), final carry (d0,
    dn, tn)). The trajectory holds d1 of the steps i with i % save_every
    == 0 (the first step of each save block); t advances by dt a step."""
    if num_steps % save_every:
        raise ValueError("num_steps must be divisible by save_every")
    dev = getattr(step_fn, "device", d0.device)
    d0, dn = d0.to(dev), dn.to(dev)
    tn = torch.as_tensor(t0, dtype=d0.dtype).to(dev)
    traj = d0.new_empty((num_steps // save_every, d0.numel()))
    for i in range(num_steps):
        d1 = step_fn(d0, dn, tn)
        if i % save_every == 0:
            traj[i // save_every] = d1.reshape(-1)
        d0, dn, tn = d1, d0, tn + dt
    return traj, (d0, dn, tn)
