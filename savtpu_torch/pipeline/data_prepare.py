"""Stage 1: the exchanged explicit solve that produces the training data
(port of ``savtpu/pipeline/data_prepare.py``): partition labels, the
steady solve written to VTK, and the full exchanged run saved as per-rank
displacement histories."""

from __future__ import annotations

import time

import numpy as np

from ..config import Config
from ..io.artifacts import save_displacement
from ..mesh import write_vtk
from ..solvers.steady import steady_displacement
from ..utils import stage_log, synchronize
from .common import (
    StageContext,
    build_context,
    rank_trajectory,
    save_partition_labels,
)


def run(cfg: Config, ctx: StageContext | None = None, verbose: bool = True,
        device=None):
    if ctx is None:
        ctx = build_context(cfg, device=device)
    prob, sp, solver, store = ctx.prob, ctx.sp, ctx.solver, ctx.store
    if cfg.solver.ckpt_every:
        raise NotImplementedError("mid-run checkpoints are not ported yet")

    save_partition_labels(ctx)

    d_steady = np.asarray(steady_displacement(prob))
    write_vtk(
        store.steady_vtk(),
        prob.mesh,
        point_data={
            "displacement-x": d_steady[0::3],
            "displacement-y": d_steady[1::3],
            "displacement-z": d_steady[2::3],
        },
    )

    num_steps = cfg.solver.num_steps
    save_every = cfg.solver.save_every
    if num_steps % save_every:
        raise ValueError(
            f"num_steps ({num_steps}) must be divisible by save_every "
            f"({save_every})"
        )
    if verbose:
        print(f"[data_prepare] dt={prob.dt:.16e}, {num_steps} steps, "
              f"{sp.n_parts} parts, fint={sp.fint_mode}, "
              f"device={ctx.device}")

    d0 = sp.localize(prob.d0)
    dn = sp.localize(prob.dn)
    synchronize(ctx.device)
    t_start = time.perf_counter()
    # stage 1 never consumes the shared trace (stage 2 re-derives it from
    # the stored displacement), so only the trajectory is recorded
    (traj, _), _ = solver.run_streamed(
        d0, dn, 0.0, num_steps, sync=True, record="traj",
        save_every=save_every,
    )
    synchronize(ctx.device)
    elapsed = time.perf_counter() - t_start
    if verbose:
        print(f"[data_prepare] {num_steps} steps in {elapsed:.2f}s "
              f"({num_steps / elapsed:.0f} steps/s)")
    stage_log(cfg).log(
        "stage1_solve",
        steps=num_steps,
        seconds=round(elapsed, 3),
        steps_per_sec=round(num_steps / elapsed, 1),
        elem_updates_per_sec=round(
            num_steps / elapsed * len(prob.mesh.tetra), 1
        ),
        n_parts=sp.n_parts,
        fint_mode=sp.fint_mode,
        exchange_mode=cfg.solver.exchange_mode,
        save_every=save_every,
        dt=prob.dt,
        device=str(ctx.device),
    )
    for r in range(sp.n_parts):
        save_displacement(store.dynamics_h5(r), rank_trajectory(ctx, traj, r))
    return ctx
