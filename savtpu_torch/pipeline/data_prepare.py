"""Stage 1: the exchanged explicit solve that produces the training data
(port of ``savtpu/pipeline/data_prepare.py``): partition labels, the
steady solve written to VTK, and the full exchanged run saved as per-rank
displacement histories. With ``solver.deg = 2`` (P2 tets) the stage is
the JAX package's steady-only path: the steady VTK and no dynamic run.

    python -m savtpu_torch.pipeline.data_prepare [--config cfg.json]
        [--steps N] [--parts P] [--ckpt-every N] [--[no-]resume]
        [--device cpu]

With ``solver.ckpt_every`` (``--ckpt-every``) the run persists its carry
and recorded rows every that many steps under the store's
``Checkpoints/stage1``; a killed run called again resumes there (unless
``--no-resume``) and gives the same bits. The checkpoint is dropped once
the artifacts are complete. Runs on CUDA unless ``--device`` says
otherwise. Under a device mesh (a context from ``build_context(...,
device_mesh=...)``, on every rank) each rank runs its block of parts and
writes their displacement histories; rank 0 writes the labels, the steady
solve and the log."""

from __future__ import annotations

import argparse
import shutil
import time

from ..config import Config
from ..io.artifacts import ArtifactStore, save_displacement
from ..mesh import write_vtk
from ..solvers.problem import setup_problem
from ..solvers.steady import steady_displacement
from ..utils import resolve_device, stage_log, synchronize
from ..utils.checkpoint import run_streamed_ckpt
from .common import (
    StageContext,
    build_context,
    rank_trajectory,
    save_partition_labels,
)


def write_steady(cfg: Config, prob, store: ArtifactStore, device) -> dict:
    """The steady displacement under the unramped load, written to the
    store's steady VTK; returns the solve's route record."""
    info = {}
    t0 = time.perf_counter()
    d_steady = steady_displacement(prob, device=device, info=info)
    write_vtk(
        store.steady_vtk(),
        prob.mesh,
        point_data={
            "displacement-x": d_steady[0::3],
            "displacement-y": d_steady[1::3],
            "displacement-z": d_steady[2::3],
        },
    )
    info["seconds"] = round(time.perf_counter() - t0, 3)
    stage_log(cfg).log("steady_solve", ndof=prob.ndof, deg=prob.deg,
                       device=str(device), **info)
    return info


def run(cfg: Config, ctx: StageContext | None = None, verbose: bool = True,
        device=None, resume: bool = True):
    if cfg.solver.deg == 2:
        # the steady-only P2 path: solve, write the steady VTK, no
        # dynamic stage
        dev = resolve_device(device)
        prob = setup_problem(cfg)
        store = ArtifactStore(cfg.workdir, cfg.model_dir,
                              cfg.surrogate.run_tag())
        info = write_steady(cfg, prob, store, dev)
        if verbose:
            print(f"[data_prepare] deg=2 steady-only solve ({prob.ndof} "
                  f"DOFs, {info['route']}) -> {store.steady_vtk()}")
        return prob

    if ctx is None:
        ctx = build_context(cfg, device=device)
    prob, sp, solver, store = ctx.prob, ctx.sp, ctx.solver, ctx.store

    save_partition_labels(ctx)
    if ctx.is_root:
        write_steady(cfg, prob, store, ctx.device)
    verbose = verbose and ctx.is_root

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
    ckpt_every = cfg.solver.ckpt_every
    if ckpt_every:
        (traj, _), _ = run_streamed_ckpt(
            solver, d0, dn, 0.0, num_steps, sync=True, record="traj",
            save_every=save_every, ckpt_dir=store.ckpt_dir("stage1"),
            ckpt_every=ckpt_every, resume=resume, verbose=verbose,
        )
    else:
        (traj, _), _ = solver.run_streamed(
            d0, dn, 0.0, num_steps, sync=True, record="traj",
            save_every=save_every,
        )
    synchronize(ctx.device)
    elapsed = time.perf_counter() - t_start
    if verbose:
        print(f"[data_prepare] {num_steps} steps in {elapsed:.2f}s "
              f"({num_steps / elapsed:.0f} steps/s)")
    mesh_info = {}
    if ctx.comm is not None:
        mesh_info = dict(world=ctx.comm.world,
                         rank_seconds=ctx.rank_values(round(elapsed, 3)))
    ctx.log(
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
        **mesh_info,
    )
    for r in ctx.parts:
        save_displacement(store.dynamics_h5(r), rank_trajectory(ctx, traj, r))
    if ckpt_every:
        # the artifacts are complete: drop the mid-run checkpoint
        del traj
        ctx.barrier()
        if ctx.is_root:
            shutil.rmtree(store.ckpt_dir("stage1"), ignore_errors=True)
    return ctx


def main(argv=None):
    ap = argparse.ArgumentParser(description="savtpu_torch stage 1: data "
                                             "prepare")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--parts", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint the carry + trajectory every N steps")
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="resume from an existing stage-1 checkpoint "
                         "(--no-resume starts fresh)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.steps:
        cfg.solver.num_steps = args.steps
    if args.parts:
        cfg.partition.n_parts = args.parts
    if args.ckpt_every is not None:
        cfg.solver.ckpt_every = args.ckpt_every
    run(cfg, device=args.device, resume=args.resume)


if __name__ == "__main__":
    main()
