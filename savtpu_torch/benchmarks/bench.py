"""Headline benchmark of the port (counterpart of the JAX package's root
``bench.py``): explicit timesteps/s of the sync-avoiding (comm-free)
stepper on the default problem, with the NumPy/SciPy reference loop as
the baseline and a scale row at 96x8x8 in 16 parts.

    python -m savtpu_torch.benchmarks.bench [--device cpu] [--details PATH]

It runs on CUDA unless ``--device`` asks for another device, and raises
when CUDA is asked for and absent. The last line it prints is the JAX
package's JSON line, with the same six keys. The details (the JAX
package's keys, plus every rep's rate, each leg's untimed first run and
its kernel launches) are written only to ``--details``; without it
nothing is written.

The problem (``headline_problem``), as in the JAX package: the reference
repository's mesh (``REF_MESH``, 110 nodes / 256 tets) where it exists,
else ``Config()``'s generated 25x1x1 beam (104 nodes / 150 tets), in 2
RCB parts, assembled in float64 and stepped in float32; the details'
``problem`` names the mesh that ran. Each leg runs
``ShardedSolver.run`` from a zero state with ``record="none"``: one
untimed run, which pays the kernel build and the CUDA-graph capture, then
``REPS`` timed runs of ``N_STEPS`` steps, each between two device
synchronisations; the leg reports its best rate. The legs: comm-free
``dense`` (``torch.bmm`` steps replayed from CUDA graphs) and comm-free
``pallas`` (K2, ``ops/dense_step.scan_comm_free``, one launch a run; the
leg raises if K2 did not launch once a run on a card), then the exchanged
``dense`` run. ``vs_baseline`` divides the headline by the rate of the
reference's per-rank hot loop (SciPy CSR matvec and vector algebra,
without the exchange) timed on the host, best of 3.

The scale row (``_scale_row``): the 96x8x8 beam (36,864 tets) in 16
parts, float32 compensated, comm-free, ``record="none"``, best of 2 runs
of 4,000 steps, ``banded`` on an RCB partition and ``stencil`` on a box
partition. No hand-written kernel serves it: K4 refuses compensated runs
and K3 needs predictions, so both legs step the graph-replayed generic
loop, as the JAX package's steps its XLA scan. Each leg gets a roofline
row (``utils/roofline.py``: the bytes a step re-reads and the analytic
flops, as shares of the card's peaks).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..mesh import dirichlet_nodes, read_vtk
from ..parallel import (
    ShardedProblem,
    ShardedSolver,
    build_partition_maps,
    partition_elements,
)
from ..solvers import setup_problem
from ..utils import resolve_device, synchronize
from ..utils import roofline as rl
from . import REF_MESH
from .sweep import KERNELS, device_info

N_STEPS = 30_000
REPS = 2
BASELINE_STEPS = 2000
BASELINE_REPS = 3
SCALE_STEPS = 4000
SCALE_CELLS = (96, 8, 8)
SCALE_PARTS = 16


class RankOperator(NamedTuple):
    """One rank of the reference loop: its local stiffness (SciPy CSR),
    its slices of the unramped load and the lumped mass as columns, its
    clamped local DOFs, and the global DOF of each local row."""

    K: object
    F_pre: np.ndarray
    lM: np.ndarray
    dirichlet: np.ndarray
    gdofs: np.ndarray


def baseline_operators(prob, maps) -> List[RankOperator]:
    """Each rank's operators of the reference loop: K_loc assembled from
    the element matrices by a Python loop over the rank's elements, as the
    reference does (host work, kept out of any timing)."""
    import scipy.sparse as sp_sparse

    cells = prob.mesh.tetra
    Ke = prob.Ke.cpu().numpy()
    F_pre = prob.F_pre.cpu().numpy()
    lumped = prob.lumped_M.cpu().numpy()
    ops = []
    for p in range(maps.n_parts):
        nodes = maps.local_nodes[p]
        gdofs = (3 * nodes[:, None] + np.arange(3)).reshape(-1)
        lookup = {int(g): i for i, g in enumerate(nodes)}
        K_loc = np.zeros((3 * len(nodes), 3 * len(nodes)))
        for e in maps.local_elements[p]:
            loc = np.array([lookup[int(n)] for n in cells[e]])
            ed = (3 * loc[:, None] + np.arange(3)).reshape(-1)
            K_loc[np.ix_(ed, ed)] += Ke[e]
        ops.append(RankOperator(
            sp_sparse.csr_matrix(K_loc), F_pre[gdofs].reshape(-1, 1),
            lumped[gdofs].reshape(-1, 1), maps.local_dirichlet[p], gdofs))
    return ops


def baseline_run(ops, n_steps: int, dt: float, alpha: float):
    """``n_steps`` steps of the reference's per-rank hot loop from rest
    (Tools/Dynamic_solver.py:9-34 at MODEL=True, without MPI: no
    exchange). Returns each rank's (d, d_prev) columns."""
    states = [(np.zeros_like(op.F_pre), np.zeros_like(op.F_pre))
              for op in ops]
    tn = 0.0
    for _ in range(n_steps):
        ramp = min(tn, 1.0)
        for p, (K, F_pre, lM, dirich, _) in enumerate(ops):
            d0, dn = states[p]
            F_int = K.dot(d0)
            F_ext = F_pre * ramp
            d1 = (
                dt * dt * (F_ext - F_int)
                + 2 * lM * d0
                - lM * dn
                + 0.5 * dt * alpha * lM * dn
            ) / (lM + 0.5 * alpha * dt * lM)
            d1[dirich] = 0.0
            states[p] = (d1, d0)
        tn += dt
    return states


def _numpy_baseline_steps_per_sec(prob, maps, n_steps=BASELINE_STEPS,
                                  reps=BASELINE_REPS):
    """The reference loop's steps/s on the host: best of ``reps`` runs of
    ``n_steps`` (the JAX package takes the best of 3: one host timing
    moved 2.3x from one run to another). Returns (best, every rep's
    rate)."""
    ops = baseline_operators(prob, maps)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        baseline_run(ops, n_steps, prob.dt, prob.alpha)
        rates.append(n_steps / (time.perf_counter() - t0))
    return max(rates), rates


def _roofline_row(sp, steps_per_sec):
    """The roofline fields of a leg: the analytic flops a step and the
    bytes a step must move, as achieved GB/s and GFLOP/s and their shares
    of the card's peaks (none on the CPU)."""
    floor = rl.bytes_floor_per_step(sp)
    fl = rl.flops_model(sp)
    row = rl.roofline(
        steps_per_sec,
        bytes_per_step=floor["bytes_per_step_floor"],
        flops_per_step=fl["flops_per_step"],
        device=sp.device,
    )
    row["bytes_model"] = floor
    row["flops_model"] = fl
    return row


def _launches() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def _timed_leg(sp, ndof, n_steps, reps, sync, dev):
    """One untimed run (the kernel build, the graph capture), then
    ``reps`` timed runs from a zero state with no recording. Returns the
    leg's record: best and every rep's steps/s, the untimed run's seconds
    and the kernel launches of all its runs."""
    solver = ShardedSolver(sp)
    d0 = sp.localize(np.zeros(ndof, np.float32))
    before = _launches()
    synchronize(dev)
    t0 = time.perf_counter()
    solver.run(d0, d0, 0.0, n_steps, sync=sync, record="none")
    synchronize(dev)
    untimed = time.perf_counter() - t0
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        (_, _), carry = solver.run(d0, d0, 0.0, n_steps, sync=sync,
                                   record="none")
        synchronize(dev)
        rates.append(n_steps / (time.perf_counter() - t0))
        if not all(bool(c.isfinite().all()) for c in carry[:2]):
            raise FloatingPointError(
                f"{sp.fint_mode} run (sync={sync}) ended in a non-finite "
                "state")
    after = _launches()
    launches = {k: after[k] - before[k] for k in after}
    if (dev.type == "cuda" and sp.fint_mode == "pallas" and not sync
            and launches["scan_comm_free"] != 1 + reps):
        raise RuntimeError(
            f"the pallas leg launched K2 {launches['scan_comm_free']} "
            f"times, expected one a run ({1 + reps})")
    return {"steps_per_sec": max(rates), "rep_steps_per_sec": rates,
            "untimed_run_s": untimed, "kernel_launches": launches}


def _scale_row(n_steps=SCALE_STEPS, *, cells=SCALE_CELLS,
               n_parts=SCALE_PARTS, device=None, reps=REPS):
    """Comm-free steps/s at ``cells`` (the beam of length nx/ny) in
    ``n_parts`` parts, float32 compensated: ``banded`` on an RCB partition
    and ``stencil`` on a box partition; the faster is the row's rate."""
    dev = resolve_device(device)
    nx, ny, nz = cells
    cfg = Config()
    cfg.beam_cells = (nx, ny, nz)
    cfg.beam_extent = (float(nx) / ny, 1.0, 1.0)
    prob = setup_problem(cfg, dtype=torch.float32)
    mesh = prob.mesh
    dnodes = dirichlet_nodes(mesh.triangles, mesh.points)

    legs = {}
    for fint_mode, pmethod in (("banded", "rcb"), ("stencil", "box")):
        epart = partition_elements(mesh.tetra, mesh.points, n_parts,
                                   pmethod)
        maps = build_partition_maps(mesh.tetra, epart, mesh.num_points,
                                    dnodes)
        sp = ShardedProblem.build(prob, maps, fint_mode=fint_mode,
                                  dtype=torch.float32, compensated=True,
                                  device=dev)
        leg = _timed_leg(sp, prob.ndof, n_steps, reps, False, dev)
        leg["roofline"] = _roofline_row(sp, leg["steps_per_sec"])
        legs[fint_mode] = leg

    by_mode = {m: leg["steps_per_sec"] for m, leg in legs.items()}
    mode = max(by_mode, key=by_mode.get)
    best = by_mode[mode]
    n_elem = len(mesh.tetra)
    return {
        "mesh": f"{nx}x{ny}x{nz}",
        "elements": n_elem,
        "n_parts": n_parts,
        "fint_mode": mode,
        "by_mode": by_mode,
        "compensated": True,
        "sync_avoiding_steps_per_sec": best,
        "element_updates_per_sec": best * n_elem,
        "roofline": {m: leg["roofline"] for m, leg in legs.items()},
        "steps": n_steps,
        "rep_steps_per_sec": {m: leg["rep_steps_per_sec"]
                              for m, leg in legs.items()},
        "untimed_run_s": {m: leg["untimed_run_s"] for m, leg in legs.items()},
        "kernel_launches": {m: leg["kernel_launches"]
                            for m, leg in legs.items()},
    }


def headline_problem():
    """(AssembledProblem in float64, element parts, PartitionMaps, the
    ``problem`` label) of the headline: ``REF_MESH`` where it exists,
    else ``Config()``'s generated beam, in 2 RCB parts."""
    cfg = Config()
    ref = read_vtk(REF_MESH) if REF_MESH.exists() else None
    prob = setup_problem(cfg, mesh=ref, dtype=torch.float64)
    mesh = prob.mesh
    epart = partition_elements(mesh.tetra, mesh.points, 2, method="rcb")
    dnodes = dirichlet_nodes(mesh.triangles, mesh.points)
    maps = build_partition_maps(mesh.tetra, epart, mesh.num_points, dnodes)
    what = (f"reference mesh {REF_MESH.name}" if ref is not None
            else "generated {}x{}x{}".format(*cfg.beam_cells))
    problem = (f"cantilever beam, {what}, {mesh.num_points} nodes / "
               f"{len(mesh.tetra)} tets, 2 shards")
    return prob, epart, maps, problem


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--details", type=Path, default=None,
                    help="the JSON file to write the details to (none "
                         "written without it)")
    ap.add_argument("--steps", type=int, default=N_STEPS,
                    help="steps of each headline run")
    ap.add_argument("--scale-steps", type=int, default=SCALE_STEPS,
                    help="steps of each scale-row run")
    ap.add_argument("--scale-cells", type=int, nargs=3,
                    default=list(SCALE_CELLS), metavar=("NX", "NY", "NZ"),
                    help="the scale row's beam cells")
    ap.add_argument("--scale-parts", type=int, default=SCALE_PARTS,
                    help="the scale row's part count")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    prob, _, maps, problem = headline_problem()
    mesh = prob.mesh

    legs, rooflines = {}, {}

    def timed(fint_mode, sync):
        sp = ShardedProblem.build(prob, maps, fint_mode=fint_mode,
                                  dtype=torch.float32, device=dev)
        key = f"{fint_mode}_{'exch' if sync else 'avoid'}"
        legs[key] = _timed_leg(sp, prob.ndof, args.steps, REPS, sync, dev)
        rooflines[key] = _roofline_row(sp, legs[key]["steps_per_sec"])
        return legs[key]["steps_per_sec"]

    avoid_by_mode = {mode: timed(mode, sync=False)
                     for mode in ("dense", "pallas")}
    avoid_mode = max(avoid_by_mode, key=avoid_by_mode.get)
    avoid_sps = avoid_by_mode[avoid_mode]
    exch_sps = timed("dense", sync=True)
    base_sps, base_reps = _numpy_baseline_steps_per_sec(prob, maps)

    scale = _scale_row(args.scale_steps, cells=tuple(args.scale_cells),
                       n_parts=args.scale_parts, device=dev)

    n_elem = len(mesh.tetra)
    details = {
        "problem": problem,
        "device": device_info(dev),
        "sync_avoiding_steps_per_sec": avoid_sps,
        "sync_avoiding_mode": avoid_mode,
        "sync_avoiding_by_mode": avoid_by_mode,
        "exchanged_steps_per_sec": exch_sps,
        "numpy_reference_loop_steps_per_sec": base_sps,
        "numpy_reference_timing": (f"best of {BASELINE_REPS} in-process "
                                   "reps"),
        "sync_avoid_over_exchanged": avoid_sps / exch_sps,
        "element_updates_per_sec": avoid_sps * n_elem,
        "speedup_vs_numpy_reference": avoid_sps / base_sps,
        "roofline_toy": rooflines,
        "scale_96x8x8_16shards": scale,
        "steps": args.steps,
        "reps": REPS,
        "rep_steps_per_sec": {k: leg["rep_steps_per_sec"]
                              for k, leg in legs.items()},
        "untimed_run_s": {k: leg["untimed_run_s"] for k, leg in legs.items()},
        "kernel_launches": {k: leg["kernel_launches"]
                            for k, leg in legs.items()},
        "numpy_reference_steps": BASELINE_STEPS,
        "numpy_reference_rep_steps_per_sec": base_reps,
    }
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(details, indent=2))

    print(
        json.dumps(
            {
                "metric": "sync_avoiding_timesteps_per_sec",
                "value": round(avoid_sps, 1),
                "unit": "steps/s",
                "vs_baseline": round(avoid_sps / base_sps, 2),
                "scale_96x8x8_16shards_steps_per_sec": round(
                    scale["sync_avoiding_steps_per_sec"], 1
                ),
                "scale_96x8x8_16shards_elem_updates_per_sec": round(
                    scale["element_updates_per_sec"], 1
                ),
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
