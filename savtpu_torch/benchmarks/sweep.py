"""Scale-out throughput sweep of the port (counterpart of the JAX
package's ``benchmarks/sweep.py``).

Measures explicit timesteps/s and element updates/s across mesh
refinements x part counts x F_int modes, sync-avoiding (comm-free) and
exchanged, from a zero state with ``record="none"``, on one device:

    python -m savtpu_torch.benchmarks.sweep [--quick] [--only S] \\
        --out PATH [--device cpu]

It runs on CUDA unless ``--device`` asks for another device, and raises
when CUDA is asked for and absent. It writes one JSON file, ``--out``
(``{"device": ..., "results": [...], "skipped": [...]}``), prints one JSON
line per case and a markdown table. ``CASES`` and ``QUICK`` are the JAX
package's. Cases that need what the port does not have yet are listed
under ``skipped`` with the reason; a case the port supports that fails is
recorded with its error, and the process then exits with 1.

Which kernels a case runs: ``pallas`` steps through K1 (one launch per
step) when exchanged and K2 (one launch per run) when comm-free;
``banded`` comm-free runs K4 (one launch per run); ``dense`` uses
``torch.bmm``. Each row counts the launches of its case.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..mesh import dirichlet_nodes
from ..ops import banded_scan, dense_step
from ..parallel import (
    ShardedProblem,
    ShardedSolver,
    build_partition_maps,
    partition_elements,
)
from ..solvers import setup_problem
from ..utils import resolve_device, synchronize

CASES = [
    # (nx, ny, nz, parts, mode, steps)
    ("ref", 0, 0, 2, "dense", 20000),  # the reference's own 256-tet VTK
    ("ref", 0, 0, 2, "pallas", 20000),
    (25, 1, 1, 2, "dense", 20000),     # generated 25x1x1 beam (150 tets)
    (25, 1, 1, 2, "pallas", 20000),    # whole-scan kernel, K on chip
    (48, 4, 4, 8, "dense", 5000),
    (48, 4, 4, 8, "pallas", 5000),
    (96, 8, 8, 8, "dense", 2000),
    (96, 8, 8, 8, "banded", 2000),
    (96, 8, 8, 8, "pallas", 2000),
    (96, 8, 8, 16, "banded", 2000),   # the accuracy-study deployment config

    (96, 8, 8, 64, "dense", 2000),
    (96, 8, 8, 64, "ell", 2000),
    (192, 12, 12, 64, "banded", 1000),
    (192, 12, 12, 256, "dense", 1000),
    (384, 16, 16, 256, "banded", 3000),  # 590k tets on one device
    # exchanged-path halo variants (psum vs neighbor-packed permute)
    (48, 4, 4, 8, "dense", 5000, "permute"),
    (96, 8, 8, 64, "dense", 2000, "permute"),
    (192, 12, 12, 64, "banded", 1000, "permute"),
    (384, 16, 16, 256, "banded", 2000, "permute"),
    # compensated (double-word f32) overhead check at two scales
    (48, 4, 4, 8, "dense", 5000, "psum", True),
    (192, 12, 12, 64, "banded", 1000, "psum", True),
    # Neo-Hookean matrix-free stepping (per-step force recompute)
    (48, 4, 4, 8, "auto", 2000, "psum", False, True),
]

QUICK = [(25, 1, 1, 2, "dense", 5000), (48, 4, 4, 8, "ell", 2000)]

# the kernels a case may launch, by the name its row reports them under
KERNELS = {
    "fint_matvec": dense_step.batched_fint_matvec,
    "scan_comm_free": dense_step.scan_comm_free,
    "scan_comm_free_banded": banded_scan.scan_comm_free_banded,
}


def case_tag(case) -> tuple:
    """(mesh, parts, mode, exchange, compensated) of a CASES entry."""
    mesh = ("ref_beam_256" if case[0] == "ref"
            else f"{case[0]}x{case[1]}x{case[2]}")
    exch = case[6] if len(case) > 6 else "psum"
    comp = bool(case[7]) if len(case) > 7 else False
    return (mesh, case[3], case[4], exch, comp)


def skip_reason(case) -> Optional[str]:
    """Why the port cannot run a CASES entry yet, or None."""
    mesh, _, mode, exchange, _ = case_tag(case)
    nh = bool(case[8]) if len(case) > 8 else False
    if mesh == "ref_beam_256":
        return ("needs the reference repository's Mesh_info/beam_coarse.vtk,"
                " which this repository does not hold")
    if nh:
        return "the Neo-Hookean path is not ported yet (ROADMAP A11)"
    if mode in ("ell", "ebe", "stencil"):
        return f"fint_mode {mode!r} is not ported yet (ROADMAP A12)"
    if exchange != "psum":
        return f"the {exchange!r} exchange is not ported yet (ROADMAP A12)"
    return None


def build_case(nx, ny, nz, n_parts, mode, exchange="psum",
               compensated=False, *, device, dtype=torch.float32):
    """The sweep's problem: an nx x ny x nz beam of length nx/ny, RCB
    parts, assembled in float64 and stepped in ``dtype``. Returns
    (AssembledProblem, ShardedProblem)."""
    cfg = Config()
    cfg.beam_cells = (nx, ny, nz)
    cfg.beam_extent = (float(nx) / max(ny, 1), 1.0, 1.0)
    prob = setup_problem(cfg, dtype=dtype)
    mesh = prob.mesh
    epart = partition_elements(mesh.tetra, mesh.points, n_parts, "rcb")
    dn = dirichlet_nodes(mesh.triangles, mesh.points)
    maps = build_partition_maps(mesh.tetra, epart, mesh.num_points, dn)
    sp = ShardedProblem.build(
        prob, maps, fint_mode=mode, dtype=dtype, exchange_mode=exchange,
        compensated=compensated, device=device,
    )
    return prob, sp


def bench_case(nx, ny, nz, n_parts, mode, steps, exchange="psum",
               compensated=False, nh=False, *, device=None,
               dtype=torch.float32):
    """One sweep row: build the case, then for the comm-free and the
    exchanged run, one untimed run and one timed run of ``steps`` steps
    from a zero state with ``record="none"``. The row has the JAX
    package's keys. Raises NotImplementedError for a case the port cannot
    run yet, FloatingPointError if a run ends in a non-finite state."""
    case = (nx, ny, nz, n_parts, mode, steps, exchange, compensated, nh)
    reason = skip_reason(case)
    if reason:
        raise NotImplementedError(reason)
    dev = resolve_device(device)
    prob, sp = build_case(nx, ny, nz, n_parts, mode, exchange, compensated,
                          device=dev, dtype=dtype)
    sol = ShardedSolver(sp)
    d0 = sp.localize(np.zeros(prob.ndof))

    out = {
        "mesh": case_tag(case)[0],
        "elements": len(prob.mesh.tetra),
        "ndof": prob.ndof,
        "n_parts": n_parts,
        "DL": sp.DL,
        "fint_mode": sp.fint_mode,
        "exchange_mode": exchange,
        "compensated": compensated,
        # per-step psum exchange volume: the replicated (3*|global
        # shared|,) buffer each part adds into
        "psum_volume_dofs_per_part": sp.SD,
    }
    for sync, name in ((False, "sync_avoiding"), (True, "exchanged")):
        sol.run(d0, d0, 0.0, steps, sync=sync, record="none")
        synchronize(dev)
        t0 = time.perf_counter()
        (_, _), carry = sol.run(d0, d0, 0.0, steps, sync=sync,
                                record="none")
        synchronize(dev)
        el = time.perf_counter() - t0
        if not all(bool(c.isfinite().all()) for c in carry[:2]):
            raise FloatingPointError(f"{name} run ended in a non-finite "
                                     "state")
        out[f"{name}_steps_per_sec"] = steps / el
        out[f"{name}_elem_updates_per_sec"] = steps / el * out["elements"]
    out["sync_avoid_speedup"] = (
        out["sync_avoiding_steps_per_sec"] / out["exchanged_steps_per_sec"]
    )
    return out


def device_info(dev: torch.device) -> dict:
    """The device a sweep ran on; for a card also nvidia-smi's name and
    power limit."""
    if dev.type != "cuda":
        return {"type": dev.type}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"not read ({type(e).__name__})"
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def _table(results, skipped) -> str:
    lines = ["| mesh | E | parts | mode | avoid steps/s | Melem/s "
             "| exchanged steps/s | vs exchanged |",
             "|---|---|---|---|---|---|---|---|"]
    for r in results:
        if "error" in r:
            lines.append(f"| {r['mesh']} | - | {r['n_parts']} "
                         f"| {r['fint_mode']} | ERROR | - | - | - |")
            continue
        mode = r["fint_mode"]
        if r["compensated"]:
            mode += " (compensated)"
        lines.append(
            f"| {r['mesh']} | {r['elements']} | {r['n_parts']} | {mode} "
            f"| {r['sync_avoiding_steps_per_sec']:,.0f} "
            f"| {r['sync_avoiding_elem_updates_per_sec'] / 1e6:,.1f} "
            f"| {r['exchanged_steps_per_sec']:,.0f} "
            f"| {r['sync_avoid_speedup']:.2f}x |")
    for s in skipped:
        lines.append(f"| {s['mesh']} | - | {s['n_parts']} | {s['fint_mode']}"
                     f" | skipped: {s['skipped']} | - | - | - |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the two QUICK cases only")
    ap.add_argument("--only", type=str, default=None,
                    help="substring filter on 'mesh/parts/mode' over CASES")
    ap.add_argument("--out", type=Path, required=True,
                    help="the JSON file to write")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cases = QUICK if args.quick else CASES
    if args.only:
        cases = [c for c in CASES
                 if args.only in "{}/{}/{}".format(*case_tag(c)[:3])]
        print(f"[sweep] --only '{args.only}': {len(cases)} case(s)")

    results, skipped, failed = [], [], 0
    for case in cases:
        mesh, parts, mode, exch, comp = case_tag(case)
        reason = skip_reason(case)
        if reason:
            s = {"mesh": mesh, "n_parts": parts, "fint_mode": mode,
                 "exchange_mode": exch, "compensated": comp,
                 "skipped": reason}
            skipped.append(s)
            print(json.dumps(s), flush=True)
            continue
        for fn in KERNELS.values():
            fn.launches = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            r = bench_case(*case, device=dev)
        except Exception as e:  # record the case, keep sweeping
            traceback.print_exc()
            r = {"mesh": mesh, "n_parts": parts, "fint_mode": mode,
                 "exchange_mode": exch, "compensated": comp,
                 "error": f"{type(e).__name__}: {e}"}
            failed += 1
        else:
            r["kernel_launches"] = {k: fn.launches
                                    for k, fn in KERNELS.items()}
            if dev.type == "cuda":
                r["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                    dev)
        results.append(r)
        print(json.dumps(r), flush=True)

    out = {"device": device_info(dev), "results": results,
           "skipped": skipped}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=2))
    print()
    print(_table(results, skipped))
    if failed:
        print(f"[sweep] {failed} supported case(s) failed", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
