"""The port's device mesh on every card of one machine, against the
emulated runs.

    python3 scripts/mesh_cards.py [--out DIR] [--path-only]

On a machine with N >= 2 NVIDIA GPUs. First one NCCL rank a card (N
ranks, spawned): one 16 KB all-reduce timed eagerly and replayed from a
captured CUDA graph (1,000 each), then, for each case, the mesh run
(``ShardedSolver(sp, mesh)``: the eager loop for the exchanged runs,
then the graph-replayed stepper) against the emulated run of the same
problem on the rank's card: the psum exchange at 2 parts a rank (dense),
the permute and grid exchanges at one part a rank (dense; stencil,
compensated), and the banded compensated run with K3 in its comm-free
block (float32, 2 parts a rank). Each rank writes a log with its
progress and, every 40 s, its Python stacks under DIR (default: a new
temporary directory, printed). Then chip_smoke.py's mesh path (``run_mesh_path``) over
the cards: the slice's stages 1 and 4 against an emulated slice run
made here, and the default configuration's pallas stage 1. Prints one
JSON line per part and writes DIR/mesh_cards.json. ``--path-only``
runs the mesh path alone, each rank of it limited to 90 s (after which
it prints its stacks and exits), and the parent prints its stacks to
DIR/mesh_cards_parent.log every 60 s.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def rank_main(rank, world, init, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    log_f = open(Path(out_dir) / f"mesh_cards_rank{rank}.log", "w")
    faulthandler.dump_traceback_later(40, repeat=True, file=log_f)

    def log(*a):
        print(f"[{time.strftime('%H:%M:%S')}]", *a, file=log_f, flush=True)

    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=60),
                            device_id=torch.device("cuda", rank))
    import torch_mesh_cases as c
    from savtpu_torch.ops.online_banded import online_chunk
    from savtpu_torch.parallel import ShardedSolver, make_device_mesh

    mesh = make_device_mesh()
    dev = torch.device("cuda", rank)
    res = {"world": world}
    t = torch.ones(4096, device=dev)
    for _ in range(10):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    res["all_reduce_16KB_us_eager"] = (time.perf_counter() - t0) * 1e3
    g, s = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        dist.all_reduce(t)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(100):
            dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        g.replay()
    torch.cuda.synchronize()
    res["all_reduce_16KB_us_graph"] = (time.perf_counter() - t0) * 1e3
    del g
    log("all-reduce", res)
    cases = (
        ("psum_dense", c._beam((16, 2, 2), (16.0, 2.0, 2.0), 2 * world,
                               fint_mode="dense"),
         [c._run(400, save_every=5)]),
        ("permute_dense", c._beam((16, 2, 2), (16.0, 2.0, 2.0), world,
                                  fint_mode="dense", exchange_mode="permute"),
         [c._run(400, save_every=5)]),
        ("grid_stencil", c._beam((8, 4, 4), (8.0, 4.0, 4.0), world, "box",
                                 fint_mode="stencil", exchange_mode="grid",
                                 compensated=True),
         [c._run(400, save_every=5)]),
        ("banded_f32_k3", c._beam((24, 2, 2), (6.0, 1.0, 1.0), 2 * world,
                                  fint_mode="banded", compensated=True),
         [c._run(300, save_every=5),
          c._run(300, sync=False, preds=c.SIN, save_every=5)]),
    )
    solver = None
    for name, spec, runs in cases:
        for mode in ("eager", "graph"):
            outs = {}
            online_chunk.launches = 0
            for key, m in (("emulated", None), ("mesh", mesh)):
                prob, sp = c.build_problem(
                    spec, device=dev if m is None else "cpu")
                solver = ShardedSolver(sp, m)
                lsp = solver.sp
                d0, dn = lsp.localize(prob.d0), lsp.localize(prob.dn)
                smask = sp.smask.cpu().numpy()
                o = {}
                for i, run in enumerate(runs):
                    preds = None
                    if run["preds"] == c.SIN:
                        preds = solver.block(torch.as_tensor(
                            c.sin_preds(smask, run["steps"])).to(
                                lsp.dtype).to(lsp.device))
                    if mode == "eager" and run["sync"]:
                        (traj, _), _ = lsp._stacked_run_eager(
                            d0, dn, torch.zeros((), dtype=lsp.dtype,
                                                device=dev),
                            run["steps"], sync=True, preds=None,
                            record=run["record"],
                            save_every=run["save_every"])
                    else:
                        (traj, _), _ = solver.run(
                            d0, dn, 0.0, run["steps"], sync=run["sync"],
                            preds=preds, record=run["record"],
                            save_every=run["save_every"])
                    o[f"{i}_traj"] = solver.gather(traj).cpu().numpy()
                outs[key] = o
            res[f"{name}_{mode}"] = {
                k: {"equal": bool(np.array_equal(outs["emulated"][k],
                                                 outs["mesh"][k])),
                    "rel": float(np.linalg.norm(outs["emulated"][k]
                                                - outs["mesh"][k])
                                 / max(np.linalg.norm(outs["emulated"][k]),
                                       1e-300))}
                for k in outs["emulated"]}
            res[f"{name}_{mode}_k3_launches"] = online_chunk.launches
            res[f"{name}_parts"] = list(solver.parts)
            log(name, mode, res[f"{name}_{mode}"])
    if rank == 0:
        (Path(out_dir) / "mesh_cards_solver.json").write_text(
            json.dumps(res))
    # the captured graphs hold NCCL work that the communicator waits for
    # when it is destroyed: free them first
    solver = lsp = sp = None
    gc.collect()
    torch.cuda.synchronize()
    log("destroying the process group")
    dist.destroy_process_group()
    log("done")
    faulthandler.cancel_dump_traceback_later()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--path-only", action="store_true")
    args = ap.parse_args(argv)
    import subprocess

    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from savtpu_torch.ops import kernels

    world = torch.cuda.device_count()
    if world < 2:
        print("mesh_cards: needs two or more cards", file=sys.stderr)
        return 2
    if args.out is None:
        args.out = Path(tempfile.mkdtemp(prefix="savtpu_torch_mesh_out_"))
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps({"cards": smi, "torch": torch.__version__,
                      "out": str(args.out)}), flush=True)
    kernels.build_all(["online_banded", "dense_step", "banded_scan"])
    solver, limit_s = None, cs.MESH_RANK_LIMIT_S
    if args.path_only:
        limit_s = 90
        faulthandler.dump_traceback_later(
            60, repeat=True, file=open(args.out / "mesh_cards_parent.log",
                                       "w"))
    else:
        t0 = time.perf_counter()
        mp.start_processes(rank_main, args=(world, f"file://{args.out}/pg_"
                                            f"{time.time_ns()}",
                                            str(args.out)),
                           nprocs=world, join=True, start_method="spawn")
        solver = json.loads(
            (args.out / "mesh_cards_solver.json").read_text())
        solver["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps({"solver": solver}), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="savtpu_torch_mesh_cards_"))
    dev = torch.device("cuda")
    try:
        cfg = cs.slice_config(tmp / "slice", cs.STEPS)
        sim, _, times = cs.run_stages(cfg, dev)
        del sim
        paths = cs.run_mesh_path(tmp, dev, cs.STEPS, "float32", times,
                                 limit_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"mesh_path": paths}), flush=True)
    (args.out / "mesh_cards.json").write_text(json.dumps(
        {"cards": smi, "solver": solver, "mesh_path": paths}))
    failed = [n for n, r in paths.items() if r["failures"]]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
