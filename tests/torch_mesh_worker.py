"""One rank of a gloo device mesh on the CPU, for tests/test_torch_mesh.py
and tests/test_torch_mesh_pipeline.py:

    python tests/torch_mesh_worker.py SPEC.json OUT_DIR RANK WORLD INIT

joins the process group at ``INIT`` (a ``file://`` URL, so concurrent
test processes never share a port), runs every case SPEC.json lists
(tests/torch_mesh_cases.py) over a one-dimensional mesh of the WORLD
ranks, and on rank 0 writes each case's outputs to OUT_DIR/<case>.npz. A
case that raises writes OUT_DIR/<case>.r<RANK>.err with the traceback
and the worker exits 1 at the end. Imports torch and savtpu_torch only."""

import json
import sys
import traceback
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

import torch_mesh_cases as cases  # noqa: E402
from savtpu_torch.parallel import make_device_mesh  # noqa: E402


def main(spec_path, out_dir, rank, world, init):
    spec = json.loads(Path(spec_path).read_text())
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))
    mesh = make_device_mesh(device_type="cpu")
    jobs = [(n, lambda n=n: cases.solver_case(n, mesh))
            for n in spec["solver"]]
    jobs += [(n, lambda n=n: {"message": np.asarray(
        cases.refused_case(n, mesh))}) for n in spec["refused"]]
    jobs += [(cases.fit_name(a, world), lambda a=a: cases.fit_case(mesh, a))
             for a in spec.get("fit", ())]
    if spec.get("gates"):
        jobs.append(("gates", lambda: cases.gates_case(mesh)))
    jobs += [(n, lambda k=k, c=c: cases.pipeline_case(k, c, mesh))
             for n, k, c in spec["pipeline"]]
    failed = False
    for name, job in jobs:
        try:
            res = job()
        except Exception:
            failed = True
            (out / f"{name}.r{rank}.err").write_text(traceback.format_exc())
            continue
        if rank == 0:
            np.savez(out / f"{name}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(main(a[0], a[1], int(a[2]), int(a[3]), a[4]))
