"""Where a step of K4 (the port's banded comm-free scan) spends its time.

    python3 scripts/band_phase_profile.py [--steps 1000] [--blocks 6 16 1]

On one NVIDIA GPU. Builds an instrumented copy of
``savtpu_torch/csrc/banded_scan.cu`` (with ``common.cuh``) into
``savtpu_torch/_build/profile/``: thread 0 of the first block of the
first part adds ``clock64()`` deltas into a device array at the phase
edges of every step. The sources in ``csrc/`` are not touched, and the
instrumented library is used only here. For the sweep's 96x8x8/16 and
96x8x8/8 banded cases, float32, from a zero state, it runs the kernel
once per launch shape as ``band_plan`` plans it and as ``--blocks``
forces it, and prints one JSON line each: the step's device time from
CUDA events, and SM cycles per step of

- ``partial``: the band matvec's first half (``band_rows_partial``: the
  row products and the block's transposed-term sums, up to its last
  barrier, so the slowest warp);
- ``sync1``: the wait at the cluster barrier after it (the other blocks'
  lag behind block 0 and the barrier itself);
- ``update``: the row sums (the other blocks' transposed-term sums read
  through distributed shared memory) and the update;
- ``sync2``: the wait at the step's second cluster barrier;
- ``gather``: the operand gathered through distributed shared memory;
- ``step``: the whole step;

and ``bytes_per_cycle``: the band bytes block 0 reads from global memory
in a step (its streamed Kd rows and its Kl rows) over its ``partial``
cycles. The first line is nvidia-smi's name, power limit and SM clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

NAMES = ("step", "partial", "sync1", "update", "sync2", "gather", "steps")


def patched(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"instrumentation point not found: {old!r}")
        text = text.replace(old, new)
    return text


def build(out_dir: Path) -> Path:
    """The instrumented library, built with the port's own nvcc flags."""
    from savtpu_torch.ops import kernels

    csrc = ROOT / "savtpu_torch" / "csrc"
    out_dir.mkdir(parents=True, exist_ok=True)
    prof = ("__device__ unsigned long long g_prof[8];\n"
            "#define PROF(i, v) atomicAdd(&::savtpu::g_prof[i], "
            "(unsigned long long)(v))\n")
    common = patched((csrc / "common.cuh").read_text(), [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n" + prof)])
    (out_dir / "common.cuh").write_text(common)
    mark = "if (blockIdx.x == 0 && tid == 0) "
    scan = patched((csrc / "banded_scan.cu").read_text(), [
        ("  for (int t = 0; t < num_steps; ++t) {\n",
         "  for (int t = 0; t < num_steps; ++t) {\n"
         "    const long long s_a = clock64();\n"),
        ("                              r0, n, Bk);\n    cluster.sync();\n",
         "                              r0, n, Bk);\n"
         "    const long long s_b = clock64();\n    cluster.sync();\n"
         "    const long long s_c = clock64();\n"),
        ("      ex[par + li] = d1;\n    }\n    cluster.sync();\n",
         "      ex[par + li] = d1;\n    }\n"
         "    const long long s_d = clock64();\n    cluster.sync();\n"
         "    const long long s_e = clock64();\n"),
        ("    savtpu::gather_window(ex, par, L.R, ws, we, xw, same);\n"
         "    __syncthreads();\n",
         "    savtpu::gather_window(ex, par, L.R, ws, we, xw, same);\n"
         "    __syncthreads();\n"
         f"    {mark}{{\n"
         "      PROF(1, s_b - s_a); PROF(2, s_c - s_b); PROF(3, s_d - s_c);\n"
         "      PROF(4, s_e - s_d); PROF(5, clock64() - s_e);\n"
         "      PROF(0, clock64() - s_a); PROF(6, 1);\n    }\n"),
    ])
    scan += ('\nextern "C" int profile_read(unsigned long long* out) {\n'
             "  return (int)cudaMemcpyFromSymbol(out, savtpu::g_prof, 64);\n}"
             '\nextern "C" int profile_reset() {\n'
             "  unsigned long long z[8] = {0};\n"
             "  return (int)cudaMemcpyToSymbol(savtpu::g_prof, z, 64);\n}\n")
    (out_dir / "banded_scan.cu").write_text(scan)
    lib = out_dir / "banded_scan_profile.so"
    res = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o",
                          str(lib), str(out_dir / "banded_scan.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return lib


def block0_bytes(plan, nc, Bk, it):
    """Band bytes block 0 reads from global memory in a step: its
    streamed Kd rows and its Kl rows (chunks > 0)."""
    rows = range(0, min(plan.rows, nc * Bk))
    kd = len(rows) - min(plan.resident, len(rows))
    kl = sum(1 for i in rows if i // Bk > 0)
    return (kd + kl) * Bk * it


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--blocks", type=int, nargs="*", default=[6, 16, 1],
                    help="cluster sizes to force besides the planned one")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("band_phase_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from savtpu_torch.benchmarks.sweep import build_case
    from savtpu_torch.ops import banded_scan, kernels
    from savtpu_torch.ops.band_plan import (
        band_plan,
        cluster_table,
        forced_band_plan,
    )
    from savtpu_torch.ops.dense_step import sm_count

    lib = ctypes.CDLL(str(build(ROOT / "savtpu_torch" / "_build" /
                                "profile")))
    lib.savtpu_error_string.restype = ctypes.c_char_p
    lib.savtpu_error_string.argtypes = [ctypes.c_int]
    kernels._LOADED["banded_scan"] = lib     # this process only
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    for case in ((96, 8, 8, 16), (96, 8, 8, 8)):
        _, sp = build_case(*case, "banded", device=dev)
        P, nc, Bk, _ = sp.band_Kd.shape
        d0 = torch.zeros((P, sp.DL), dtype=sp.dtype, device=dev)
        args = (sp.band_Kd, sp.band_Kl, d0, d0, 0.0, sp.F_pre, sp.lM,
                sp.bc_mask)
        kw = dict(num_steps=opts.steps, dt=sp.dt, alpha=sp.alpha,
                  ramped=sp.ramped)
        planned = band_plan(P, nc, Bk, sp.dtype, sm_count(dev),
                            cluster_table("banded_scan", sp.dtype, dev))
        plans = [planned] + [forced_band_plan(nc, Bk, sp.dtype, b)
                             for b in opts.blocks if b != planned.blocks]
        for plan in plans:
            if plan.smem > kernels.SMEM_PER_BLOCK:   # one block too small
                continue
            banded_scan.scan_comm_free_banded(*args, plan=plan, **kw)
            torch.cuda.synchronize()
            lib.profile_reset()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            banded_scan.scan_comm_free_banded(*args, plan=plan, **kw)
            ev1.record()
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * 8)()
            lib.profile_read(raw)
            n = raw[6]
            cyc = {k: raw[i] / n for i, k in enumerate(NAMES[:-1])}
            nbytes = block0_bytes(plan, nc, Bk, d0.element_size())
            print(json.dumps({
                "case": f"{case[0]}x{case[1]}x{case[2]}/{case[3]}",
                "plan": vars(plan), "planned": plan == planned,
                "us_per_step": ev0.elapsed_time(ev1) * 1e3 / opts.steps,
                "cycles_per_step": cyc,
                "bytes_per_cycle": nbytes / cyc["partial"],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
