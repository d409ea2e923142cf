#!/usr/bin/env python3
"""Drive savtpu_torch's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--steps N] [--dtype float32|float64]
                          [--lstm-epochs E]

``--steps`` sets the slice's depth (default 9,000; 100,000 is the
published schedule); ``--dtype`` its state dtype in phase 3 (default
float32, as published; float64, also compensated so that it runs the
same kernel, separates round-off from the rest). ``--lstm-epochs`` sets
the default configuration's training depth (default 1,500, cut from the
published 3,450 to keep the script within about 450 s).

Phases, each reported with its seconds and the running total against a
600 s budget:

0. device: name, count, and nvidia-smi's name and power limit;
1. build: every CUDA kernel of the paths below, one nvcc per source, all
   at once, with the ptxas register / shared-memory / spill report;
2. each kernel against its plain PyTorch version, on inputs made from a
   seed: the online kernel (K3) at the slice's shapes as band_plan plans
   it, bit for bit with the band zeroed, within its tolerance with the
   band, and a control that drops the compensation, which the first check
   must reject; then K3 in every launch shape the plan can take (one
   block per part, clusters of 3, 8, 12 and 16 blocks with resident rows,
   5 blocks all streamed; sizes the card cannot co-schedule left out),
   forced, over 300 steps; K1, K2 (with and without predictions, shared
   rows recorded) and K4 at the shapes of the sweep cases that run them,
   K2 also at 25x1x1/2 and in every launch shape its plan can take
   (forced at 48x4x4/8 and 8x1x1/2), K4 also at 96x8x8/8 and in every
   launch shape forced at 96x8x8/16, K2 and K4 bit for bit with the
   operator zeroed, each within its tolerance with the operator, and each
   with a control that the same comparison must reject; then the
   graph-replayed stepper against the eager loop, bit for bit, with a
   control that drops the load ramp; the cluster table
   (cudaOccupancyMaxActiveClusters) and the plans are printed; then the
   LSTM surrogate at the default run's shapes: predict on the card
   against the CPU (float64 within 1e-12, float32 within 1e-5, with a
   TF32 control the float32 check must reject), stage 3 switching TF32
   off itself, one float64 training epoch card against CPU (1e-10), and
   graph-replayed epochs against eager ones, bit for bit;
3. the paths: the slice, the five-stage pipeline (96x8x8 beam, 16 RCB
   parts, float32 compensated, banded, expfit modal-8 surrogate, 9,000
   steps) through ``api.Simulation(cfg).run_all``'s stages, with the K3
   launch count of that run, the rel-L2 of the sync-avoiding run against
   the exchanged one, and a small run on the GPU held against the same
   run on the CPU; then the scale-out sweep's cases that run K1, K2 and
   K4 (48x4x4/8 and 96x8x8/8 pallas, 96x8x8/16 and 96x8x8/8 banded)
   through ``savtpu_torch.benchmarks.sweep.bench_case`` with the sweep's
   step counts, each case's launch counts, steps/s and device memory
   peak, and tiny sweep problems on the GPU held against the CPU; then
   the default ``Config()`` (25x1x1 beam, 2 parts, dense, float64, the
   stacked LSTM surrogate) through the same stages at its 100,000
   steps, the training cut to ``--lstm-epochs``: stage seconds, epochs/s
   and Adam steps/s, the rel-L2, the warm-up rows equal to stage 1's bit
   for bit; and its stage 4 again from a copy in fint_mode "pallas",
   where K1 must launch once a step and the result stay within 1e-5 of
   the dense run;
4. kernel timing with CUDA events: kernel, plain version, bound (and for
   K2, K3 and K4 the floor of re-reading the operator from HBM every
   step), the plan K3 and K4 ran with, the PyTorch call that computes
   the same function where there is one (K1: torch.bmm, both as device
   time from 100 calls replayed in one CUDA graph, and as eager issue
   time), peak device memory; and a torch.profiler look at the
   graph-replayed exchanged stepper (device busy share, longest
   kernels); stage 3's training epoch eager and graph-replayed, the
   replayed epoch's busy share and kernel count, and one stage-4 block's
   LSTM prediction.

``--keep-traces DIR`` saves the slice's departing and median ranks'
stage-2 traces for ``scripts/c2_refit_witness.py``.

The last line is {"ok": true, "device": {...}}; the line before it is
nvidia-smi's, and before that a {"kernels": [...]} summary. Any failure
exits non-zero. Everything is written under a temporary directory outside
the checkout, except the kernel libraries (savtpu_torch/_build/).
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUDGET_S = 600.0
SEED = 1234
# 3,000 warm-up + two 3,000-step comm-free blocks. All 90 stored rows lie
# inside the 1 s load ramp, so stage 3 takes expfit's frozen-ramp
# fallback; --steps 100000 runs the published depth and the fit proper
STEPS = 9000
SAVE_EVERY = 50
# the default-config run's training depth: cut from the published 3,450
# epochs so that the script stays within about 450 s (PERF.md);
# --lstm-epochs 3450 runs it in full
LSTM_EPOCHS = 1500
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s off the
# tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


class Clock:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.t = self.t0

    def phase(self, n, name, **fields):
        now = time.perf_counter()
        rec = {"phase": n, "name": name,
               "elapsed_s": round(now - self.t, 3),
               "total_s": round(now - self.t0, 3), "budget_s": BUDGET_S,
               **fields}
        print(json.dumps(rec), flush=True)
        self.t = now


def slice_config(workdir: Path, steps: int = STEPS, dtype: str = "float32"):
    from savtpu_torch.config import Config

    cfg = Config()
    cfg.beam_cells = (96, 8, 8)
    cfg.beam_extent = (12.0, 1.0, 1.0)
    cfg.workdir = str(workdir / "Results")
    cfg.model_dir = str(workdir / "Distributed_save")
    cfg.partition.n_parts = 16
    cfg.solver.dtype = dtype
    cfg.solver.compensated = True   # float32's default; float64 too
    cfg.solver.num_steps = steps
    cfg.solver.save_every = SAVE_EVERY
    s = cfg.surrogate
    s.arch = "expfit"
    s.modal_dim = 8
    s.pred_consensus = False
    s.stacked = True
    return cfg


def small_config(workdir: Path):
    """A tiny banded compensated run (12x2x2, 4 parts, 100 steps)."""
    from savtpu_torch.config import Config

    cfg = Config()
    cfg.beam_cells = (12, 2, 2)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.workdir = str(workdir / "Results")
    cfg.model_dir = str(workdir / "Distributed_save")
    cfg.partition.n_parts = 4
    cfg.solver.dtype = "float32"
    cfg.solver.fint_mode = "banded"
    cfg.solver.num_steps = 100
    s = cfg.surrogate
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.arch = "expfit"
    s.modal_dim = 3
    s.expfit_order = 8
    return cfg


def k3_inputs(sp, dev, Tc, seed):
    """Online-block inputs at the slice's shapes: the slice's band and
    coefficients, seeded state and smooth seeded shared-DOF predictions."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P, nc, Bk, _ = sp.band_Kd.shape
    DLB, n = nc * Bk, sp.DL - 1
    S3 = sp.sld.shape[1]

    def fit(a, fill=0.0):
        out = torch.full((P, DLB), fill, dtype=a.dtype, device=dev)
        out[:, :n] = a[:, :n]
        return out

    bc, dm = fit(sp.bc_mask), fit(sp.dof_mask)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa
    hi = f32(1e-3 * rng.standard_normal((P, DLB))) * bc
    v = f32(1e-6 * rng.standard_normal((P, DLB))) * bc
    t = np.arange(Tc)[None, :, None]
    amp = rng.uniform(1e-4, 5e-4, (P, 1, S3))
    w = rng.uniform(0.001, 0.01, (P, 1, S3))
    preds = (f32(amp * np.sin(w * t)) * sp.smask[:, None, :]).contiguous()
    args = (sp.band_Kd, sp.band_Kl, hi, torch.zeros_like(hi), v,
            fit(sp.F_pre), fit(sp.lM, 1.0), bc, dm, sp.sld, sp.smask, preds)
    kw = dict(t0=0.05, i0=3000, dt=sp.dt, alpha=sp.alpha, ramped=sp.ramped,
              save_every=SAVE_EVERY)
    return args, kw


def k3_bound(args, Tc, save_every):
    """Least time for one online block on an H100: every input read once,
    every output written once, against the float32 arithmetic."""
    Kd, Kl, hi = args[0], args[1], args[2]
    preds = args[-1]
    P, nc, Bk, _ = Kd.shape
    DLB, S3 = nc * Bk, preds.shape[2]
    it = hi.element_size()
    nbytes = (
        (Kd.numel() + Kl.numel()) * it        # band
        + 7 * P * DLB * it                    # state and coefficients
        + P * S3 * (8 + it)                   # shared slot ids and mask
        + preds.numel() * it                  # predictions in
        + 3 * P * DLB * it                    # state out
        + P * Tc * S3 * it                    # shared rows out
        + P * (Tc // save_every) * DLB * it   # recorded trajectory out
    )
    # per step and part: the band matvec (2 (3nc-2) Bk^2), the translation
    # mean (4 per DOF), the increment and the TwoSum roll (17 per DOF)
    flops = P * Tc * (2 * (3 * nc - 2) * Bk * Bk + 21 * DLB)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), bound_by, nbytes, flops


def zero_band(args):
    """The online-block inputs with the band zeroed: no result then
    depends on a sum order."""
    import torch

    return (torch.zeros_like(args[0]), torch.zeros_like(args[1]), *args[2:])


def uncompensated_plain(args, kw):
    """Control for the kernel checks: the plain version with the
    compensation dropped. It runs one step at a time with lo reset to 0,
    so hi rounds as hi += delta would."""
    import torch

    from savtpu_torch.ops.online_banded import online_chunk_plain

    Kd, Kl, hi, lo, v, Fp, lM, bc, dm, sld, smask, preds = args
    se = kw["save_every"]
    shared, traj = [], []
    for k in range(preds.shape[1]):
        hi, lo, v, sh, tr = online_chunk_plain(
            Kd, Kl, hi, torch.zeros_like(lo), v, Fp, lM, bc, dm, sld, smask,
            preds[:, k : k + 1], **{**kw, "i0": kw["i0"] + k,
                                    "save_every": 1},
        )
        shared.append(sh)
        if k % se == 0:
            traj.append(tr)
    return hi, lo, v, torch.cat(shared, dim=1), torch.cat(traj, dim=1)


def online_references(args, kw):
    """What the online-block checks compare the kernel with, computed once
    for every launch shape: the plain version and the uncompensated
    control, with the band zeroed and with it, and the plain version in
    float64."""
    from savtpu_torch.ops.online_banded import online_chunk_plain

    zargs = zero_band(args)
    args64 = [a.double() if a.is_floating_point() else a for a in args]
    return {"zero_ref": online_chunk_plain(*zargs, **kw),
            "zero_ctl": uncompensated_plain(zargs, kw),
            "ref": online_chunk_plain(*args, **kw),
            "ctl": uncompensated_plain(args, kw),
            "ref64": online_chunk_plain(*args64, **kw)}


def check_online_block(args, kw, plan=None, refs=None):
    """Hold the online block's kernel, launched as ``plan`` says (default:
    as band_plan plans it), against its plain version, and show that the
    checks reject a control that drops the compensation.

    rounding: band zeroed, kernel and plain version equal bit for bit
    (every output, lo included); band: the slice's band, the compensated
    state, v and the recordings within RTOL of their scale. Returns the
    readings, with the checks that failed under "failures" (the control
    passing the rounding check is one). ``refs`` (from
    online_references) saves recomputing the plain runs."""
    from savtpu_torch.ops.online_banded import (
        RTOL,
        block_distance,
        online_chunk,
    )

    refs = refs or online_references(args, kw)
    rtol = RTOL[args[2].dtype]
    every = ("hi", "lo", "v", "shared", "traj")
    limited = ("state", "v", "shared", "traj")

    def worst(d, keys, field):
        return max(d[k][field] for k in keys)

    zargs = zero_band(args)
    rounding = {"kernel": block_distance(online_chunk(*zargs, plan=plan,
                                                      **kw),
                                         refs["zero_ref"]),
                "control": block_distance(refs["zero_ctl"],
                                          refs["zero_ref"])}
    out_k = online_chunk(*args, plan=plan, **kw)
    for name, t in zip(every, out_k):
        if not bool(t.isfinite().all()):
            raise RuntimeError(f"kernel output {name} is not finite")
    band = {"kernel": block_distance(out_k, refs["ref"]),
            "control": block_distance(refs["ctl"], refs["ref"])}
    vs64 = {name: block_distance(o, refs["ref64"])["state"]["max_rel"]
            for name, o in (("kernel", out_k), ("plain", refs["ref"]),
                            ("control", refs["ctl"]))}
    res = {
        "rtol": rtol,
        "steps": int(args[-1].shape[1]),
        "plan": (vars(plan) if plan
                 else planned_band("online_banded", args[0])),
        "rounding_kernel_max_abs": worst(rounding["kernel"], every, "max_abs"),
        "rounding_control_max_abs": worst(rounding["control"], every,
                                          "max_abs"),
        "band_kernel_max_rel": worst(band["kernel"], limited, "max_rel"),
        "band_control_max_rel": worst(band["control"], limited, "max_rel"),
        "max_abs_err": worst(band["kernel"], limited, "max_abs"),
        "state_vs_float64_plain": vs64,
        "rounding": rounding,
        "band": band,
    }
    res["band_control_rejected"] = res["band_control_max_rel"] > rtol
    res["failures"] = [msg for bad, msg in (
        (res["rounding_control_max_abs"] == 0.0,
         "the rounding check does not see a dropped compensation"),
        (res["rounding_kernel_max_abs"] != 0.0,
         "the kernel rounds unlike its plain version with the band zeroed"),
        (not res["band_kernel_max_rel"] <= rtol,
         "the kernel disagrees with its plain version beyond rtol"),
    ) if bad]
    return res


def bound_ms(nbytes, flops):
    """Least time on an H100 for work that moves ``nbytes`` (each input
    read once, each output written once) and does ``flops`` float
    operations: the larger of the two times, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, ties away from zero), as a
    float32 tensor: what a TF32 tensor-core product reads."""
    import torch

    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def worst_abs(out_a, out_b):
    """Largest max |a - b| over paired outputs (None pairs skipped)."""
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(out_a, out_b) if a is not None)


def check_fint_matvec(K, d):
    """K1 against its plain version; the control is the plain product on
    TF32-rounded inputs, which the same comparison must reject."""
    from savtpu_torch.ops.dense_step import (
        MATVEC_RTOL,
        batched_fint_matvec,
        batched_fint_matvec_plain,
        scaled_error,
    )

    rtol = MATVEC_RTOL[d.dtype]
    ref = batched_fint_matvec_plain(K, d)
    out_k = batched_fint_matvec(K, d)
    ctl = batched_fint_matvec_plain(tf32(K), tf32(d)).to(d.dtype)
    res = {
        "rtol": rtol,
        "kernel_max_rel": scaled_error([out_k], [ref]),
        "control_max_rel": scaled_error([ctl], [ref]),
        "max_abs_err": worst_abs([out_k], [ref]),
    }
    res["failures"] = [msg for bad, msg in (
        (not bool(out_k.isfinite().all()), "K1 output is not finite"),
        (not res["kernel_max_rel"] <= rtol,
         "K1 disagrees with its plain version beyond rtol"),
        (not res["control_max_rel"] > rtol,
         "the K1 check does not reject the TF32 control"),
    ) if bad]
    return res


def scan_inputs(sp, steps, seed):
    """K2 inputs at a problem's shapes: its K and coefficients, a seeded
    state and smooth seeded shared-DOF predictions. Returns (args,
    preds, kw) for scan_comm_free(*args, preds, **kw)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P, DL, S3 = sp.n_parts, sp.DL, sp.sld.shape[1]
    T = lambda a: torch.as_tensor(a, dtype=sp.dtype).to(sp.device)  # noqa
    d0 = T(1e-3 * rng.standard_normal((P, DL))) * sp.bc_mask
    dn = d0 - T(1e-6 * rng.standard_normal((P, DL))) * sp.bc_mask
    t = np.arange(steps)[None, :, None]
    preds = (T(rng.uniform(1e-4, 5e-4, (P, 1, S3))
               * np.sin(rng.uniform(0.001, 0.01, (P, 1, S3)) * t))
             * sp.smask[:, None, :]).contiguous()
    args = (sp.denseK, d0, dn, 0.05, sp.F_pre, sp.lM, sp.bc_mask, sp.sld,
            sp.smask)
    kw = dict(num_steps=steps, dt=sp.dt, alpha=sp.alpha, ramped=sp.ramped)
    return args, preds, kw


def check_scan_comm_free(sp, steps, seed, plan=None):
    """K2 against its plain version, with and without predictions, the
    shared rows recorded, launched as ``plan`` says (default: as
    dense_step.scan_plan plans it). rounding: K zeroed, kernel and plain
    version equal bit for bit; with K, within SCAN_RTOL of the plain
    state's scale. The control, the plain version with the overwrite
    dropped, must fail the same comparison."""
    import torch

    from savtpu_torch.ops.dense_step import (
        SCAN_RTOL,
        scaled_error,
        scan_comm_free,
        scan_comm_free_plain,
    )

    args, preds, kw = scan_inputs(sp, steps, seed)
    rtol = SCAN_RTOL[sp.dtype]
    zargs = (torch.zeros_like(args[0]), *args[1:])
    rounding, kernel, abs_err = 0.0, 0.0, 0.0
    for p in (None, preds):
        a = scan_comm_free(*zargs, p, record_shared=True, plan=plan, **kw)
        b = scan_comm_free_plain(*zargs, p, record_shared=True, **kw)
        rounding = max(rounding, worst_abs(a, b))
        out_k = scan_comm_free(*args, p, record_shared=True, plan=plan,
                               **kw)
        ref = scan_comm_free_plain(*args, p, record_shared=True, **kw)
        if not all(bool(t.isfinite().all()) for t in out_k):
            raise RuntimeError("K2 output is not finite")
        kernel = max(kernel, scaled_error(out_k, ref))
        abs_err = max(abs_err, worst_abs(out_k, ref))
    # ref is now the plain version with predictions
    ctl = scan_comm_free_plain(*args, None, record_shared=True, **kw)
    res = {
        "rtol": rtol, "steps": steps,
        "plan": None if plan is None else vars(plan),
        "rounding_kernel_max_abs": rounding,
        "kernel_max_rel": kernel,
        "control_max_rel": scaled_error(ctl, ref),
        "max_abs_err": abs_err,
    }
    if sp.device.type == "cuda" and plan is None:
        from savtpu_torch.ops.dense_step import scan_plan, sm_count

        res["plan"] = vars(scan_plan(sp.n_parts, sp.DL, sp.dtype,
                                     sm_count(sp.device)))
    res["failures"] = [msg for bad, msg in (
        (rounding != 0.0,
         "K2 rounds unlike its plain version with K zeroed"),
        (not kernel <= rtol,
         "K2 disagrees with its plain version beyond rtol"),
        (not res["control_max_rel"] > rtol,
         "the K2 check does not reject the dropped-overwrite control"),
    ) if bad]
    return res


def band_matvec_no_super(Kd, Kl, x):
    """Control for the K4 check: the band matvec without its
    super-diagonal term Kl[c+1]^T x_{c+1}."""
    import torch

    P = x.shape[0]
    _, nc, Bk, _ = Kd.shape
    xc = x.reshape(P, nc, Bk, 1)
    y = torch.matmul(Kd, xc)
    if nc > 1:
        y[:, 1:] = y[:, 1:] + torch.matmul(Kl[:, 1:], xc[:, :-1])
    return y.reshape(P, nc * Bk)


def banded_scan_inputs(sp, steps, seed):
    """K4 inputs at a problem's shapes: its band and coefficients and a
    seeded state. Returns (args, kw) for scan_comm_free_banded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P, DL = sp.n_parts, sp.DL
    T = lambda a: torch.as_tensor(a, dtype=sp.dtype).to(sp.device)  # noqa
    d0 = T(1e-3 * rng.standard_normal((P, DL))) * sp.bc_mask
    dn = d0 - T(1e-6 * rng.standard_normal((P, DL))) * sp.bc_mask
    args = (sp.band_Kd, sp.band_Kl, d0, dn, 0.05, sp.F_pre, sp.lM,
            sp.bc_mask)
    kw = dict(num_steps=steps, dt=sp.dt, alpha=sp.alpha, ramped=sp.ramped)
    return args, kw


def banded_scan_references(args, kw):
    """The plain K4 runs its checks compare with, computed once for every
    launch shape: with the band zeroed, with it, and the control."""
    import torch

    from savtpu_torch.ops.banded_scan import scan_comm_free_banded_plain

    zargs = (torch.zeros_like(args[0]), torch.zeros_like(args[1]),
             *args[2:])
    return {"zero_ref": scan_comm_free_banded_plain(*zargs, **kw),
            "ref": scan_comm_free_banded_plain(*args, **kw),
            "ctl": scan_comm_free_banded_plain(
                *args, matvec=band_matvec_no_super, **kw)}


def check_banded_scan(sp, steps, seed, plan=None, refs=None):
    """K4, launched as ``plan`` says (default: as band_plan plans it),
    against its plain version: band zeroed, bit for bit; with the band,
    within banded_scan.RTOL of the plain state's scale. The control, the
    plain version whose band matvec drops the super-diagonal term, must
    fail the same comparison. ``refs`` (from banded_scan_references, on
    the inputs of ``banded_scan_inputs(sp, steps, seed)``) saves
    recomputing the plain runs."""
    import torch

    from savtpu_torch.ops.banded_scan import RTOL, scan_comm_free_banded
    from savtpu_torch.ops.dense_step import scaled_error

    args, kw = banded_scan_inputs(sp, steps, seed)
    refs = refs or banded_scan_references(args, kw)
    rtol = RTOL[sp.dtype]
    zargs = (torch.zeros_like(args[0]), torch.zeros_like(args[1]),
             *args[2:])
    rounding = worst_abs(scan_comm_free_banded(*zargs, plan=plan, **kw),
                         refs["zero_ref"])
    out_k = scan_comm_free_banded(*args, plan=plan, **kw)
    if not all(bool(t.isfinite().all()) for t in out_k):
        raise RuntimeError("K4 output is not finite")
    res = {
        "rtol": rtol, "steps": steps,
        "plan": (vars(plan) if plan
                 else planned_band("banded_scan", args[0])),
        "rounding_kernel_max_abs": rounding,
        "kernel_max_rel": scaled_error(out_k, refs["ref"]),
        "control_max_rel": scaled_error(refs["ctl"], refs["ref"]),
        "max_abs_err": worst_abs(out_k, refs["ref"]),
    }
    res["failures"] = [msg for bad, msg in (
        (rounding != 0.0,
         "K4 rounds unlike its plain version with the band zeroed"),
        (not res["kernel_max_rel"] <= rtol,
         "K4 disagrees with its plain version beyond rtol"),
        (not res["control_max_rel"] > rtol,
         "the K4 check does not reject the no-super-diagonal control"),
    ) if bad]
    return res


def planned_band(name, Kd):
    """The plan band_plan gives the kernel ``name`` (online_banded or
    banded_scan) for the band Kd on its card; on the CPU (the plain
    version) an empty dict."""
    from savtpu_torch.ops.band_plan import band_plan, cluster_table
    from savtpu_torch.ops.dense_step import sm_count

    if Kd.device.type != "cuda":
        return {}
    P, nc, Bk, _ = Kd.shape
    return vars(band_plan(P, nc, Bk, Kd.dtype, sm_count(Kd.device),
                          cluster_table(name, Kd.dtype, Kd.device)))


def band_shapes(nc, Bk, dtype, table):
    """Every launch shape band_plan can take for a part of nc x Bk rows,
    as forced plans: one block per part; clusters of 3 (rows crossing
    chunk boundaries), 8 and 12 blocks; 16 (non-portable); each with as
    many resident Kd rows as fit; and 5 blocks with every row streamed.
    Sizes the card cannot run (table[B] == 0) and states too large for a
    block are left out, as band_plan would leave them."""
    from savtpu_torch.ops import kernels
    from savtpu_torch.ops.band_plan import forced_band_plan

    shapes = [(1, None), (3, None), (5, 0), (8, None), (12, None),
              (16, None)]
    plans = [forced_band_plan(nc, Bk, dtype, b, r) for b, r in shapes
             if table.get(b, 0) > 0]
    return [p for p in plans if p.smem <= kernels.SMEM_PER_BLOCK]


def stepper_inputs(sp, steps, seed=SEED):
    """A seeded state near the ramp's start, seeded predictions, t0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P, DL, S3 = sp.n_parts, sp.DL, sp.sld.shape[1]
    T = lambda a: torch.as_tensor(a, dtype=sp.dtype).to(sp.device)  # noqa
    d0 = T(1e-3 * rng.standard_normal((P, DL))) * sp.dof_mask
    dn = d0 - T(1e-6 * rng.standard_normal((P, DL))) * sp.dof_mask
    preds = T(1e-4 * rng.standard_normal((P, steps, S3))) * sp.smask[:, None]
    return d0, dn, T(0.05), preds


def check_graph_stepper(sps, steps=25, graph_steps=10):
    """The graph-replayed stepper against the eager loop on the card, on
    problems ``sps`` (plain and compensated): sync on and off, predictions
    on and off, record all / shared / none, save_every 1 and 5, over two
    full chunks and a remainder. Equal bit for bit: the same kernels run
    in the same order. K1 counts one launch per step on both paths. The
    control, the graph path on the problem with its load ramp dropped,
    must fail the same comparison."""
    import dataclasses
    import itertools

    import torch

    from savtpu_torch.ops.dense_step import batched_fint_matvec

    def flat(out):
        (traj, shared), carry = out
        return [x for x in (traj, shared, *carry) if x is not None]

    worst, cases, counts_ok = 0.0, 0, True
    for sp in sps:
        d0, dn, t0, preds = stepper_inputs(sp, steps)
        for sync, use_preds, record, se in itertools.product(
                (True, False), (False, True), ("all", "shared", "none"),
                (1, 5)):
            kw = dict(sync=sync, preds=preds if use_preds else None,
                      record=record, save_every=se)
            n0 = batched_fint_matvec.launches
            a = flat(sp._stacked_run_eager(d0, dn, t0, steps, **kw))
            n1 = batched_fint_matvec.launches
            b = flat(sp._stacked_run_chunked(d0, dn, t0, steps,
                                             graph_steps=graph_steps, **kw))
            torch.cuda.synchronize()
            n2 = batched_fint_matvec.launches
            counts_ok &= (n1 - n0 == steps and n2 - n1 == steps)
            worst = max(worst, worst_abs(a, b))
            cases += 1
    sp = sps[0]
    d0, dn, t0, _ = stepper_inputs(sp, steps)
    kw = dict(sync=True, preds=None, record="all", save_every=1)
    ref = flat(sp._stacked_run_eager(d0, dn, t0, steps, **kw))
    ctl_sp = dataclasses.replace(sp, ramped=not sp.ramped)
    ctl = flat(ctl_sp._stacked_run_chunked(d0, dn, t0, steps,
                                           graph_steps=graph_steps, **kw))
    res = {"cases": cases, "steps": steps, "graph_steps": graph_steps,
           "graph_vs_eager_max_abs": worst,
           "control_max_abs": worst_abs(ctl, ref),
           "k1_counts_per_step": counts_ok}
    res["failures"] = [msg for bad, msg in (
        (worst != 0.0, "the graph path differs from the eager loop"),
        (res["control_max_abs"] == 0.0,
         "the graph check does not see a dropped ramp"),
        (not counts_ok, "K1 counts differ from one launch per step"),
    ) if bad]
    return res


def graph_ms(fn, reps=100):
    """Device time of one call of fn(), from ``reps`` calls captured in
    one CUDA graph and replayed, in ms (no host issue time inside)."""
    import torch

    from savtpu_torch.ops.dense_step import batched_fint_matvec

    fn()
    torch.cuda.synchronize()
    n = batched_fint_matvec.launches
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    batched_fint_matvec.launches = n   # a timing capture launches nothing
    g.replay()
    return event_ms(g.replay, 5) / reps


def event_ms(fn, reps):
    """Mean time of ``reps`` calls of fn() on the card, from CUDA events,
    in ms."""
    import torch

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def in_turns(plain, kernel, plain_reps, kernel_reps):
    """Time a kernel and its plain version in turns (plain, kernel,
    plain) after one warm-up call of the kernel. Returns (kernel ms, mean
    plain ms, [plain ms of each turn])."""
    kernel()
    a = event_ms(plain, plain_reps)
    k = event_ms(kernel, kernel_reps)
    b = event_ms(plain, plain_reps)
    return k, 0.5 * (a + b), [a, b]


# the sweep's cases whose path runs K1, K2 and K4: (mesh, parts, mode)
SWEEP_PATH = (("48x4x4", 8, "pallas"), ("96x8x8", 8, "pallas"),
              ("96x8x8", 16, "banded"), ("96x8x8", 8, "banded"))


def sweep_path_cases():
    """Those cases as the sweep lists them (psum, uncompensated), with the
    sweep's own step counts."""
    from savtpu_torch.benchmarks import sweep

    cases = {sweep.case_tag(c)[:3]: c for c in sweep.CASES
             if sweep.case_tag(c)[:3] in SWEEP_PATH
             and sweep.case_tag(c)[3:] == ("psum", False)}
    if sorted(cases) != sorted(SWEEP_PATH):
        raise RuntimeError(f"the sweep lacks a case of {SWEEP_PATH}")
    return [cases[k] for k in SWEEP_PATH]


def run_sweep_path(dev):
    """The sweep's cases on K1, K2 and K4 through its entry point,
    ``bench_case``: every launch count is set to 0 just before each case
    and read just after. A pallas case must launch K1 once per exchanged
    step (an untimed and a timed run) and K2 once per comm-free run; a
    banded case K4 once per comm-free run. Returns (rows, total launches
    per kernel)."""
    import torch

    from savtpu_torch.benchmarks import sweep

    rows, totals = [], dict.fromkeys(sweep.KERNELS, 0)
    for case in sweep_path_cases():
        for fn in sweep.KERNELS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        row = sweep.bench_case(*case, device=dev)
        counts = {k: fn.launches for k, fn in sweep.KERNELS.items()}
        steps = case[5]
        expect = dict.fromkeys(sweep.KERNELS, 0)
        if row["fint_mode"] == "pallas":
            expect.update(fint_matvec=2 * steps, scan_comm_free=2)
        else:
            expect.update(scan_comm_free_banded=2)
        row.update(steps=steps, kernel_launches=counts,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   resident_before=resident,
                   case_s=time.perf_counter() - t0)
        rows.append(row)
        if counts != expect:
            raise RuntimeError(f"{case}: launches {counts}, expected "
                               f"{expect}")
        for k in totals:
            totals[k] += counts[k]
    return rows, totals


def small_sweep_gpu_vs_cpu(dev, steps=200):
    """Tiny pallas and banded sweep problems in float64 through
    ShardedSolver.run on the card (K1, K2, K4) and on the CPU (their plain
    versions): the comm-free and exchanged final states, scaled error."""
    import numpy as np
    import torch

    from savtpu_torch.benchmarks.sweep import build_case
    from savtpu_torch.ops.dense_step import scaled_error
    from savtpu_torch.parallel import ShardedSolver

    worst = {}
    for case in ((8, 1, 1, 2, "pallas"), (25, 2, 2, 2, "banded")):
        outs = []
        for device in (dev, torch.device("cpu")):
            prob, sp = build_case(*case, device=device, dtype=torch.float64)
            sol = ShardedSolver(sp)
            d0 = sp.localize(np.zeros(prob.ndof))
            res = []
            for sync in (False, True):
                (_, _), c = sol.run(d0, d0, 0.0, steps, sync=sync,
                                    record="none")
                res += [c[0].cpu(), c[1].cpu()]
            outs.append(res)
        worst[case[4]] = scaled_error(outs[0], outs[1])
    return worst


def time_fint_matvec(sp, seed):
    """K1, its plain version and torch.bmm (float32 in full precision)
    on one step's product at a problem's shapes."""
    import numpy as np
    import torch

    from savtpu_torch.ops.dense_step import (
        batched_fint_matvec,
        batched_fint_matvec_plain,
    )

    K = sp.denseK
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(1e-3 * rng.standard_normal((sp.n_parts, sp.DL)),
                        dtype=sp.dtype).to(sp.device) * sp.dof_mask
    k_eager, p, runs = in_turns(lambda: batched_fint_matvec_plain(K, d),
                                lambda: batched_fint_matvec(K, d), 5, 100)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on: torch.bmm would not be "
                           "float32")
    lib_eager = event_ms(lambda: torch.bmm(K, d[:, :, None]), 100)
    # device time: 100 calls in one graph, in turns
    k = graph_ms(lambda: batched_fint_matvec(K, d))
    lib = graph_ms(lambda: torch.bmm(K, d[:, :, None]))
    k2 = graph_ms(lambda: batched_fint_matvec(K, d))
    P, DL = d.shape
    it = d.element_size()
    b, by = bound_ms(it * (P * DL * DL + 2 * P * DL), 2 * P * DL * DL)
    return dict(P=P, DL=DL, ms=min(k, k2), ms_runs=[k, k2], plain_ms=p,
                plain_ms_runs=runs, library_ms=lib,
                eager_ms=k_eager, library_eager_ms=lib_eager,
                bound_ms=b, bound_by=by, bound_share=b / min(k, k2))


def time_scan(sp, steps):
    """K2 and its plain version on the sweep's call: ``steps`` comm-free
    steps from a zero state, no predictions, no recording."""
    import torch

    from savtpu_torch.ops.dense_step import (
        scan_comm_free,
        scan_comm_free_plain,
    )

    d0 = torch.zeros((sp.n_parts, sp.DL), dtype=sp.dtype, device=sp.device)
    args = (sp.denseK, d0, d0, 0.0, sp.F_pre, sp.lM, sp.bc_mask, sp.sld,
            sp.smask, None)
    kw = dict(num_steps=steps, dt=sp.dt, alpha=sp.alpha, ramped=sp.ramped,
              record_shared=False)
    k, p, runs = in_turns(lambda: scan_comm_free_plain(*args, **kw),
                          lambda: scan_comm_free(*args, **kw), 1, 2)
    P, DL = d0.shape
    it = d0.element_size()
    b, by = bound_ms(it * (P * DL * DL + 7 * P * DL) + 4 * P * DL,
                     steps * P * (2 * DL * DL + 15 * DL))
    # where K cannot stay on chip (beyond 50 MB of L2 and the SMs' shared
    # memory), every step reads it again from HBM
    reread = steps * P * DL * DL * it / PEAK_BYTES * 1e3
    return dict(P=P, DL=DL, steps=steps, ms=k, plain_ms=p,
                plain_ms_runs=runs, bound_ms=b, bound_by=by,
                bound_k_reread_ms=reread)


def time_banded_scan(sp, steps):
    """K4 and its plain version on the sweep's call: ``steps`` comm-free
    steps from a zero state; the plan it ran with."""
    import torch

    from savtpu_torch.ops.band_plan import band_plan, cluster_table
    from savtpu_torch.ops.banded_scan import (
        scan_comm_free_banded,
        scan_comm_free_banded_plain,
    )
    from savtpu_torch.ops.dense_step import sm_count

    d0 = torch.zeros((sp.n_parts, sp.DL), dtype=sp.dtype, device=sp.device)
    args = (sp.band_Kd, sp.band_Kl, d0, d0, 0.0, sp.F_pre, sp.lM,
            sp.bc_mask)
    kw = dict(num_steps=steps, dt=sp.dt, alpha=sp.alpha, ramped=sp.ramped)
    k, p, runs = in_turns(lambda: scan_comm_free_banded_plain(*args, **kw),
                          lambda: scan_comm_free_banded(*args, **kw), 1, 2)
    P, nc, Bk, _ = sp.band_Kd.shape
    DLB = nc * Bk
    it = d0.element_size()
    b, by = bound_ms(it * (2 * P * nc * Bk * Bk + 7 * P * DLB),
                     steps * P * (2 * (3 * nc - 2) * Bk * Bk + 15 * DLB))
    table = cluster_table("banded_scan", sp.dtype, sp.device)
    plan = band_plan(P, nc, Bk, sp.dtype, sm_count(sp.device), table)
    return dict(P=P, nc=nc, Bk=Bk, steps=steps, ms=k, plain_ms=p,
                plain_ms_runs=runs, bound_ms=b, bound_by=by,
                bound_band_reread_ms=band_reread_ms(sp.band_Kd, steps),
                plan=vars(plan), max_active_clusters=table)


def band_reread_ms(Kd, steps):
    """The floor where the band cannot stay on chip (beyond 50 MB of L2
    and the SMs' shared memory): every step reads Kd and Kl again from
    HBM."""
    return steps * 2 * Kd.numel() * Kd.element_size() / PEAK_BYTES * 1e3


def stepper_profile(sp, dev, steps):
    """Wall and device time per step of the exchanged (stage-1) stepper at
    the slice's shapes, replayed from its CUDA graphs, from
    torch.profiler: the device's busy share and its five longest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    d0 = torch.zeros((sp.n_parts, sp.DL), dtype=sp.dtype, device=dev)
    # warm-up: captures the graph chunks the profiled run replays
    sp.stacked_run(d0, d0, 0.0, steps, sync=True, record="traj")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sp.stacked_run(d0, d0, 0.0, steps, sync=True, record="traj")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # kernel events only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": (busy_us * 1e-3 / steps) if rows
        else "not measured",
        "device_busy_share": (busy_us * 1e-6 / wall) if rows
        else "not measured",
        "top_kernels_ms_per_step": {k[:60]: t * 1e-3 / steps
                                    for k, t in rows[:5]},
    }


def keep_traces(out_dir, cfg, store, per_rank, dt):
    """Save the stage-2 shared-DOF traces of the rank whose comm-free
    rel-L2 departs most and of the median rank, with what stage 3 fits
    them with, into ``out_dir/c2_traces_<dtype>_<steps>.npz``."""
    import numpy as np

    from savtpu_torch.io.artifacts import load_displacement

    ranks = sorted(per_rank, key=per_rank.get)
    pick = {"departing": ranks[-1], "median": ranks[len(ranks) // 2]}
    sur = cfg.surrogate
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(
        out_dir / f"c2_traces_{cfg.solver.dtype}_{cfg.solver.num_steps}.npz",
        **{f"trace_{k}": load_displacement(store.shared_dof_h5(r))
           for k, r in pick.items()},
        **{f"rank_{k}": r for k, r in pick.items()},
        rel_l2_per_rank=np.array([per_rank[r] for r in sorted(per_rank)]),
        dt=dt, save_every=cfg.solver.save_every,
        expfit_ramp_s=float(sur.expfit_ramp_s or 0.0),
        cut_off=sur.cut_off, modal_dim=sur.modal_dim,
        expfit_order=sur.expfit_order)


# ---- the default configuration: the LSTM surrogate ----

def lstm_config(workdir: Path, epochs: int, fint_mode: str = "auto"):
    """The default Config() (25x1x1 beam, 2 RCB parts, dense, float64,
    100,000 steps at save_every 1, the stacked LSTM surrogate), with the
    training cut to ``epochs`` epochs (the published 3,450 with
    --lstm-epochs 3450)."""
    from savtpu_torch.config import Config

    cfg = Config()
    cfg.workdir = str(workdir / "Results")
    cfg.model_dir = str(workdir / "Distributed_save")
    cfg.solver.fint_mode = fint_mode
    cfg.surrogate.num_epochs = epochs
    return cfg


def lstm_windows(S3, seed, P=2, G=295):
    """Stage-3 inputs at the default run's shapes, made from a seed:
    (P, G, n_p, S3) and (P, G, n_f, S3) windows in the scaled range
    [-1, 0], rank 0 a third narrower (ragged widths), and the mask."""
    import numpy as np

    from savtpu_torch.config import SurrogateConfig

    sur = SurrogateConfig()
    rng = np.random.default_rng(seed)
    fm = np.ones((P, S3))
    fm[0, 2 * S3 // 3 :] = 0.0
    X = rng.uniform(-1, 0, (P, G, sur.n_past, S3)) * fm[:, None, None, :]
    Y = rng.uniform(-1, 0, (P, G, sur.n_future, S3)) * fm[:, None, None, :]
    return X, Y, fm


def rel_max(a, b):
    """max |a - b| over max |b| (numpy or torch)."""
    import numpy as np

    a, b = (np.asarray(t.detach().cpu() if hasattr(t, "detach") else t,
                       dtype=np.float64) for t in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def lstm_predict_err(S3, dev, dtype, seed, tf32_on=False):
    """The stacked LSTM's predict (P = 2, H = 50, 2 bidirectional
    layers, n_s = 150 windows of n_p = 20 rows, n_f = 20) on the card
    against the CPU, same parameters and inputs: max |a - b| / max |b|.
    ``tf32_on`` runs the card's products in TF32 (the control)."""
    import numpy as np
    import torch

    from savtpu_torch.models.lstm import StackedSeq2Seq

    model = StackedSeq2Seq(2, S3, 50, dtype=dtype,
                           generator=torch.Generator().manual_seed(seed))
    x = torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 0, (2, 150, 20, S3)), dtype=dtype)
    was = torch.backends.cuda.matmul.allow_tf32
    with torch.no_grad():
        ref = model.predict(x, 20)
        model.to(dev)
        torch.backends.cuda.matmul.allow_tf32 = tf32_on
        try:
            out = model.predict(x.to(dev), 20)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
    return rel_max(out, ref)


def check_lstm(S3, dev, seed=SEED):
    """Phase-2 checks of the LSTM surrogate at the default run's shapes:
    predict on the card against the CPU (float64 within 1e-12, float32
    within 1e-5), a TF32 control the float32 check must reject, stage 3's
    own switch back to full-precision products, one float64 epoch of
    fit_stacked on the card against the CPU (within 1e-10), and the
    graph-replayed epochs against eager epochs on the card, bit for
    bit."""
    import numpy as np
    import torch

    from savtpu_torch.config import SurrogateConfig
    from savtpu_torch.models.training import fit_stacked

    res = {"predict_f64": lstm_predict_err(S3, dev, torch.float64, seed),
           "predict_f32": lstm_predict_err(S3, dev, torch.float32, seed),
           "predict_f32_tf32_control": lstm_predict_err(
               S3, dev, torch.float32, seed, tf32_on=True),
           "limits": {"predict_f64": 1e-12, "predict_f32": 1e-5,
                      "epoch_f64_card_vs_cpu": 1e-10,
                      "graph_vs_eager": 0.0}}
    X, Y, fm = lstm_windows(S3, seed)

    def fit(dtype, device, epochs, replay=None):
        cfg = SurrogateConfig(dtype=dtype, num_epochs=epochs)
        m, h = fit_stacked(cfg, X, Y, fm, device=device, log_every=0,
                           replay=replay)
        return list(m.arrays().values()) + [h[k] for k in sorted(h)]

    # stage 3 switches TF32 off itself: left on here, fit_stacked must
    # turn it off, and the float32 forward must pass again after it
    torch.backends.cuda.matmul.allow_tf32 = True
    fit("float32", dev, 1)
    res["tf32_off_after_fit"] = not torch.backends.cuda.matmul.allow_tf32
    res["predict_f32_after_fit"] = lstm_predict_err(S3, dev, torch.float32,
                                                    seed)
    card = fit("float64", dev, 1)
    cpu = fit("float64", "cpu", 1)
    res["epoch_f64_card_vs_cpu"] = max(rel_max(a, b)
                                       for a, b in zip(card, cpu))
    graph = fit("float32", dev, 3, replay=True)
    eager = fit("float32", dev, 3, replay=False)
    res["graph_vs_eager"] = max(float(np.abs(a - b).max())
                                for a, b in zip(graph, eager))
    lim = res["limits"]
    res["failures"] = [msg for bad, msg in (
        (not res["predict_f64"] <= lim["predict_f64"],
         "float64 predict: card vs CPU beyond 1e-12"),
        (not res["predict_f32"] <= lim["predict_f32"],
         "float32 predict: card vs CPU beyond 1e-5"),
        (res["predict_f32_tf32_control"] <= lim["predict_f32"],
         "the float32 check does not reject TF32 products"),
        (not res["tf32_off_after_fit"],
         "fit_stacked left TF32 products on"),
        (not res["predict_f32_after_fit"] <= lim["predict_f32"],
         "float32 predict after fit_stacked beyond 1e-5"),
        (not res["epoch_f64_card_vs_cpu"] <= lim["epoch_f64_card_vs_cpu"],
         "one float64 epoch: card vs CPU beyond 1e-10"),
        (res["graph_vs_eager"] != 0.0,
         "graph-replayed epochs differ from eager epochs"),
    ) if bad]
    return res


def compare_runs(cfg, store, steps, save_every):
    """The sync-avoiding run against the exchanged one, from their
    artifacts: per-rank and whole non-shared rel-L2 over the comm-free
    window, and the warm-up rows' largest relative difference and
    whether they are equal bit for bit."""
    import numpy as np

    from savtpu_torch.io.artifacts import load_displacement

    n_warm = (cfg.surrogate.i_cri + 1) // save_every
    err_sq = ref_sq = warm_err = 0.0
    warm_equal = True
    per_rank = {}
    for r in range(cfg.partition.n_parts):
        exact = load_displacement(store.dynamics_h5(r))
        model = load_displacement(store.modeled_h5(r))
        if (exact.shape != model.shape
                or exact.shape[1] != steps // save_every):
            raise RuntimeError(f"rank {r}: trajectory shapes {exact.shape}"
                               f" vs {model.shape}")
        if not (np.isfinite(exact).all() and np.isfinite(model).all()):
            raise RuntimeError(f"rank {r}: non-finite trajectory")
        warm_equal &= bool(np.array_equal(exact[:, :n_warm],
                                          model[:, :n_warm]))
        warm_err = max(warm_err, float(
            np.abs(exact[:, :n_warm] - model[:, :n_warm]).max()
            / max(np.abs(exact[:, :n_warm]).max(), 1e-30)))
        local = store.load_int_csv(store.local_nodes_csv(r))
        shared = set(store.load_int_csv(store.shared_csv(r)).tolist())
        keep = np.repeat([int(g) not in shared for g in local], 3)
        d = exact[keep, n_warm:] - model[keep, n_warm:]
        e2 = float((d * d).sum())
        r2 = float((exact[keep, n_warm:] ** 2).sum())
        per_rank[r] = math.sqrt(e2 / max(r2, 1e-300))
        err_sq += e2
        ref_sq += r2
    return (per_rank, math.sqrt(err_sq / max(ref_sq, 1e-300)), warm_err,
            warm_equal)


def stage_events(cfg):
    """The last metrics.jsonl record of each event."""
    events = {}
    for line in (Path(cfg.workdir) / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        events[rec["event"]] = rec
    return events


def run_lstm_path(root: Path, dev, epochs):
    """Phase 3's default-config run through api.Simulation, then its
    stage 4 again from a copy of the workdir in fint_mode "pallas", where
    K1 runs every step. Returns the phase's readings, with "failures"."""
    import numpy as np

    from savtpu_torch.io.artifacts import ArtifactStore, load_displacement
    from savtpu_torch.ops.dense_step import batched_fint_matvec
    from savtpu_torch.pipeline import online_predictor

    cfg = lstm_config(root / "dense", epochs)
    steps, se = cfg.solver.num_steps, cfg.solver.save_every
    sim, metrics, times = run_stages(cfg, dev)
    del sim
    ev = stage_events(cfg)
    store = ArtifactStore(cfg.workdir, cfg.model_dir,
                          cfg.surrogate.run_tag())
    per_rank, commfree, warm_err, warm_equal = compare_runs(
        cfg, store, steps, se)
    s3 = ev["stage3_train_stacked"]
    res = {
        "steps": steps, "epochs": epochs,
        "published_epochs": lstm_config(root, None).surrogate.epochs,
        "stage_s": times,
        "setup": ev["setup_breakdown"],
        "stage1_steps_per_s": ev["stage1_solve"]["steps_per_sec"],
        "stage3": {k: s3[k] for k in ("shards", "input_size", "windows",
                                      "epochs", "adam_steps", "seconds",
                                      "capture_s", "train_s",
                                      "final_train_loss", "final_val_r2")},
        "stage3_epochs_per_s": s3["epochs"] / s3["train_s"],
        "stage3_adam_steps_per_s": s3["adam_steps"] / s3["train_s"],
        "stage4": {k: ev["stage4_online"][k] for k in (
            "seconds", "steps_per_sec", "warmup_s", "blocks_s", "blocks")},
        "plotter_metrics": metrics,
        "commfree_rel_l2_nonshared": commfree,
        "commfree_rel_l2_per_rank": per_rank,
        "warmup_rows_equal": warm_equal,
        "warmup_rows_max_rel_diff": warm_err,
    }
    # K1 on the same path: stage 4 again, from a copy, in pallas mode
    shutil.copytree(root / "dense", root / "pallas")
    cfg_k1 = lstm_config(root / "pallas", epochs, fint_mode="pallas")
    batched_fint_matvec.launches = 0
    online_predictor.run(cfg_k1, verbose=False, device=dev)
    k1 = batched_fint_matvec.launches
    st_k1 = ArtifactStore(cfg_k1.workdir, cfg_k1.model_dir,
                          cfg_k1.surrogate.run_tag())
    k1_rel = max(rel_max(load_displacement(st_k1.modeled_h5(r)),
                         load_displacement(store.modeled_h5(r)))
                 for r in range(cfg.partition.n_parts))
    res.update(k1_leg_launches=k1, k1_leg_vs_dense_max_rel=k1_rel,
               k1_leg_stage4=stage_events(cfg_k1)["stage4_online"][
                   "seconds"])
    rel = [metrics["global_rel_l2_nonshared"], commfree, *per_rank.values()]
    res["failures"] = [msg for bad, msg in (
        (not all(math.isfinite(x) for x in rel), f"non-finite rel-L2 {rel}"),
        (not warm_equal, "stage-4 warm-up rows differ from stage 1"),
        (k1 != steps, f"K1 launched {k1} times in the pallas stage 4, "
                      f"not once a step ({steps})"),
        (not k1_rel <= 1e-5, "the pallas stage 4 departs from the dense "
                             "one beyond 1e-5"),
    ) if bad]
    shutil.rmtree(root, ignore_errors=True)
    return res


def lstm_timing(S3, dev, seed=SEED, eager_epochs=2, replays=20):
    """Stage 3's epoch at the default shapes (float32, 22 Adam steps of
    batch 10, then validation): ms per epoch eager and graph-replayed
    (host clock around synchronized runs), and torch.profiler over one
    replay (the device's busy share, kernels per epoch: some 60,000
    events, which the profiler takes tens of seconds to sort per
    replay); then one stage-4 block's prediction (P = 2 models over a
    3,000-row window)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from savtpu_torch.config import SurrogateConfig
    from savtpu_torch.models.training import capture_epoch, stacked_epochs
    from savtpu_torch.pipeline.online_predictor import modal_predict_stacked

    X, Y, fm = lstm_windows(S3, seed)
    sur = SurrogateConfig(num_epochs=eager_epochs + replays + 10)
    ep = stacked_epochs(sur, X, Y, fm, device=dev)
    ep.load_chunk(0)
    ep.epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(eager_epochs):
        ep.epoch()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / eager_epochs
    graph = capture_epoch(ep)
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(replays):
        graph.replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in rows)
    rows.sort(key=lambda r: -r[1])
    res = {
        "adam_steps_per_epoch": ep.steps,
        "eager_ms_per_epoch": eager_ms,
        "replayed_ms_per_epoch": replay_ms,
        "replayed_us_per_adam_step": replay_ms * 1e3 / ep.steps,
        "device_busy_share": (busy_us * 1e-6 / wall) if rows
        else "not measured",
        "device_ms_per_epoch": (busy_us * 1e-3) if rows
        else "not measured",
        "kernels_per_epoch": sum(c for _, _, c in rows) if rows
        else "not measured",
        "top_kernels_ms_per_epoch": {k[:60]: t * 1e-3
                                     for k, t, _ in rows[:5]},
    }
    del graph
    model = ep.model
    sur = SurrogateConfig()
    rng = np.random.default_rng(seed)
    W = sur.n_past * sur.filter_size
    hist = torch.as_tensor(rng.normal(size=(2, W, S3)) * 1e-3,
                           dtype=torch.float32).to(dev)
    mx = torch.full((2,), 2e-3, device=dev)
    mn = torch.full((2,), -2e-3, device=dev)
    fmask = torch.as_tensor(fm, dtype=torch.float32).to(dev)
    modal_predict_stacked(model, hist, mx, mn, sur, None, fmask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        modal_predict_stacked(model, hist, mx, mn, sur, None, fmask)
    torch.cuda.synchronize()
    res["block_predict_ms"] = (time.perf_counter() - t0) * 1e3 / 10
    return res


def run_stages(cfg, dev):
    """The five stages through api.Simulation, timed one by one."""
    import torch

    from savtpu_torch import api

    sim = api.Simulation(cfg, device=dev, verbose=False)
    times = {}
    for name, fn in (("stage1_s", sim.generate_data),
                     ("stage2_s", sim.extract_shared),
                     ("stage3_s", sim.train),
                     ("stage4_s", sim.run_online),
                     ("stage5_s", sim.compare)):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = round(time.perf_counter() - t0, 3)
    return sim, res, times


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="slice depth in steps (a multiple of save_every, "
                         "50)")
    ap.add_argument("--keep-traces", type=Path, default=None,
                    help="a directory to save the stage-2 traces of the "
                         "slice's departing and median ranks in (for a "
                         "refit on another machine)")
    ap.add_argument("--lstm-epochs", type=int, default=LSTM_EPOCHS,
                    help="training epochs of the default-config (LSTM) "
                         "run in phase 3; 3450 is the published depth")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32",
                    help="the slice's state dtype in phase 3 (the "
                         "published run is float32)")
    opts = ap.parse_args(argv)
    steps = opts.steps
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "savtpu_torch" / "__init__.py").exists():
        print("chip_smoke: savtpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from savtpu_torch.io.artifacts import ArtifactStore, load_displacement
    from savtpu_torch.ops import kernels
    from savtpu_torch.ops.online_banded import (
        RTOL,
        online_chunk,
        online_chunk_plain,
    )
    from savtpu_torch.pipeline.common import build_context

    clock = Clock()
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    clock.phase(0, "device", kind=kind, count=count, nvidia_smi=smi,
                torch=torch.__version__, cuda=torch.version.cuda)

    built = kernels.build_all(["online_banded", "dense_step",
                               "banded_scan"])
    ptxas = [ln.strip() for b in built.values() for ln in b.log.splitlines()
             if any(k in ln for k in ("registers", "spill", "smem",
                                      "stack frame"))]
    for ln in ptxas:
        print(f"[ptxas] {ln}")
    clock.phase(1, "build", build_s={k: round(b.seconds, 3)
                                     for k, b in built.items()})

    tmp = Path(tempfile.mkdtemp(prefix="savtpu_torch_smoke_"))
    try:
        # ---- phase 2: the kernel against its plain version ----
        cfg = slice_config(tmp / "k3")
        ctx = build_context(cfg, device=dev)
        sp = ctx.sp
        Tc = cfg.surrogate.block_size
        args, kw = k3_inputs(sp, dev, Tc, SEED)
        P, nc, Bk, _ = sp.band_Kd.shape
        shapes = dict(P=P, nc=nc, Bk=Bk, S3=int(sp.sld.shape[1]), Tc=Tc,
                      save_every=SAVE_EVERY, dtype="float32")
        from savtpu_torch.ops.band_plan import band_plan, cluster_table
        from savtpu_torch.ops.dense_step import sm_count

        n_sm = sm_count(dev)
        tables = {name: cluster_table(name, torch.float32, dev)
                  for name in ("online_banded", "banded_scan")}
        k3_plan = band_plan(P, nc, Bk, torch.float32, n_sm,
                            tables["online_banded"])
        clock.phase(2, "band_plan", sm_count=n_sm,
                    max_active_clusters=tables, online_banded_plan=vars(
                        k3_plan))
        k3 = check_online_block(args, kw)
        torch.cuda.synchronize()
        clock.phase(2, "online_banded_vs_plain", shapes=shapes, **k3)
        if k3["failures"]:
            raise RuntimeError(f"online_banded: {k3['failures']}")
        max_abs_err = k3["max_abs_err"]
        # every launch shape the plan can take, forced, over 300 steps
        args_f, kw_f = k3_inputs(sp, dev, 300, SEED)
        refs = online_references(args_f, kw_f)
        for plan in band_shapes(nc, Bk, torch.float32,
                                tables["online_banded"]):
            res = check_online_block(args_f, kw_f, plan=plan, refs=refs)
            torch.cuda.synchronize()
            res.pop("rounding")
            res.pop("band")
            clock.phase(2, f"online_banded_b{plan.blocks}_r{plan.resident}"
                        "_vs_plain", **res)
            if res["failures"]:
                raise RuntimeError(f"online_banded {plan}: "
                                   f"{res['failures']}")
        del args_f, refs

        # K1, K2 and K4 at the shapes of the sweep cases that run them
        from savtpu_torch.benchmarks.sweep import build_case

        sweep_sp = {key: build_case(*case[:5], device=dev)[1]
                    for key, case in zip(SWEEP_PATH, sweep_path_cases())}
        sp48, sp96, sp96b, sp96b8 = (sweep_sp[k] for k in SWEEP_PATH)
        checks = {}
        for tag, sp_k in (("48x4x4_p8", sp48), ("96x8x8_p8", sp96)):
            rng = np.random.default_rng(SEED)
            d = torch.as_tensor(
                1e-3 * rng.standard_normal((sp_k.n_parts, sp_k.DL)),
                dtype=sp_k.dtype).to(dev) * sp_k.dof_mask
            checks[f"fint_matvec_{tag}"] = check_fint_matvec(sp_k.denseK, d)
        # K2 as planned at the sweep's three pallas cases (one block per
        # part with K resident; 16 blocks per part, resident; 16 per part,
        # streamed), then every launch shape forced at 48x4x4/8 and at a
        # tiny problem
        from savtpu_torch.ops.dense_step import forced_plan

        sp25 = build_case(25, 1, 1, 2, "pallas", device=dev)[1]
        checks["scan_comm_free_25x1x1_p2"] = check_scan_comm_free(
            sp25, 1000, SEED)
        checks["scan_comm_free_48x4x4_p8"] = check_scan_comm_free(
            sp48, 1000, SEED)
        checks["scan_comm_free_96x8x8_p8"] = check_scan_comm_free(
            sp96, 200, SEED)
        sp8 = build_case(8, 1, 1, 2, "pallas", device=dev)[1]
        for tag, sp_k, shapes in (
                ("48x4x4_p8", sp48, ((12, True), (16, False), (1, False))),
                ("8x1x1_p2", sp8, ((1, True), (3, True), (3, False)))):
            for blocks, resident in shapes:
                plan = forced_plan(sp_k.DL, sp_k.dtype, blocks, resident)
                name = (f"scan_comm_free_{tag}_b{plan.blocks}_"
                        f"{'resident' if resident else 'streamed'}")
                checks[name] = check_scan_comm_free(sp_k, 300, SEED,
                                                    plan=plan)
        checks["scan_comm_free_banded_96x8x8_p16"] = check_banded_scan(
            sp96b, 1000, SEED)
        checks["scan_comm_free_banded_96x8x8_p8"] = check_banded_scan(
            sp96b8, 300, SEED)
        # K4 in every launch shape the plan can take, forced at 96x8x8/16
        _, nc4, Bk4, _ = sp96b.band_Kd.shape
        refs = banded_scan_references(*banded_scan_inputs(sp96b, 300, SEED))
        for plan in band_shapes(nc4, Bk4, sp96b.dtype,
                                tables["banded_scan"]):
            checks[f"scan_comm_free_banded_96x8x8_p16_b{plan.blocks}_"
                   f"r{plan.resident}"] = check_banded_scan(
                sp96b, 300, SEED, plan=plan, refs=refs)
        del refs
        torch.cuda.synchronize()
        for check, res in checks.items():
            clock.phase(2, f"{check}_vs_plain", **res)
        failures = {n: r["failures"] for n, r in checks.items()
                    if r["failures"]}
        if failures:
            raise RuntimeError(f"kernel checks failed: {failures}")

        # the graph-replayed stepper against the eager loop (48x4x4/8
        # pallas, plain and compensated)
        sp48c = build_case(48, 4, 4, 8, "pallas", compensated=True,
                           device=dev)[1]
        graphs = check_graph_stepper([sp48, sp48c])
        clock.phase(2, "graph_stepper_vs_eager", **graphs)
        if graphs["failures"]:
            raise RuntimeError(f"graph stepper: {graphs['failures']}")
        del sp48c

        # the LSTM surrogate at the default run's shapes (S3 shared DOF
        # slots a rank; the 25x1x1 beam's interface plane)
        S3 = int(build_context(lstm_config(tmp / "lstm_shape", 1),
                               device=dev).sp.sld.shape[1])
        lstm_checks = check_lstm(S3, dev)
        clock.phase(2, "lstm_vs_cpu", S3=S3, **lstm_checks)
        if lstm_checks["failures"]:
            raise RuntimeError(f"LSTM: {lstm_checks['failures']}")

        # ---- phase 3: the slice through the user's entry points ----
        cfg = slice_config(tmp / "slice", steps, opts.dtype)
        online_chunk.launches = 0
        sim, metrics, times = run_stages(cfg, dev)
        launches = online_chunk.launches
        blocks = -(-(steps - cfg.surrogate.i_cri - 1)
                   // cfg.surrogate.block_size)
        events = {}
        for line in (Path(cfg.workdir) / "metrics.jsonl").read_text().splitlines():
            rec = json.loads(line)
            events[rec["event"]] = rec
        store = ArtifactStore(cfg.workdir, cfg.model_dir,
                              cfg.surrogate.run_tag())
        n_warm = (cfg.surrogate.i_cri + 1) // SAVE_EVERY
        err_sq = ref_sq = warm_err = 0.0
        per_rank = {}
        for r in range(cfg.partition.n_parts):
            exact = load_displacement(store.dynamics_h5(r))
            model = load_displacement(store.modeled_h5(r))
            if (exact.shape != model.shape
                    or exact.shape[1] != steps // SAVE_EVERY):
                raise RuntimeError(f"rank {r}: trajectory shapes {exact.shape}"
                                   f" vs {model.shape}")
            if not (np.isfinite(exact).all() and np.isfinite(model).all()):
                raise RuntimeError(f"rank {r}: non-finite trajectory")
            warm_err = max(warm_err, float(
                np.abs(exact[:, :n_warm] - model[:, :n_warm]).max()
                / max(np.abs(exact[:, :n_warm]).max(), 1e-30)))
            local = store.load_int_csv(store.local_nodes_csv(r))
            shared = set(store.load_int_csv(store.shared_csv(r)).tolist())
            keep = np.repeat([int(g) not in shared for g in local], 3)
            d = exact[keep, n_warm:] - model[keep, n_warm:]
            e2, r2 = float((d * d).sum()), float((exact[keep, n_warm:] ** 2).sum())
            per_rank[r] = math.sqrt(e2 / max(r2, 1e-300))
            err_sq += e2
            ref_sq += r2
        commfree = math.sqrt(err_sq / max(ref_sq, 1e-300))
        rel = [metrics["global_rel_l2_nonshared"], commfree,
               *per_rank.values()]
        clock.phase(
            3, "slice_96x8x8_p16",
            stage_s=times,
            stage1_steps_per_s=events["stage1_solve"]["steps_per_sec"],
            stage4_steps_per_s=events["stage4_online"]["steps_per_sec"],
            setup=events["setup_breakdown"],
            online_banded_launches=launches, blocks=blocks,
            plotter_metrics=metrics,
            commfree_rel_l2_nonshared=commfree,
            commfree_rel_l2_per_rank=per_rank,
            warmup_rows_max_rel_diff=warm_err,
        )
        if opts.keep_traces:
            keep_traces(opts.keep_traces, cfg, store, per_rank,
                        events["stage1_solve"]["dt"])
        if launches < max(blocks, 2):
            raise RuntimeError(
                f"online_banded launched {launches} times in the slice "
                f"(expected one per comm-free block, {blocks})"
            )
        if not all(math.isfinite(x) for x in rel):
            raise RuntimeError(f"non-finite rel-L2: {rel}")
        if warm_err > 1e-6:
            raise RuntimeError(
                f"stage-4 warm-up rows differ from stage 1: {warm_err:.3e}"
            )
        del sim

        # small run: stage 4 on the GPU (kernel) against the same stage on
        # the CPU (plain version), from the same stage 1-3 artifacts
        from savtpu_torch.pipeline import online_predictor, run_all

        c_cpu = small_config(tmp / "small_cpu")
        run_all.run(c_cpu, verbose=False, device="cpu")
        shutil.copytree(tmp / "small_cpu", tmp / "small_gpu")
        c_gpu = small_config(tmp / "small_gpu")
        online_predictor.run(c_gpu, verbose=False, device=dev)
        outs = []
        for c in (c_cpu, c_gpu):
            st = ArtifactStore(c.workdir, c.model_dir, c.surrogate.run_tag())
            outs.append(np.concatenate([
                load_displacement(st.modeled_h5(r)).ravel()
                for r in range(c.partition.n_parts)
            ]))
        small_err = float(np.abs(outs[1] - outs[0]).max()
                          / np.abs(outs[0]).max())
        small_rtol = RTOL[torch.float32]
        clock.phase(3, "small_stage4_gpu_vs_cpu", max_rel=small_err,
                    rtol=small_rtol)
        if not small_err <= small_rtol:
            raise RuntimeError(f"small run: GPU vs CPU {small_err:.3e}")

        # the sweep's cases on K1, K2 and K4, through bench_case
        sweep_rows, sweep_launches = run_sweep_path(dev)
        for row in sweep_rows:
            clock.phase(3, f"sweep_{row['mesh']}_p{row['n_parts']}_"
                        f"{row['fint_mode']}", **row)
        small = small_sweep_gpu_vs_cpu(dev)
        clock.phase(3, "small_sweep_gpu_vs_cpu", max_rel=small, rtol=1e-12)
        if not max(small.values()) <= 1e-12:
            raise RuntimeError(f"small sweep: GPU vs CPU {small}")

        # the default Config(): the LSTM-fed run at 100,000 steps, the
        # training cut to --lstm-epochs epochs; then its stage 4 on K1
        lstm_path = run_lstm_path(tmp / "lstm", dev, opts.lstm_epochs)
        clock.phase(3, "lstm_default_config", **lstm_path)
        if lstm_path["failures"]:
            raise RuntimeError(f"LSTM path: {lstm_path['failures']}")

        # ---- phase 4: timing ----
        bound_ms, bound_by, nbytes, flops = k3_bound(args, Tc, SAVE_EVERY)
        torch.cuda.reset_peak_memory_stats()

        kern, plain_ms, plain_runs = in_turns(
            lambda: online_chunk_plain(*args, **kw),
            lambda: online_chunk(*args, **kw), 1, 5)
        clock.phase(4, "online_banded_timing", ms=kern, plain_ms=plain_ms,
                    plain_ms_runs=plain_runs, bound_ms=bound_ms,
                    bound_by=bound_by, bytes=nbytes, flops=flops,
                    bound_band_reread_ms=band_reread_ms(args[0], Tc),
                    plan=vars(k3_plan),
                    max_active_clusters=tables["online_banded"],
                    max_memory_allocated=torch.cuda.max_memory_allocated())
        steps_of = {k: c[5] for k, c in zip(SWEEP_PATH, sweep_path_cases())}
        timing = {
            "fint_matvec_48x4x4_p8": time_fint_matvec(sp48, SEED),
            "fint_matvec_96x8x8_p8": time_fint_matvec(sp96, SEED),
            "scan_comm_free_48x4x4_p8": time_scan(
                sp48, steps_of[SWEEP_PATH[0]]),
            "scan_comm_free_96x8x8_p8": time_scan(
                sp96, steps_of[SWEEP_PATH[1]]),
            "scan_comm_free_banded_96x8x8_p16": time_banded_scan(
                sp96b, steps_of[SWEEP_PATH[2]]),
            "scan_comm_free_banded_96x8x8_p8": time_banded_scan(
                sp96b8, steps_of[SWEEP_PATH[3]]),
        }
        for what, res in timing.items():
            clock.phase(4, f"{what}_timing", **res)
        clock.phase(4, "exchanged_stepper_profile",
                    **stepper_profile(ctx.sp, dev, steps=300))
        clock.phase(4, "lstm_epoch_timing", **lstm_timing(S3, dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "online_banded",
        "route": "cuda",
        "source": "savtpu_torch/csrc/online_banded.cu",
        "replaces": "savtpu/ops/pallas_banded.py:234",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kern,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sweep_launches[name],
        "max_abs_err": checks[f"{name}_{tag}"]["max_abs_err"],
        "ms": timing[f"{name}_{tag}"]["ms"],
        "plain_ms": timing[f"{name}_{tag}"]["plain_ms"],
        "bound_ms": timing[f"{name}_{tag}"]["bound_ms"],
        "bound_by": timing[f"{name}_{tag}"]["bound_by"],
        "library_ms": timing[f"{name}_{tag}"].get("library_ms"),
        **({"launches_lstm_stage4_pallas": lstm_path["k1_leg_launches"]}
           if name == "fint_matvec" else {}),
    } for name, source, replaces, tag in (
        ("fint_matvec", "savtpu_torch/csrc/dense_step.cu",
         "savtpu/ops/pallas_step.py:59", "96x8x8_p8"),
        ("scan_comm_free", "savtpu_torch/csrc/dense_step.cu",
         "savtpu/ops/pallas_step.py:97", "96x8x8_p8"),
        ("scan_comm_free_banded", "savtpu_torch/csrc/banded_scan.cu",
         "savtpu/ops/pallas_banded.py:55", "96x8x8_p16"),
    )]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
