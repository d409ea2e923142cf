#!/usr/bin/env python3
"""Drive savtpu_torch's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--steps N] [--dtype float32|float64]
                          [--lstm-steps N] [--lstm-epochs E] [--nh-steps N]
                          [--surrogate-epochs E] [--leg-epochs E]
                          [--tube-steps N] [--pcg-big]

``--steps`` sets the depth of the slice and of irregular_96 (default
9,000; 100,000 is the published schedule); ``--lstm-steps`` the default
configuration's (default 50,000, cut from the published 100,000 when the
mesh path's float32 envelope came: most of its stages 1, 4 and 5 is the
save_every-1 trajectory's .npz writes and reads); ``--dtype`` the slice's state
dtype in phase 3 (default float32, as published; float64, also
compensated so that it runs the same kernel, separates round-off from
the rest). ``--lstm-epochs`` sets the default configuration's training
depth (default 60, cut from the published 3,450 to keep the script
within about 560 s: 300 until the unstructured paths came, 200 until the
serial-solver and steady paths did, 150 until the device-mesh path did,
120 until the bench did, 80 until the mesh path's float32 envelope
did); ``--nh-steps`` nh_box_96's depth (default
36,000, which lets expfit fit past the load ramp with 83 stored rows, 64
needed; 50,000 until the serial-solver and steady paths came, 40,000
until the bench did; 100,000 published); ``--surrogate-epochs`` the
training epochs of the hybrids (nh_box_96's and tube_hybrid's residual
LSTMs, default 30: 100 until the serial-solver and steady paths came, 60
until the device-mesh path did, 40 until the bench did); ``--leg-epochs``
those of the
default run's ensemble and per-rank legs (default 6: 100 until the
unstructured paths came, 50 until the solver-options paths did, 30 until
the serial-solver and steady paths did, 20 until the device-mesh path
did, 12 until the bench did, 8 until the mesh path's float32 envelope
did; their stages 4-5 run the first 12,000 of
its steps, 30,000 until the serial-solver and steady paths came,
21,000 until the device-mesh path did); ``--tube-steps``
tube_hybrid's depth (default 45,000, which clears its load ramp by 127
stored rows; 60,000 until the serial-solver and steady paths came;
100,000 published). The stage-3 epoch timing of phase 4 replays 10 epochs (20
until the unstructured paths came). ``--pcg-big`` adds the steady solve
of the 192x12x12 beam (97,851 DOFs) by two-level PCG and by SciPy's
direct solver, both timed, to phase 2 (``steady_pcg_192x12x12``).

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
   forced, over 300 steps; what a rank of a four-card mesh computes for
   its 4 of the slice's 16 parts (``online_banded_block_of_4_vs_16``: K3
   on those parts alone, as band_plan plans 4 parts, and the band
   matvec, against their rows of the 16-part batch; a reading, no
   check); K1, K2 (with and without predictions, shared
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
   graph-replayed epochs against eager ones, bit for bit; then the
   surrogate slice (``surrogates_vs_cpu``), card against CPU: the
   hybrid's block (expfit base + residual LSTM) at nh_box_96's widths,
   the ridge map's predict and a seed ensemble's averaged block at the
   default run's (float64 within 1e-12, float32 within 1e-5; controls:
   no base, float32 or TF32 products, member 0 alone), one float64
   per-rank epoch with mixed teacher forcing and dropout from injected
   draws (1e-10; control: other draws), and replayed per-rank epochs
   against eager ones, bit for bit (control: another seed); then the
   structured-box slice in float64: the Neo-Hookean stencil force on the
   card against the incident-list force on the CPU at 8x4x4/16 and
   96x8x8/16 (strain near 1e-2; control: the linear stencil force), a
   200-step exchanged Neo-Hookean run with the grid exchange against
   psum at 8x4x4/16 (control: the grid exchange without its z pass),
   and the linear stencil force against the dense K d (control: one tet
   type dropped), each within 1e-12; then the unstructured slice: the
   native partition route and the .msh round trip of the irregular beam
   96x8x8 (binary and ASCII 2.2, binary 4.1, and .vtu: points and tets
   equal exactly), K3 at irregular_96's band (16 graph parts, nc 4, Bk
   512, S3 804) as band_plan plans it, with the slice's checks and
   control; in float64, the windowed Neo-Hookean force on the card
   against the incident-list force on the CPU at irregular 96x8x8/16
   graph and tube 2x24x48/8 RCB (control: every window start shifted by
   one node), the tube's linear stencil against K d and its Neo-Hookean
   stencil against the incident list at tube 2x24x48 in 3 and 4 parts
   (full rings) and 4x48x256 in 64 (seam-wrapped parts; control: each
   part's last theta column of cells dropped), and 200 exchanged steps
   at 4x48x256/64 with the seam-wrapped grid exchange against psum
   (control: the seam pair dropped), each within 1e-12; then the
   solver-options slice in float64: the ell and ebe forces at the
   sweep's 96x8x8/64 against the dense K d (controls: ell columns
   shifted by one node, one ebe element dropped), 200 exchanged steps
   with the permute exchange against psum at 48x4x4/8 (control: its last
   round dropped), each within 1e-12; the blend's endpoints, plain and
   compensated (w = 1 the exchanged run, w = 0 the comm-free overwrite,
   1e-12; control w = 1/2), and blended, ell, ebe and permute runs
   replayed from CUDA graphs against the eager loop, bit for bit; the
   unramped load's ghost step on the card against the CPU, dense on the
   default beam (1e-12) and CG on a 42x6x6 beam of 6,321 DOFs (1e-10;
   control: the CG stopped at half its iterations); then the
   serial-solver and steady slice in float64: the serial explicit runner
   over FIntOperator dense, ebe and bcoo on the card against the CPU, and
   the card's 2-part exchanged run against it, on the default beam over
   2,000 steps, "auto" resolving as savtpu's (1e-12; control: one
   element's K_e zeroed); NeoHookeanFIntOperator's serial run on the
   card against the sharded Neo-Hookean stencil run at nh_box_96's
   layout (96x8x8, 16 box parts, grid exchange) over 200 steps from rest
   (1e-8; control: one element dropped); the steady routes: the dense
   route on the default beam card against CPU (1e-10), two-level PCG at
   96x8x8 (23,571 DOFs) against SciPy's direct solve (1e-7; residual at
   most twice the direct's, both solves timed; control: PCG stopped at an
   eighth of its iterations), ``eigen_modes`` card against CPU (1e-10);
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
   the headline bench through ``savtpu_torch.benchmarks.bench.main`` at
   its full 30,000 steps a run (96x8x8/16 scale row: 4,000), K2 three
   times, all in its pallas leg, and K1, K3 and K4 never, every rate and
   vs_baseline finite and above 0, its line with exactly the JAX
   package's six keys (the line, every rep's rate and the roofline rows
   printed), and ``benchmarks.train_bench.main`` at 3 epochs (its
   default 50); then the default ``Config()`` (25x1x1 beam, 2 parts,
   dense, float64, the stacked LSTM surrogate) through the same stages
   at ``--lstm-steps`` steps, the training cut to ``--lstm-epochs``: stage
   seconds, epochs/s and Adam steps/s, the rel-L2, the warm-up rows
   equal to stage 1's bit for bit; and its stage 4 again from a copy in fint_mode "pallas",
   over its first 12,000 steps, where K1 must launch once a step and the
   result stay within 1e-5 of the dense run; then stages 3-5 on its
   stage 1-2 artifacts again with the linear surrogate, a seed ensemble
   of 2 and per-rank LSTMs with mixed teacher forcing and dropout (``default_config_*``: stage
   seconds, epochs/s, ridge lambdas, rel-L2, warm-up rows bit for bit);
   and nh_box_96 (96x8x8, 16 box parts, Neo-Hookean on the stencil, the
   grid exchange, float32 compensated, expfit order 16 modal 16 on the
   first 75% of 36,000 steps) through the same stages: stage seconds and
   stepping rates, the built problem's mode, stencil dims and exchange,
   every rank's expfit past the load ramp (not the frozen-ramp
   fallback), warm-up rows equal to stage 1's bit for bit, the rel-L2
   globally and per rank; then stages 3-5 of it again with the hybrid
   (``nh_box_96_hybrid``: the residual LSTMs at full width, residual over
   signal per rank, epochs/s, the rel-L2 beside expfit's); no path may
   launch K1-K4; then the sweep's Neo-Hookean row through
   ``bench_case``; and the unstructured slice: irregular_96 (the
   irregular beam 96x8x8 read from its binary .msh, 16 graph parts,
   banded, float32 compensated, psum, expfit order 16 modal 8, no
   consensus, cut-off 0.75, --steps deep) with K3 once per comm-free
   block, and tube_hybrid (tube 2x24x48 read from an ASCII .msh, clamped
   at z = 0, 8 RCB parts, dense, float32 compensated, the stacked hybrid
   with expfit order 16 modal 16, cut-off 0.75, consensus on, 45,000
   steps), each with its stage seconds, rates, rel-L2 globally and per
   rank, warm-up rows bit for bit, K1-K4 launches counted from 0, and
   stage 1's steady solve (route, PCG iterations, seconds) against
   SciPy's direct solve (seconds, distance within 1e-7); and
   the solver-options slice: ``slice_resync`` (the slice's stage 4 again
   from its stage 1-3 artifacts with ``resync_blocks = 1``: one K3 block,
   one blended exchanged block without a kernel, warm-up rows bit for
   bit, the rel-L2 beside the slice's), ``checkpoint_resume`` (the
   stage-1 command line on the default beam at 15,000 steps with
   ``--ckpt-every 5000``, killed after its checkpoint at step 10,000 and
   resumed with ``--resume``, and slice_resync's stage 4 with
   checkpoints killed after its warm-up checkpoint and resumed: both bit
   for bit against uninterrupted runs, the checkpoints gone),
   ``unramped_beam`` (the default beam with ``material.ramped = False``
   through stage 1 at 5,000 steps: the ghost step nonzero, the run
   finite) and the sweep's ell and permute cases (96x8x8/64 ell,
   48x4x4/8 and 96x8x8/64 dense permute, 192x12x12/64 banded permute
   with K4 once per comm-free run; 384x16x16/256 left out for time);
   and the serial-solver and steady slice: ``p2_steady`` (the stage-1
   command line at ``solver.deg = 2`` on a 48x4x4 beam, 23,571 DOFs by
   PCG, on the card and with ``--device cpu``: the VTK written, the two
   within 1e-8, the tip within 30% of Euler-Bernoulli, build_context
   refusing deg = 2 with savtpu's message) and ``stage3_grid`` (the
   stage-3 command line with ``--grid-lrs`` of two rates at 10 epochs on
   the default run's stage 1-2 artifacts: two run-tag directories, each
   rank's model.npz, finite losses, seconds); and the device mesh
   (``mesh_slice_96x8x8_p16``: the slice's stages 1 and 4 over NCCL
   ranks, one process and one card each, as many as the cards allow that
   divide 16, from a copy of the slice's stage 2-3 artifacts, K3 once a
   comm-free block on every rank; ``mesh_default_pallas_stage1``: the
   default configuration's stage 1 in pallas mode over the first 3,000
   of its steps, K1 once a step on every rank; each held against the
   emulated run, bit for bit at one rank, within 1e-12 in float64 and
   1e-4 for the float32 slice over several; per-rank stage seconds
   beside the emulated ones; the float32 slice's envelope: its stages 1
   and 4 again in float64, and the mesh's departure from the emulated
   run and from the float64 run each within 3 times the emulated run's
   own departure from the float64 run; ``mesh_linear_fit``: the linear
   surrogate's ``fit_stacked(mesh=)`` over the slice's ranks, the
   blocks and every rank's history equal to the unsharded fit's bit
   for bit);
4. kernel timing with CUDA events: kernel, plain version, bound (and for
   K2, K3 and K4 the floor of re-reading the operator from HBM every
   step), the plan K3 and K4 ran with, the PyTorch call that computes
   the same function where there is one (K1: torch.bmm, both as device
   time from 100 calls replayed in one CUDA graph, and as eager issue
   time), peak device memory; and a torch.profiler look at the
   graph-replayed exchanged stepper (device busy share, longest
   kernels); stage 3's training epoch eager and graph-replayed, the
   replayed epoch's busy share and kernel count, and one stage-4 block's
   LSTM prediction; and the same profile of nh_box_96's exchanged and
   comm-free steps (kernels per step, device ms per step, busy share);
   K3 timed at irregular_96's band the same way, with its bound; the
   same profile of irregular_96's exchanged banded step, of the tube
   4x48x256/64 stencil step with the seam-wrapped grid exchange, and of
   the irregular 96x8x8/16 Neo-Hookean step in the windowed layout and
   with the incident list; then ``roofline_profile_offload``: the share
   of the HBM peak (``utils/roofline.py``: bytes_floor_per_step over the
   measured steps/s; K3's and K4's with their band plan, less the rows
   they keep resident) of the slice's exchanged stepper, of K3's online
   block at the slice and of the sweep's K1 and K4 rows, none above
   100%; ``profile_trace`` around 100 replayed slice
   steps (its Chrome trace names the step's kernels), and ``fetch_into``
   against one direct copy and a bulk ``.cpu()`` of the slice's
   trajectory and of its full-depth size, GB/s each.

``--keep-traces DIR`` saves the slice's departing and median ranks'
stage-2 traces for ``scripts/c2_refit_witness.py``.

The last line is {"ok": true, "device": {...}}; the line before it is
nvidia-smi's, and before that a {"kernels": [...]} summary. Any failure
exits non-zero. Everything is written under a temporary directory outside
the checkout, except the kernel libraries (savtpu_torch/_build/).
"""

from __future__ import annotations

import gc
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
# epochs so that the script, with the surrogate legs and the unstructured
# paths, stays within about 560 s (PERF.md); --lstm-epochs 3450 runs it
# in full (300 until the unstructured slice took 34 s of its stage 3,
# 200 until the serial-solver and steady slice took about 30 s, 150 until
# the device-mesh path took 23 s, 120 until the bench took about 30 s,
# 80 until the mesh path's float32 envelope took 11 s)
LSTM_EPOCHS = 60
# the default-config run's depth, cut from the published 100,000 steps
# (at save_every 1 most of its stages 1, 4 and 5 and of its legs' stage 3
# is the trajectory's .npz writes and reads and the windows it yields);
# --lstm-steps 100000 runs it in full (100,000 until the mesh path's
# float32 envelope came and a slow host took the script past 560 s)
LSTM_STEPS = 50_000
# nh_box_96's depth: 0.75 x 36,000 steps clears the 1 s load ramp (step
# 22,825 at its dt of 4.38e-5 s) by 83 stored rows, more than the 64 that
# expfit's post-ramp segment needs at order 16, so that stage 3 fits it
# (the published depth is 100,000; 50,000 until the serial-solver and
# steady slice needed the time, 40,000 until the bench did)
NH_STEPS = 36_000
# training epochs of the hybrids' residual LSTMs (nh_box_96, tube_hybrid),
# cut from the published 3,450 (100 until the serial-solver and steady
# slice, 60 until the device-mesh path, 40 until the bench; at 100 the
# residual LSTMs learned nothing, R^2 about 0)
SURROGATE_EPOCHS = 30
# training epochs of the default run's ensemble and per-rank legs (100
# until the unstructured slice took 25 s of them, 50 until the
# solver-options slice took 12 s more, 30 until the serial-solver and
# steady slice, 20 until the device-mesh path, 12 until the bench, 8
# until the mesh path's float32 envelope)
LEG_EPOCHS = 6
# the depth of the default run's second, pallas-mode stage 4: the warm-up
# and three whole 3,000-step blocks (100,000 until the solver-options
# slice needed its time, 21,000 until the device-mesh path did; most of
# it went to compressed .npz writes)
K1_LEG_STEPS = 12_000
# the depth of the surrogate legs' stages 4-5 on the default run's stage
# 1-2 artifacts: the warm-up and three whole 3,000-step blocks (100,000
# until the sweep's 96x8x8/64 permute check and run-to-run spread needed
# the time, 30,000 until the serial-solver and steady slice did, 21,000
# until the device-mesh path did; their stage 4 is mostly compressed .npz
# writes)
LEG_STEPS = 12_000
# the card's peaks, HBM bytes/s and float32 FLOP/s off the tensor cores:
# set in main from savtpu_torch.utils.roofline.device_peaks (the H100 SXM
# data sheet's 3.35e12 and 67e12), the table the package's roofline reads
PEAK_BYTES = PEAK_F32 = None


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


# the bench's JSON line has exactly the JAX package's keys (root bench.py)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "scale_96x8x8_16shards_steps_per_sec",
              "scale_96x8x8_16shards_elem_updates_per_sec"}
# train_bench's depth here, cut from its default of 50 epochs: its host
# loop takes 1-3.8 s an epoch on the card's machine (PERF.md; 5 until a
# slow host took 36 s for them)
TRAIN_BENCH_EPOCHS = 3


def run_bench_path(root: Path):
    """The port's headline bench through ``benchmarks/bench.main`` at its
    full sizes (30,000 steps a headline run, 4,000 at the 96x8x8/16 scale
    row), its details written under ``root``: the launch counts are set to
    0 just before and read just after. K2 must launch 3 times, all in the
    pallas leg (the untimed run and 2 reps), and K1, K3 and K4 never; every
    rate and vs_baseline finite and above 0; the line with exactly the JAX
    package's keys. Then ``benchmarks/train_bench.main`` at
    TRAIN_BENCH_EPOCHS epochs, launching none. Returns ({"bench": ...,
    "train_bench": ...} readings with "failures", the bench's line, the
    bench's launch counts)."""
    import contextlib
    import io

    from savtpu_torch.benchmarks import bench, train_bench

    details = root / "bench_details.json"
    out = io.StringIO()
    zero_kernel_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--details", str(details)])
    bench_s = time.perf_counter() - t0
    launches = linear_kernel_launches()
    text = out.getvalue().strip().splitlines()[-1]
    line = json.loads(text)
    d = json.loads(details.read_text())
    scale = d["scale_96x8x8_16shards"]
    rates = [line.get(k) for k in sorted(BENCH_KEYS - {"metric", "unit"})]
    rates += [r for reps in d["rep_steps_per_sec"].values() for r in reps]
    rates += [r for reps in scale["rep_steps_per_sec"].values() for r in reps]
    rates += d["numpy_reference_rep_steps_per_sec"]
    legs = {**d["kernel_launches"],
            **{f"scale_{m}": n for m, n in scale["kernel_launches"].items()}}
    k2_by_leg = {leg: n["scan_comm_free"] for leg, n in legs.items()}
    others = {k: n for k, n in launches.items() if k != "scan_comm_free"}
    res = {
        "bench_s": bench_s,
        "device": d["device"],
        "problem": d["problem"],
        "steps": d["steps"],
        "sync_avoiding_mode": d["sync_avoiding_mode"],
        "sync_avoiding_by_mode": d["sync_avoiding_by_mode"],
        "exchanged_steps_per_sec": d["exchanged_steps_per_sec"],
        "rep_steps_per_sec": d["rep_steps_per_sec"],
        "untimed_run_s": d["untimed_run_s"],
        "vs_baseline": line.get("vs_baseline"),
        "numpy_reference_rep_steps_per_sec":
            d["numpy_reference_rep_steps_per_sec"],
        "scale": {k: scale[k] for k in (
            "mesh", "elements", "n_parts", "fint_mode", "by_mode", "steps",
            "rep_steps_per_sec", "untimed_run_s")},
        "roofline": {**d["roofline_toy"],
                     **{f"scale_{m}": r
                        for m, r in scale["roofline"].items()}},
        "kernel_launches": launches,
        "k2_launches_by_leg": k2_by_leg,
    }
    res["failures"] = [msg for bad, msg in (
        (rc != 0, f"bench.main returned {rc}"),
        (set(line) != BENCH_KEYS, f"the line's keys are {sorted(line)}"),
        (not all(isinstance(x, (int, float)) and math.isfinite(x) and x > 0
                 for x in rates),
         f"a rate is not finite and above 0: {rates}"),
        (launches["scan_comm_free"] != 3 or k2_by_leg.get("pallas_avoid") != 3
         or sum(k2_by_leg.values()) != 3,
         f"K2 launched {launches['scan_comm_free']} times, by leg "
         f"{k2_by_leg} (expected 3, all in the pallas leg)"),
        (any(others.values()), f"K1, K3 or K4 launched: {others}"),
    ) if bad]

    train_out = root / "train_bench.json"
    zero_kernel_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = train_bench.main(["--epochs", str(TRAIN_BENCH_EPOCHS), "--out",
                               str(train_out)])
    tb = json.loads(train_out.read_text())
    tb["train_bench_s"] = time.perf_counter() - t0
    tb["k1_k4_launches"] = linear_kernel_launches()
    numbers = [tb[k] for k in ("savtpu_seconds_incl_compile",
                               "savtpu_steady_sec_per_epoch",
                               "torch_cpu_sec_per_epoch")]
    tb["failures"] = [msg for bad, msg in (
        (rc != 0, f"train_bench.main returned {rc}"),
        (not all(math.isfinite(x) and x > 0 for x in numbers),
         f"a time is not finite and above 0: {numbers}"),
        (not all(math.isfinite(x) for x in tb["final_losses"].values()),
         f"non-finite losses {tb['final_losses']}"),
        (any(tb["k1_k4_launches"].values()),
         f"train_bench launched a linear kernel: {tb['k1_k4_launches']}"),
    ) if bad]
    return {"bench": res, "train_bench": tb}, text, launches


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


def stepper_profile(sp, dev, steps, sync=True, save_every=1):
    """Wall and device time per step of the stepper at a problem's shapes,
    replayed from its CUDA graphs, from torch.profiler: the device's busy
    share, kernels per step and the five longest kernels. ``sync`` True
    is the exchanged (stage-1) step recording the trajectory; False the
    comm-free (stage-4) step with zero predictions, recording everything
    every ``save_every`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    d0 = torch.zeros((sp.n_parts, sp.DL), dtype=sp.dtype, device=dev)
    kw = dict(sync=True, record="traj", save_every=save_every)
    if not sync:
        kw = dict(sync=False, record="all", save_every=save_every,
                  preds=torch.zeros((sp.n_parts, steps, sp.sld.shape[1]),
                                    dtype=sp.dtype, device=dev))
    # warm-up: captures the graph chunks the profiled run replays
    sp.stacked_run(d0, d0, 0.0, steps, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sp.stacked_run(d0, d0, 0.0, steps, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # kernel events only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    rows = [(e.key, e.self_device_time_total) for e in events]
    busy_us = sum(t for _, t in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "steps": steps, "sync": sync,
        "kernels_per_step": (sum(e.count for e in events) / steps
                             if rows else "not measured"),
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

def lstm_config(workdir: Path, epochs: int, fint_mode: str = "auto",
                steps: int | None = None):
    """The default Config() (25x1x1 beam, 2 RCB parts, dense, float64,
    100,000 steps at save_every 1, the stacked LSTM surrogate), with the
    training cut to ``epochs`` epochs (the published 3,450 with
    --lstm-epochs 3450) and, given ``steps``, the run to that many."""
    from savtpu_torch.config import Config

    cfg = Config()
    cfg.workdir = str(workdir / "Results")
    cfg.model_dir = str(workdir / "Distributed_save")
    cfg.solver.fint_mode = fint_mode
    cfg.surrogate.num_epochs = epochs
    if steps is not None:
        cfg.solver.num_steps = steps
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


def seeded_draws(seed, sizes, n_train, n_past, n_future, H2, L, p_enc,
                 p_dec):
    """Per-epoch shuffles, coins and keep masks for one per-rank model,
    made from a seed with numpy: ``fit``'s injected draws, the same on
    the card and on the CPU."""
    import numpy as np

    def draws(e):
        rng = np.random.default_rng([seed, e])
        out = {"perm": rng.permutation(n_train)[None], "coins": [],
               "enc": [], "dec": []}
        for B in sizes:
            out["coins"].append(rng.uniform(size=(1, n_future)))
            out["enc"].append(rng.uniform(size=(L - 1, n_past, 1, B, H2))
                              < 1.0 - p_enc)
            out["dec"].append(rng.uniform(size=(n_future, 1, B, H2))
                              < 1.0 - p_dec)
        return out

    return draws


def check_surrogates(S3, S3_slice, dev, seed=SEED):
    """Phase-2 checks of the surrogate slice, each on the card against
    the CPU with the same inputs (made from a seed), each with a control
    the same comparison must reject:
    - the hybrid's block (expfit base + residual LSTM, ``hybrid_block``)
      at nh_box_96's widths (P = 16, 16 modes, H 50, n_s = 150 windows,
      the 96x8x8/16 slice's shared width): float64 within 1e-12, float32
      within 1e-5; control: the block without its base;
    - the ridge map's predict (``StackedLinear``, the default run's
      P = 2 and width): 1e-12 / 1e-5; control: the float64 map's product
      in float32, the float32 map's in TF32;
    - a seed ensemble's averaged block (``modal_predict_stacked`` with
      ens = 2): 1e-12 / 1e-5; control: member 0 alone;
    - one float64 per-rank epoch with mixed teacher forcing and dropout,
      with injected draws (``fit``): 1e-10; control: other draws on the
      CPU;
    - per-rank epochs replayed from a CUDA graph against eager ones on
      the card, bit for bit; control: another seed's eager epochs."""
    import numpy as np
    import torch

    from savtpu_torch.config import SurrogateConfig
    from savtpu_torch.models.data import train_val_split
    from savtpu_torch.models.linear import StackedLinear
    from savtpu_torch.models.lstm import StackedSeq2Seq
    from savtpu_torch.models.training import fit, rank_epochs
    from savtpu_torch.pipeline.online_predictor import (
        hybrid_block,
        modal_predict_stacked,
        modal_reconstruct,
    )

    sur = SurrogateConfig()
    W = sur.n_past * sur.filter_size
    T = sur.n_future * sur.filter_size
    lim = {torch.float64: 1e-12, torch.float32: 1e-5}
    res = {"limits": {"float64": 1e-12, "float32": 1e-5,
                      "per_rank_epoch_f64": 1e-10, "graph_vs_eager": 0.0}}

    def on(dev_, *ts):
        return [t.to(dev_) if torch.is_tensor(t) else t for t in ts]

    # the hybrid block at nh_box_96's widths
    P, K = 16, 16
    rng = np.random.default_rng(seed)
    basis = np.stack([np.linalg.qr(rng.normal(size=(S3_slice, K)))[0].T
                      for _ in range(P)])
    mu = rng.normal(size=(P, S3_slice)) * 1e-3
    coefs = rng.normal(size=(P, T, K)) * 1e-3
    hist = rng.normal(size=(P, W, S3_slice)) * 1e-5
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[1]
        net = StackedSeq2Seq(P, K, 50, dtype=dtype,
                             generator=torch.Generator().manual_seed(seed))
        t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
        modal = (t(mu), t(basis), torch.ones((P, K), dtype=dtype))
        fmask = torch.ones((P, S3_slice), dtype=dtype)
        mx, mn = t(np.full(P, 2e-5)), t(np.full(P, -2e-5))
        outs = {}
        for where in ("cpu", dev):
            m = net.to(where)
            md = tuple(a.to(where) for a in modal)
            fm, h, c, x, y = on(where, fmask, t(hist), t(coefs), mx, mn)
            base = modal_reconstruct(c, md, fm)
            outs[str(where)] = (hybrid_block(m, h, x, y, sur, md, fm, base),
                                base)
        full_cpu = outs["cpu"][0]
        full_card, base_card = outs[str(dev)]
        res[f"hybrid_block_{tag}"] = rel_max(full_card, full_cpu)
        res[f"hybrid_block_{tag}_control_no_base"] = rel_max(
            full_card - base_card, full_cpu)
    # the ridge map at the default run's widths
    P = 2
    was = torch.backends.cuda.matmul.allow_tf32
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[1]
        W_ = rng.normal(size=(P, sur.n_past * S3, sur.n_future * S3))
        arrays = {"lin.W": W_ / np.sqrt(W_.shape[1]),
                  "lin.b": rng.normal(size=(P, sur.n_future * S3)) * 1e-2}
        x = torch.as_tensor(rng.uniform(-1, 0, (P, sur.filter_size,
                                               sur.n_past, S3)), dtype=dtype)
        lin = StackedLinear.from_arrays(arrays, sur.n_past, dtype=dtype)
        with torch.no_grad():
            ref = lin.predict(x, sur.n_future)
            lin = lin.to(dev)
            got = lin.predict(x.to(dev), sur.n_future)
            if dtype == torch.float64:
                # control: the product in float32
                ctl = lin.to(torch.float32).predict(
                    x.to(dev, torch.float32), sur.n_future)
            else:
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    ctl = lin.predict(x.to(dev), sur.n_future)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = was
        ctl_name = "float32" if dtype == torch.float64 else "tf32"
        res[f"linear_predict_{tag}"] = rel_max(got, ref)
        res[f"linear_predict_{tag}_control_{ctl_name}"] = rel_max(ctl, ref)
    # a seed ensemble of 2 at the default run's widths
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[1]
        net = StackedSeq2Seq(2 * P, S3, 50, dtype=dtype,
                             generator=torch.Generator().manual_seed(seed))
        h = torch.as_tensor(rng.normal(size=(P, W, S3)) * 1e-3, dtype=dtype)
        mx = torch.full((P,), 2e-3, dtype=dtype)
        mn = torch.full((P,), -2e-3, dtype=dtype)
        fm = torch.ones((P, S3), dtype=dtype)
        ref = modal_predict_stacked(net, h, mx, mn, sur, None, fm, ens=2)
        net = net.to(dev)
        h, mx, mn, fm = on(dev, h, mx, mn, fm)
        got = modal_predict_stacked(net, h, mx, mn, sur, None, fm, ens=2)
        one = StackedSeq2Seq.from_arrays(
            {k: v[:P] for k, v in net.arrays().items()}, dtype=dtype,
            device=dev)
        ctl = modal_predict_stacked(one, h, mx, mn, sur, None, fm)
        res[f"ensemble_predict_{tag}"] = rel_max(got, ref)
        res[f"ensemble_predict_{tag}_control_member0"] = rel_max(ctl, ref)
    # per-rank epochs with mixed teacher forcing and dropout
    X, Y, _ = lstm_windows(S3, seed, P=1)
    tr, va = train_val_split(X.shape[1], sur.train_portion,
                             np.random.default_rng(seed))
    data = (X[0][tr], Y[0][tr], X[0][va], Y[0][va])
    cfg = SurrogateConfig(dtype="float64", num_epochs=1,
                          training_method="mtf", dropout_encoder=0.1,
                          dropout_decoder=0.1)
    sizes = rank_epochs(cfg, *data, device="cpu").batch_sizes()
    draws = [seeded_draws(seed + k, sizes, len(tr), sur.n_past,
                          sur.n_future, 2 * sur.hidden_size,
                          sur.num_layers_encoder, 0.1, 0.1)
             for k in (0, 1)]

    def run_fit(c, device, d=None, replay=None):
        m, h = fit(c, *data, device=device, log_every=0, draws=d,
                   replay=replay)
        return list(m.arrays().values()) + [np.asarray(h[k])
                                            for k in sorted(h)]

    card = run_fit(cfg, dev, draws[0])
    cpu = run_fit(cfg, "cpu", draws[0])
    ctl = run_fit(cfg, "cpu", draws[1])
    res["per_rank_epoch_f64"] = max(rel_max(a, b) for a, b in zip(card, cpu))
    res["per_rank_epoch_f64_control_other_draws"] = max(
        rel_max(a, b) for a, b in zip(card, ctl))
    cfg32 = SurrogateConfig(num_epochs=3, training_method="mtf",
                            dropout_encoder=0.1, dropout_decoder=0.1)
    graph = run_fit(cfg32, dev, replay=True)
    eager = run_fit(cfg32, dev, replay=False)
    other = run_fit(SurrogateConfig(num_epochs=3, training_method="mtf",
                                    dropout_encoder=0.1, dropout_decoder=0.1,
                                    seed=1), dev, replay=False)
    res["per_rank_graph_vs_eager"] = max(float(np.abs(a - b).max())
                                         for a, b in zip(graph, eager))
    res["per_rank_graph_vs_eager_control_seed"] = max(
        float(np.abs(a - b).max()) for a, b in zip(graph, other))
    checks = [(f"{name}_{tag}", lim[dt])
              for name in ("hybrid_block", "linear_predict",
                           "ensemble_predict")
              for tag, dt in (("float64", torch.float64),
                              ("float32", torch.float32))]
    checks += [("per_rank_epoch_f64", 1e-10)]
    fails = []
    for name, limit in checks:
        ctl_key = next(k for k in res if k.startswith(name + "_control"))
        if not res[name] <= limit:
            fails.append(f"{name}: card vs CPU {res[name]:.3e} beyond "
                         f"{limit}")
        if res[ctl_key] <= limit:
            fails.append(f"{ctl_key} {res[ctl_key]:.3e} is not rejected")
    if res["per_rank_graph_vs_eager"] != 0.0:
        fails.append("per-rank graph-replayed epochs differ from eager ones")
    if res["per_rank_graph_vs_eager_control_seed"] == 0.0:
        fails.append("the graph-vs-eager check does not reject another seed")
    res["failures"] = fails
    return res


def compare_runs(cfg, store, steps, save_every):
    """The sync-avoiding run against the exchanged one, from their
    artifacts: per-rank and whole non-shared rel-L2 over the comm-free
    window, and the warm-up rows' largest relative difference and
    whether they are equal bit for bit. A stage 4 run shorter than stage
    1 is held to stage 1's first ``steps`` rows."""
    import numpy as np

    from savtpu_torch.io.artifacts import load_displacement

    n_warm = (cfg.surrogate.i_cri + 1) // save_every
    err_sq = ref_sq = warm_err = 0.0
    warm_equal = True
    per_rank = {}
    for r in range(cfg.partition.n_parts):
        exact = load_displacement(store.dynamics_h5(r))[
            :, : steps // save_every]
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


def run_lstm_path(root: Path, dev, epochs, leg_epochs, steps):
    """Phase 3's default-config run through api.Simulation (``steps``
    steps), then its
    stage 4 again from a copy of the workdir in fint_mode "pallas", where
    K1 runs every step, then the surrogate legs on its stage 1-2
    artifacts (:func:`run_surrogate_legs`), then stage 3's grid on them
    (:func:`run_stage3_grid`). Returns the phase's readings, the legs'
    and the grid's, each with "failures"."""
    import numpy as np

    from savtpu_torch.io.artifacts import ArtifactStore, load_displacement
    from savtpu_torch.ops.dense_step import batched_fint_matvec
    from savtpu_torch.pipeline import online_predictor

    cfg = lstm_config(root / "dense", epochs, steps=steps)
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
        "published_steps": lstm_config(root, None).solver.num_steps,
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
    # K1 on the same path: stage 4 again, from a copy, in pallas mode,
    # over its first K1_LEG_STEPS steps (whole blocks: the first rows of
    # the dense run's stage 4)
    shutil.copytree(root / "dense", root / "pallas")
    cfg_k1 = lstm_config(root / "pallas", epochs, fint_mode="pallas")
    cfg_k1.solver.num_steps = k1_steps = K1_LEG_STEPS
    batched_fint_matvec.launches = 0
    online_predictor.run(cfg_k1, verbose=False, device=dev)
    k1 = batched_fint_matvec.launches
    st_k1 = ArtifactStore(cfg_k1.workdir, cfg_k1.model_dir,
                          cfg_k1.surrogate.run_tag())
    k1_rel = max(rel_max(load_displacement(st_k1.modeled_h5(r)),
                         load_displacement(store.modeled_h5(r))[
                             :, : k1_steps // se])
                 for r in range(cfg.partition.n_parts))
    res.update(k1_leg_steps=k1_steps, k1_leg_launches=k1,
               k1_leg_vs_dense_max_rel=k1_rel,
               k1_leg_stage4=stage_events(cfg_k1)["stage4_online"][
                   "seconds"])
    rel = [metrics["global_rel_l2_nonshared"], commfree, *per_rank.values()]
    res["failures"] = [msg for bad, msg in (
        (not all(math.isfinite(x) for x in rel), f"non-finite rel-L2 {rel}"),
        (not warm_equal, "stage-4 warm-up rows differ from stage 1"),
        (k1 != k1_steps, f"K1 launched {k1} times in the pallas stage 4, "
                         f"not once a step ({k1_steps})"),
        (not k1_rel <= 1e-5, "the pallas stage 4 departs from the dense "
                             "one beyond 1e-5"),
    ) if bad]
    legs = run_surrogate_legs(root / "dense", dev, leg_epochs)
    zero_kernel_launches()
    grid = run_stage3_grid(root / "dense", dev)
    grid["k1_k4_launches"] = linear_kernel_launches()
    shutil.rmtree(root, ignore_errors=True)
    return res, legs, grid


def lstm_timing(S3, dev, seed=SEED, eager_epochs=2, replays=10):
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


# ---- the structured-box slice: Neo-Hookean, the linear stencil, grid ----

# the JAX package's sweep material (benchmarks/sweep.py), its defaults
NH_MAT = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)
# float64 limit of the structured-box checks (tests/test_grid_exchange.py)
BOX_TOL = 1e-12


def nh_box_config(workdir: Path, steps: int = NH_STEPS,
                  arch: str = "expfit", epochs: int = SURROGATE_EPOCHS):
    """nh_box_96: ``scripts/scale_demo.py --cells 96 8 8 --parts 16
    --material neo_hookean --pmethod box --exchange grid --arch <arch>
    --order 16 --modal 16 --no-consensus --cutoff 0.75``, the plant and
    surrogate flags of scripts/queue_r4g.sh:14-16 at 96x8x8/16: box parts
    of 6x8x8 cells, Neo-Hookean forces on the stencil, the grid exchange,
    float32 compensated, save_every 50; expfit, or the hybrid (that
    expfit base and the residual LSTM at full width: H 50, 2
    bidirectional layers, n_p = n_f = 20, n_s = 150). Cut in depth
    (``steps``) and, for the hybrid, in training epochs only."""
    cfg = slice_config(workdir, steps)
    cfg.material.model = "neo_hookean"
    cfg.partition.method = "box"
    cfg.solver.exchange_mode = "grid"
    s = cfg.surrogate
    s.arch = arch
    s.expfit_order = 16
    s.modal_dim = 16
    s.cut_off = 0.75
    s.num_epochs = epochs
    return cfg


def box_setup(cells, parts=16):
    """A float64 beam of ``cells`` (length nx/ny, cells of 1/ny) and its
    box partition maps."""
    from savtpu_torch.mesh import beam_mesh

    mesh = beam_mesh(*cells, extent=(cells[0] / cells[1], 1.0, 1.0))
    return (*mesh_setup(mesh, parts, "box"), 1.0 / cells[1])


def strained(prob, cell, seed=SEED):
    """A seeded global displacement with a strain near 1e-2."""
    import numpy as np

    return 1e-2 * cell * np.random.default_rng(seed).standard_normal(
        prob.ndof)


def by_global_dof(sp, F, ndof):
    """(P, DL) per-part values -> (P, ndof) numpy by global DOF, so
    problems with other local orders compare part by part."""
    import numpy as np

    F = F.detach().cpu().double().numpy()
    out = np.zeros((sp.n_parts, ndof))
    dm = sp.dof_mask.cpu().numpy()
    for p in range(sp.n_parts):
        n = int(dm[p].sum())
        out[p, sp.local_dofs_global[p, :n]] = F[p, :n]
    return out


def check_nh_stencil_vs_cpu(dev, sizes=((8, 4, 4), (96, 8, 8))):
    """The Neo-Hookean stencil force on the card against the incident-list
    force on the CPU (the JAX package's gather path, another local order),
    float64, on a displacement with a strain near 1e-2, part by part. The
    control, the linear stencil force on the same displacement, must be
    rejected."""
    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.parallel import ShardedProblem

    res = {"limit": BOX_TOL}
    mat = NeoHookean.from_engineering(**NH_MAT)
    for cells in sizes:
        prob, maps, cell = box_setup(cells)
        card = ShardedProblem.build(prob, maps, material=mat, device=dev)
        cpu = ShardedProblem.build(prob, maps, material=mat,
                                   nh_stencil="off", nh_gather="incident",
                                   device="cpu")
        lin = ShardedProblem.build(prob, maps, fint_mode="stencil",
                                   device=dev)
        dg = strained(prob, cell)
        want = by_global_dof(cpu, cpu._fint_stacked(cpu.localize(dg)),
                             prob.ndof)
        got, ctl = (by_global_dof(s, s._fint_stacked(s.localize(dg)),
                                  prob.ndof) for s in (card, lin))
        tag = "x".join(map(str, cells)) + "_p16"
        res[tag] = {"nhs_dims": card.nhs_dims, "max_rel": rel_max(got, want),
                    "control_max_rel": rel_max(ctl, want)}
    rows = [v for v in res.values() if isinstance(v, dict)]
    res["failures"] = [msg for bad, msg in (
        (not all(r["max_rel"] <= BOX_TOL for r in rows),
         "the stencil force on the card departs from the CPU's incident "
         "force"),
        (not all(r["control_max_rel"] > BOX_TOL for r in rows),
         "the check does not reject the linear force"),
        (not all(r["nhs_dims"] for r in rows), "no stencil was built"),
    ) if bad]
    return res


def exchange_grid_no_z(sp, F_int):
    """The control of check_grid_vs_psum: the grid exchange with its z
    pass dropped (x and y passes as ShardedProblem._exchange_grid)."""
    import torch

    NX, NY, NZ = sp.grid_ndims
    px, py, pz = sp.grid_pdims
    L = NX * NY * NZ
    v = F_int[sp.grid_perm, : 3 * L].reshape(px, py, pz, NX, NY, NZ, 3)
    s = v[:-1, :, :, NX - 1] + v[1:, :, :, 0]
    v[:-1, :, :, NX - 1] = s
    v[1:, :, :, 0] = s
    s = v[:, :-1, :, :, NY - 1] + v[:, 1:, :, :, 0]
    v[:, :-1, :, :, NY - 1] = s
    v[:, 1:, :, :, 0] = s
    flat = v.reshape(sp.n_parts, 3 * L)[sp.grid_inv]
    return torch.cat([flat, F_int[:, 3 * L :]], dim=1)


def check_grid_vs_psum(dev, cells=(8, 4, 4), steps=200):
    """A 200-step exchanged Neo-Hookean run on the card with the grid
    exchange against the same run with psum, float64, at 8x4x4/16 (boxes
    over all three axes, so corner nodes have 8 owners), from a state
    with a strain near 1e-2; both step from CUDA graphs. Limit 1e-12 of
    the trajectory's max. The control, the grid exchange with its z pass
    dropped, must be rejected."""
    import types

    import numpy as np

    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.parallel import ShardedProblem

    prob, maps, cell = box_setup(cells)
    mat = NeoHookean.from_engineering(**NH_MAT)
    sps = {ex: ShardedProblem.build(prob, maps, material=mat,
                                    exchange_mode=ex, device=dev)
           for ex in ("psum", "grid")}
    ctl = ShardedProblem.build(prob, maps, material=mat,
                               exchange_mode="grid", device=dev)
    ctl._exchange_grid = types.MethodType(exchange_grid_no_z, ctl)
    if not np.array_equal(sps["psum"].local_dofs_global,
                          sps["grid"].local_dofs_global):
        raise RuntimeError("grid and psum problems differ in local order")
    dg = strained(prob, cell)
    traj = {}
    for name, sp in (*sps.items(), ("control", ctl)):
        d0 = sp.localize(dg)
        (traj[name], _), _ = sp.stacked_run(d0, d0, 0.0, steps, sync=True,
                                            record="traj")
    res = {"steps": steps, "grid_pdims": sps["grid"].grid_pdims,
           "limit": BOX_TOL,
           "max_rel": rel_max(traj["grid"], traj["psum"]),
           "control_max_rel": rel_max(traj["control"], traj["psum"])}
    res["failures"] = [msg for bad, msg in (
        (not res["max_rel"] <= BOX_TOL,
         "the grid exchange departs from psum"),
        (not res["control_max_rel"] > BOX_TOL,
         "the check does not reject a grid exchange without its z pass"),
    ) if bad]
    return res


def check_lin_stencil_vs_dense(dev, sizes=((8, 4, 4), (96, 8, 8))):
    """The linear stencil force on the card against the dense K d, float64,
    in the same (box-lex) local order, on a displacement with a strain
    near 1e-2. The control, the stencil with tet type 0 dropped (its
    weight zeroed), must be rejected."""
    import dataclasses

    from savtpu_torch.parallel import ShardedProblem

    res = {"limit": BOX_TOL}
    for cells in sizes:
        prob, maps, cell = box_setup(cells)
        st = ShardedProblem.build(prob, maps, fint_mode="stencil",
                                  device=dev)
        dn = ShardedProblem.build(prob, maps, fint_mode="dense",
                                  exchange_mode="grid", device=dev)
        w = st.nhs_dJw.clone()
        w[0] = 0.0
        ctl = dataclasses.replace(st, nhs_dJw=w)
        d = st.localize(strained(prob, cell))
        n = st.DL - 1
        want = dn._fint_stacked(d)[:, :n]
        tag = "x".join(map(str, cells)) + "_p16"
        res[tag] = {
            "DL": st.DL,
            "max_rel": rel_max(st._fint_stacked(d)[:, :n], want),
            "control_max_rel": rel_max(ctl._fint_stacked(d)[:, :n], want)}
        del dn
    rows = [v for v in res.values() if isinstance(v, dict)]
    res["failures"] = [msg for bad, msg in (
        (not all(r["max_rel"] <= BOX_TOL for r in rows),
         "the linear stencil departs from K d"),
        (not all(r["control_max_rel"] > BOX_TOL for r in rows),
         "the check does not reject a dropped tet type"),
    ) if bad]
    return res


def linear_kernel_launches():
    """The launch counts of K1-K4."""
    from savtpu_torch.ops.banded_scan import scan_comm_free_banded
    from savtpu_torch.ops.dense_step import (
        batched_fint_matvec,
        scan_comm_free,
    )
    from savtpu_torch.ops.online_banded import online_chunk

    return {fn.__name__: fn.launches for fn in (
        batched_fint_matvec, scan_comm_free, online_chunk,
        scan_comm_free_banded)}


def zero_kernel_launches():
    """Set the launch counts of K1-K4 to 0."""
    from savtpu_torch.ops.banded_scan import scan_comm_free_banded
    from savtpu_torch.ops.dense_step import (
        batched_fint_matvec,
        scan_comm_free,
    )
    from savtpu_torch.ops.online_banded import online_chunk

    for fn in (batched_fint_matvec, scan_comm_free, online_chunk,
               scan_comm_free_banded):
        fn.launches = 0


def sidecars(cfg):
    """Each rank's stage-3 sidecar."""
    from savtpu_torch.io.artifacts import ArtifactStore

    st = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    return [json.loads(st.model_file(r).with_suffix(".json").read_text())
            for r in range(cfg.partition.n_parts)]


def path_readings(cfg, metrics, times, steps, save_every):
    """The readings every pipeline path reports: stage seconds, stage
    4's rate, the rel-L2 globally, over the comm-free window and per
    rank, and whether the warm-up rows equal stage 1's bit for bit."""
    from savtpu_torch.io.artifacts import ArtifactStore

    store = ArtifactStore(cfg.workdir, cfg.model_dir,
                          cfg.surrogate.run_tag())
    per_rank, commfree, warm_err, warm_equal = compare_runs(
        cfg, store, steps, save_every)
    s4 = stage_events(cfg)["stage4_online"]
    return {
        "stage_s": times,
        "stage4": {k: s4[k] for k in ("seconds", "steps_per_sec",
                                      "blocks_s", "stacked_predictor",
                                      "arch", "ensemble")},
        "plotter_metrics": metrics,
        "global_rel_l2_nonshared": metrics["global_rel_l2_nonshared"],
        "commfree_rel_l2_nonshared": commfree,
        "commfree_rel_l2_per_rank": per_rank,
        "warmup_rows_equal": warm_equal,
        "warmup_rows_max_rel_diff": warm_err,
    }


def path_failures(res, launches):
    rel = [res["global_rel_l2_nonshared"], res["commfree_rel_l2_nonshared"],
           *res["commfree_rel_l2_per_rank"].values()]
    return [msg for bad, msg in (
        (not all(math.isfinite(x) for x in rel), f"non-finite rel-L2 {rel}"),
        (not res["warmup_rows_equal"],
         "stage-4 warm-up rows differ from stage 1"),
        (any(launches.values()),
         f"the path launched a linear kernel: {launches}"),
    ) if bad]


def run_nh_box_path(root: Path, dev, steps):
    """Phase 3's nh_box_96 run through api.Simulation's stages with the
    expfit surrogate, then stages 3-5 again with the hybrid on the same
    stage 1-2 artifacts (scripts/rerun_online.py's way), then the sweep's
    Neo-Hookean case through ``bench_case``. None may launch K1-K4 (as
    in savtpu, no Pallas kernel lies on this path). Returns (the expfit
    readings, the hybrid's, each with "failures", and the problem for
    phase 4's profile)."""
    from savtpu_torch.benchmarks import sweep

    cfg = nh_box_config(root / "nh_box_96", steps)
    zero_kernel_launches()
    sim, metrics, times = run_stages(cfg, dev)
    launches = linear_kernel_launches()
    sp = sim.ctx.sp
    del sim
    ev = stage_events(cfg)
    res = {
        "steps": steps,
        "stage1_steps_per_s": ev["stage1_solve"]["steps_per_sec"],
        "setup": ev["setup_breakdown"],
        "fint_mode": sp.fint_mode, "nhs_dims": sp.nhs_dims,
        "exchange_mode": sp.exchange_mode, "grid_pdims": sp.grid_pdims,
        "DL": sp.DL,
        **path_readings(cfg, metrics, times, steps, SAVE_EVERY),
        "expfit_has_post_segment": [m["expfit_has_post_segment"]
                                    for m in sidecars(cfg)],
        "k1_k4_launches": launches,
    }
    res["failures"] = path_failures(res, launches) + [msg for bad, msg in (
        (sp.fint_mode != "nh" or sp.nhs_dims is None,
         f"the problem is {sp.fint_mode!r} with stencil dims "
         f"{sp.nhs_dims}, not the Neo-Hookean stencil"),
        (sp.exchange_mode != "grid", "the exchange is not the grid's"),
        (not all(res["expfit_has_post_segment"]),
         "expfit took its frozen-ramp fallback"),
    ) if bad]

    # the hybrid: stages 3-5 on the same stage 1-2 artifacts
    cfg_h = nh_box_config(root / "nh_box_96", steps, arch="hybrid")
    zero_kernel_launches()
    sim, metrics_h, times_h = run_stages(cfg_h, dev, first=3)
    launches_h = linear_kernel_launches()
    del sim
    s3 = stage_events(cfg_h)["stage3_train_hybrid"]
    hyb = {
        "steps": steps,
        **path_readings(cfg_h, metrics_h, times_h, steps, SAVE_EVERY),
        "stage3": {k: s3[k] for k in (
            "shards", "input_size", "windows", "epochs", "seconds",
            "adam_steps", "capture_s", "train_s", "final_train_loss",
            "final_val_r2")},
        "stage3_epochs_per_s": s3["epochs"] / s3["train_s"],
        "residual_over_signal_per_rank": s3["residual_rel"],
        "expfit_has_post_segment": s3["expfit_has_post_segment"],
        "expfit_global_rel_l2_nonshared": res["global_rel_l2_nonshared"],
        "expfit_commfree_rel_l2_per_rank": res["commfree_rel_l2_per_rank"],
        "k1_k4_launches": launches_h,
    }
    hyb["failures"] = path_failures(hyb, launches_h) + [msg for bad, msg in (
        (not all(hyb["expfit_has_post_segment"]),
         "the hybrid's expfit base took its frozen-ramp fallback"),
        (hyb["stage4"]["arch"] != "hybrid", "stage 4 did not run the hybrid"),
    ) if bad]
    shutil.rmtree(root / "nh_box_96", ignore_errors=True)

    # the sweep's Neo-Hookean row
    case = next(c for c in sweep.CASES if len(c) > 8 and c[8])
    zero_kernel_launches()
    t0 = time.perf_counter()
    row = sweep.bench_case(*case, device=dev)
    row.update(steps=case[5], case_s=time.perf_counter() - t0)
    res["sweep_nh_row"] = row
    res["failures"] += [msg for bad, msg in (
        (any(linear_kernel_launches().values()),
         "the sweep's Neo-Hookean case launched a linear kernel (K1-K4)"),
        (row["fint_mode"] != "nh",
         "the sweep's Neo-Hookean case did not run Neo-Hookean forces"),
    ) if bad]
    return res, hyb, sp


# the surrogate legs on the default run's stage 1-2 artifacts
SURROGATE_LEGS = {
    "linear": dict(arch="linear"),
    "ensemble2": dict(ensemble=2),
    "per_rank_mtf": dict(stacked=False, training_method="mtf",
                         dropout_encoder=0.1, dropout_decoder=0.1),
}


def run_surrogate_legs(workdir: Path, dev, epochs):
    """Phase 3's default-config legs: stages 3-5 again on the default
    run's stage 1-2 artifacts with the linear surrogate (stacked), a seed
    ensemble of 2, and per-rank LSTMs with mixed teacher forcing and
    dropout (the per-rank fallback in stage 4), each trained ``epochs``
    epochs, its stages 4-5 over the first LEG_STEPS steps. None may
    launch K1-K4 (the default run is dense). Returns {leg: readings with
    "failures"}."""
    out = {}
    for name, kw in SURROGATE_LEGS.items():
        cfg = lstm_config(workdir, epochs)
        cfg.solver.num_steps = LEG_STEPS
        for k, v in kw.items():
            setattr(cfg.surrogate, k, v)
        steps, se = cfg.solver.num_steps, cfg.solver.save_every
        zero_kernel_launches()
        sim, metrics, times = run_stages(cfg, dev, first=3)
        launches = linear_kernel_launches()
        del sim
        recs = [json.loads(ln) for ln in (Path(cfg.workdir)
                / "metrics.jsonl").read_text().splitlines()]
        s3 = [r for r in recs if r["event"].startswith("stage3_train")]
        s3 = s3[-cfg.partition.n_parts:] if name == "per_rank_mtf" else s3[-1:]
        res = {"epochs": epochs if name != "linear" else None,
               "steps": steps,
               **path_readings(cfg, metrics, times, steps, se),
               "stage3": [{k: r.get(k) for k in (
                   "seconds", "train_s", "capture_s", "adam_steps",
                   "ridge_lambda", "final_val_r2", "ensemble")}
                   for r in s3],
               "k1_k4_launches": launches}
        if name != "linear":
            train_s = sum(r["train_s"] for r in s3)
            res["stage3_epochs_per_s"] = epochs * len(s3) / train_s
        want_stacked = name != "per_rank_mtf"
        res["failures"] = path_failures(res, launches) + [msg for bad, msg in (
            (res["stage4"]["stacked_predictor"] is not want_stacked,
             f"stage 4 stacked_predictor is "
             f"{res['stage4']['stacked_predictor']}"),
            (name == "ensemble2" and res["stage4"]["ensemble"] != 2,
             "stage 4 did not average 2 members"),
        ) if bad]
        out[name] = res
    return out


# ---- the unstructured-mesh slice: gmsh meshes, the graph partition, the
# ---- irregular beam through K3, the periodic tube, the windowed layout

# irregular_96 (scripts/queue_r5c.sh:83-85's flags at the 96x8x8 class):
# the ramp ends at step 313,560 (dt 3.19e-6 s), so every depth a chip run
# can take lies inside it and expfit takes its frozen-ramp fallback
IRREGULAR_CELLS = (96, 8, 8)
# tube_hybrid (savtpu's runs/tube_hybrid): tube 2x24x48 in 8 RCB parts;
# 0.75 x 45,000 steps clears the load ramp (step 27,389 at dt 3.65e-5 s)
# by 127 stored rows, more than expfit's 64 at order 16 (the published
# depth is 100,000; 60,000 until the serial-solver and steady slice)
TUBE_CELLS = (2, 24, 48)
TUBE_STEPS = 45_000
# the tube of phase 2's grid check and phase 4's profile: 64 box parts
TUBE_BIG = (4, 48, 256)


def irregular_mesh():
    from savtpu_torch.mesh import irregular_beam_mesh

    return irregular_beam_mesh(*IRREGULAR_CELLS, extent=(12.0, 1.0, 1.0))


def irregular_config(workdir: Path, mesh_path, steps: int = STEPS):
    """irregular_96: the irregular Delaunay beam 96x8x8 (extent 12x1x1,
    42,017 tets) read from ``mesh_path``, 16 graph parts, fint_mode
    'auto' (banded), float32 compensated, the psum exchange, save_every
    50; expfit order 16, modal 8, no consensus, cut-off 0.75."""
    cfg = slice_config(workdir, steps)
    cfg.mesh_path = str(mesh_path)
    cfg.partition.method = "graph"
    cfg.solver.fint_mode = "auto"
    s = cfg.surrogate
    s.expfit_order = 16
    s.cut_off = 0.75
    return cfg


def tube_config(workdir: Path, mesh_path, steps: int = TUBE_STEPS,
                epochs: int = SURROGATE_EPOCHS):
    """tube_hybrid: tube 2x24x48 (13,824 tets) read from ``mesh_path``,
    clamped at z = 0, 8 RCB parts (dense, DL 1,522), float32 compensated,
    save_every 50; the stacked hybrid (expfit order 16, modal 16, cut-off
    0.75, owner consensus on; residual LSTMs at full width). Cut in depth
    and training epochs."""
    cfg = slice_config(workdir, steps)
    cfg.mesh_path = str(mesh_path)
    cfg.partition.n_parts = 8
    cfg.partition.dirichlet_axis = 2
    cfg.solver.fint_mode = "auto"
    s = cfg.surrogate
    s.arch = "hybrid"
    s.expfit_order = 16
    s.modal_dim = 16
    s.cut_off = 0.75
    s.pred_consensus = True
    s.num_epochs = epochs
    return cfg


def smooth_strain(prob, seed=SEED):
    """A seeded affine global displacement, a strain near 1e-2 in every
    element: the irregular mesh's slivers (volumes down to 1/500 of the
    median) turn any field that is not affine at that size into
    inverted elements."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (1e-2 * prob.mesh.points @ rng.standard_normal((3, 3)).T).reshape(
        -1)


def mesh_setup(mesh, parts, method, axis=0):
    """A float64 problem of ``mesh`` (clamped on the ``axis`` = 0 face)
    and its partition maps."""
    import torch

    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import build_partition_maps, partition_elements
    from savtpu_torch.solvers import setup_problem

    cfg = Config()
    cfg.partition.dirichlet_axis = axis
    prob = setup_problem(cfg, mesh=mesh, dtype=torch.float64)
    ep = partition_elements(mesh.tetra, mesh.points, parts, method)
    maps = build_partition_maps(mesh.tetra, ep, mesh.num_points,
                                dirichlet_nodes(mesh.triangles, mesh.points,
                                                axis=axis))
    return prob, maps


def rel_or_inf(a, b):
    """rel_max, infinite where ``a`` is not finite (a control whose
    elements invert gives NaN forces, which a limit must reject)."""
    r = rel_max(a, b)
    return r if math.isfinite(r) else math.inf


def shift_windows(sp):
    """The control of check_nh_window_vs_cpu: every chunk's window start
    moved by one node."""
    import dataclasses

    import torch

    # the windowed layout's edofs hold each chunk's nodes as w0 + relative
    # index: one node on (the last node wraps to node 0), pads untouched
    last = sp.DL - 1
    e = sp.edofs
    return dataclasses.replace(
        sp, edofs=torch.where(e < last, (e + 3) % last, e))


def check_nh_window_vs_cpu(dev, irr):
    """The windowed Neo-Hookean force on the card against the
    incident-list force on the CPU (another local order, compared part by
    part by global DOF), float64, on a smooth displacement with a strain
    near 1e-2, at irregular 96x8x8/16 graph and at tube 2x24x48/8 RCB
    (its stencil off). Limit 1e-12 of the max. The control, every
    chunk's window start shifted by one node, must be rejected. ``irr``
    is irregular 96x8x8/16's (problem, maps)."""
    from savtpu_torch.mesh import tube_mesh
    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.parallel import ShardedProblem

    res = {"limit": BOX_TOL}
    mat = NeoHookean.from_engineering(**NH_MAT)
    for tag, (prob, maps) in (
            ("irregular_96x8x8_p16_graph", irr),
            ("tube_2x24x48_p8_rcb",
             mesh_setup(tube_mesh(*TUBE_CELLS), 8, "rcb", axis=2))):
        card = ShardedProblem.build(prob, maps, material=mat,
                                    nh_stencil="off", nh_gather="window",
                                    device=dev)
        cpu = ShardedProblem.build(prob, maps, material=mat,
                                   nh_stencil="off", nh_gather="incident",
                                   device="cpu")
        dg = smooth_strain(prob)
        want = by_global_dof(cpu, cpu._fint_stacked(cpu.localize(dg)),
                             prob.ndof)
        got, ctl = (by_global_dof(s, s._fint_stacked(s.localize(dg)),
                                  prob.ndof)
                    for s in (card, shift_windows(card)))
        res[tag] = {"W": card.nhw_W, "chunks": int(card.nhw_w0.shape[1]),
                    "max_rel": rel_max(got, want),
                    "control_max_rel": rel_or_inf(ctl, want)}
        del card, cpu
    rows = [v for v in res.values() if isinstance(v, dict)]
    res["failures"] = [msg for bad, msg in (
        (not all(r["max_rel"] <= BOX_TOL for r in rows),
         "the windowed force on the card departs from the CPU's incident "
         "force"),
        (not all(r["control_max_rel"] > BOX_TOL for r in rows),
         "the check does not reject shifted windows"),
    ) if bad]
    return res


def tube_control(sp):
    """The control of check_tube_stencil: every part's last theta column
    of cells left out (its weight zeroed). In a full-ring part those are
    the cells on the wrapped corner column; in the seam-wrapped part, the
    cells on the wrapped global column 0."""
    import dataclasses

    w = sp.nhs_dJwc.clone()
    w[:, :, :, -1] = 0.0
    return dataclasses.replace(sp, nhs_dJwc=w)


def check_tube_stencil(dev, big):
    """The tube's stencil forces on the card, float64, on a displacement
    with a strain near 1e-2: the linear stencil against the dense K d (in
    the same box-lex order) and the Neo-Hookean stencil against the
    incident-list force on the CPU (part by part by global DOF), at tube
    2x24x48 in 3 and 4 box parts (each part a full ring: the wrapped
    corner column) and 4x48x256 in 64 (``big``, its (problem, maps);
    theta split in 4: seam-wrapped parts), where the assembled K d is
    held in banded storage (in the same box-lex order: 5.6 GB of dense
    K would take longer to build than the rest of the phase). Limit
    1e-12 of the max. The control (tube_control) must be rejected."""
    import numpy as np

    from savtpu_torch.mesh import tube_mesh
    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.parallel import ShardedProblem

    res = {"limit": BOX_TOL}
    mat = NeoHookean.from_engineering(**NH_MAT)
    for dims, parts in ((TUBE_CELLS, 3), (TUBE_CELLS, 4), (TUBE_BIG, 64)):
        prob, maps = (big if dims == TUBE_BIG else
                      mesh_setup(tube_mesh(*dims), parts, "box", axis=2))
        cell = (1.0 - 0.5) / dims[0]
        dg = 1e-2 * cell * np.random.default_rng(SEED).standard_normal(
            prob.ndof)
        tag = "x".join(map(str, dims)) + f"_p{parts}"
        # linear: stencil vs dense K d, same (box-lex) local order
        st = ShardedProblem.build(prob, maps, fint_mode="stencil",
                                  exchange_mode="grid", device=dev)
        ref_mode = "banded" if dims == TUBE_BIG else "dense"
        dn = ShardedProblem.build(prob, maps, fint_mode=ref_mode,
                                  exchange_mode="grid", device=dev)
        if dn.local_dofs_global.tolist() != st.local_dofs_global.tolist():
            raise RuntimeError("the K d reference has another local order")
        d = st.localize(dg)
        n = st.DL - 1
        want = dn._fint_stacked(d)[:, :n]
        del dn
        ctl = tube_control(st)
        row = {"linear_reference": ref_mode,
               "nhs_dims": st.nhs_dims, "nhs_wrap": st.nhs_wrap,
               "grid_wrap": st.grid_wrap,
               "linear_max_rel": rel_max(st._fint_stacked(d)[:, :n], want),
               "linear_control_max_rel": rel_max(
                   ctl._fint_stacked(d)[:, :n], want)}
        del st, ctl
        # Neo-Hookean: stencil on the card vs incident list on the CPU
        card = ShardedProblem.build(prob, maps, material=mat, device=dev)
        cpu = ShardedProblem.build(prob, maps, material=mat,
                                   nh_stencil="off", nh_gather="incident",
                                   device="cpu")
        want = by_global_dof(cpu, cpu._fint_stacked(cpu.localize(dg)),
                             prob.ndof)
        ctl = tube_control(card)
        got, bad = (by_global_dof(s, s._fint_stacked(s.localize(dg)),
                                  prob.ndof) for s in (card, ctl))
        row.update(nh_max_rel=rel_max(got, want),
                   nh_control_max_rel=rel_max(bad, want))
        res[tag] = row
        del card, cpu, ctl
    rows = [v for v in res.values() if isinstance(v, dict)]
    res["failures"] = [msg for bad, msg in (
        (not all(max(r["linear_max_rel"], r["nh_max_rel"]) <= BOX_TOL
                 for r in rows),
         "a tube stencil force departs from its reference"),
        (not all(min(r["linear_control_max_rel"], r["nh_control_max_rel"])
                 > BOX_TOL for r in rows),
         "the check does not reject the control"),
        (not any(r["nhs_wrap"] for r in rows), "no full-ring part was run"),
        (not any(r["grid_wrap"] for r in rows), "no seam-wrapped part ring"),
    ) if bad]
    return res


def check_tube_grid_vs_psum(dev, big, steps=200):
    """200 exchanged steps of the linear stencil on tube 4x48x256 in 64
    box parts (theta split in 4, so the part ring closes across the seam)
    with the grid exchange against psum, float64, from a state with a
    strain near 1e-2; both step from CUDA graphs. Limit 1e-12 of the
    trajectory's max. The control, the seam pair left out, must be
    rejected. Returns the readings and the grid problem (phase 4's
    profile)."""
    import dataclasses

    import numpy as np

    from savtpu_torch.parallel import ShardedProblem

    prob, maps = big
    grid = ShardedProblem.build(prob, maps, fint_mode="stencil",
                                exchange_mode="grid", device=dev)
    psum = dataclasses.replace(grid, exchange_mode="psum")
    ctl = dataclasses.replace(grid, grid_wrap=False)
    cell = 0.5 / TUBE_BIG[0]
    dg = 1e-2 * cell * np.random.default_rng(SEED).standard_normal(prob.ndof)
    traj = {}
    for name, sp in (("grid", grid), ("psum", psum), ("control", ctl)):
        d0 = sp.localize(dg)
        (traj[name], _), _ = sp.stacked_run(d0, d0, 0.0, steps, sync=True,
                                            record="traj")
    res = {"steps": steps, "grid_pdims": grid.grid_pdims,
           "grid_wrap": grid.grid_wrap, "DL": grid.DL, "limit": BOX_TOL,
           "max_rel": rel_max(traj["grid"], traj["psum"]),
           "control_max_rel": rel_max(traj["control"], traj["psum"])}
    res["failures"] = [msg for bad, msg in (
        (not grid.grid_wrap, "the part ring has no seam pair"),
        (not res["max_rel"] <= BOX_TOL,
         "the seam-wrapped grid exchange departs from psum"),
        (not res["control_max_rel"] > BOX_TOL,
         "the check does not reject a grid exchange without its seam pair"),
    ) if bad]
    return res, grid


def check_mesh_io_and_route(root: Path):
    """The native partition route on this machine and the .msh round trip
    (binary and ASCII 2.2, binary 4.1) of the irregular beam: points and
    tets equal exactly. Writes the binary file phase 3 reads."""
    import numpy as np

    from savtpu_torch import native
    from savtpu_torch.mesh import read_mesh, write_msh, write_vtu
    from savtpu_torch.parallel import partition_elements

    mesh = irregular_mesh()
    res = {"tets": len(mesh.tetra), "nodes": mesh.num_points}
    root.mkdir(parents=True, exist_ok=True)
    for name, kw in (("binary22", dict(binary=True)),
                     ("ascii22", dict()),
                     ("binary41", dict(binary=True, version="4.1")),
                     ("vtu", None)):
        path = root / (f"irregular_{name}.msh" if kw is not None
                       else "irregular.vtu")
        t0 = time.perf_counter()
        if kw is None:
            write_vtu(path, mesh)
        else:
            write_msh(path, mesh, **kw)
        back = read_mesh(path)
        res[name] = {"bytes": path.stat().st_size,
                     "seconds": round(time.perf_counter() - t0, 3),
                     "equal": bool(np.array_equal(back.points, mesh.points)
                                   and np.array_equal(back.tetra,
                                                      mesh.tetra))}
    info = {}
    t0 = time.perf_counter()
    partition_elements(mesh.tetra, mesh.points, 16, "graph", info=info)
    res["partition_route"] = info["route"]
    res["partition_s"] = round(time.perf_counter() - t0, 3)
    res["native_library"] = str(native._target().name)
    res["failures"] = [msg for bad, msg in (
        (info["route"] != "native",
         "the graph partition did not take the native refiner"),
        (not all(v["equal"] for v in res.values() if isinstance(v, dict)),
         "a mesh file did not read back equal"),
    ) if bad]
    return res, root / "irregular_binary22.msh"


def run_irregular_path(root: Path, dev, mesh_path, steps):
    """Phase 3's irregular_96 through api.Simulation's stages. K3 must
    launch once per comm-free block and K1, K2, K4 never; the warm-up rows
    must equal stage 1's bit for bit; stage 1's steady solve is read
    against SciPy's direct one (``stage1_steady``). Returns the readings
    (with "failures") and the built problem for phase 4."""
    cfg = irregular_config(root / "irregular_96", mesh_path, steps)
    zero_kernel_launches()
    sim, metrics, times = run_stages(cfg, dev)
    launches = linear_kernel_launches()
    sp, prob = sim.ctx.sp, sim.ctx.prob
    del sim
    steady = stage1_steady(cfg, prob)
    del prob
    ev = stage_events(cfg)
    blocks = -(-(steps - cfg.surrogate.i_cri - 1)
               // cfg.surrogate.block_size)
    P, nc, Bk, _ = sp.band_Kd.shape
    res = {
        "steps": steps,
        "stage1_steps_per_s": ev["stage1_solve"]["steps_per_sec"],
        "setup": ev["setup_breakdown"],
        "fint_mode": sp.fint_mode, "DL": sp.DL,
        "band": {"P": P, "nc": nc, "Bk": Bk, "S3": int(sp.sld.shape[1])},
        **path_readings(cfg, metrics, times, steps, SAVE_EVERY),
        "k1_k4_launches": launches, "blocks": blocks,
        "steady_solve": steady,
    }
    others = {k: v for k, v in launches.items() if k != "online_chunk"}
    res["failures"] = path_failures(res, others) + steady["failures"] + [
        msg for bad, msg in (
        (sp.fint_mode != "banded", f"the problem is {sp.fint_mode!r}"),
        (ev["setup_breakdown"].get("partition_route") != "native",
         "the graph partition did not take the native refiner"),
        (launches["online_chunk"] != blocks,
         f"K3 launched {launches['online_chunk']} times (expected one per "
         f"comm-free block, {blocks})"),
    ) if bad]
    shutil.rmtree(root / "irregular_96", ignore_errors=True)
    return res, sp


def run_tube_path(root: Path, dev, steps, epochs):
    """Phase 3's tube_hybrid: the tube written to an ASCII .msh and read
    back, through api.Simulation's stages with the stacked hybrid. No
    path kernel may launch (dense, as in savtpu, where no Pallas kernel
    lies on it); every rank's expfit base must fit past the load ramp;
    stage 1's steady solve is read against SciPy's direct one."""
    from savtpu_torch.mesh import tube_mesh, write_msh

    path = root / "tube.msh"
    write_msh(path, tube_mesh(*TUBE_CELLS))
    cfg = tube_config(root / "tube_hybrid", path, steps, epochs)
    zero_kernel_launches()
    sim, metrics, times = run_stages(cfg, dev)
    launches = linear_kernel_launches()
    sp, prob = sim.ctx.sp, sim.ctx.prob
    del sim
    steady = stage1_steady(cfg, prob)
    del prob
    ev = stage_events(cfg)
    s3 = ev["stage3_train_hybrid"]
    res = {
        "steps": steps, "epochs": epochs,
        "stage1_steps_per_s": ev["stage1_solve"]["steps_per_sec"],
        "setup": ev["setup_breakdown"], "fint_mode": sp.fint_mode,
        "DL": sp.DL,
        **path_readings(cfg, metrics, times, steps, SAVE_EVERY),
        "stage3": {k: s3[k] for k in (
            "shards", "input_size", "windows", "epochs", "seconds",
            "adam_steps", "capture_s", "train_s", "final_train_loss",
            "final_val_r2")},
        "stage3_epochs_per_s": s3["epochs"] / s3["train_s"],
        "residual_over_signal_per_rank": s3["residual_rel"],
        "expfit_has_post_segment": s3["expfit_has_post_segment"],
        "k1_k4_launches": launches, "steady_solve": steady,
    }
    res["failures"] = path_failures(res, launches) + steady["failures"] + [
        msg for bad, msg in (
        (sp.fint_mode != "dense", f"the problem is {sp.fint_mode!r}"),
        (not all(res["expfit_has_post_segment"]),
         "the hybrid's expfit base took its frozen-ramp fallback"),
        (res["stage4"]["arch"] != "hybrid", "stage 4 did not run the hybrid"),
    ) if bad]
    shutil.rmtree(root / "tube_hybrid", ignore_errors=True)
    return res


def window_profiles(dev, irr, steps=300):
    """Phase 4: the irregular 96x8x8/16 Neo-Hookean exchanged step
    (``irr``: its float64 problem and maps), windowed layout against the
    incident list (float32, compensated), replayed from CUDA graphs
    (stepper_profile)."""
    import torch

    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.parallel import ShardedProblem

    prob, maps = irr
    prob = prob.with_dtype(torch.float32)
    mat = NeoHookean.from_engineering(**NH_MAT)
    out = {}
    for gather in ("window", "incident"):
        sp = ShardedProblem.build(prob, maps, material=mat,
                                  nh_gather=gather, compensated=True,
                                  device=dev)
        out[gather] = stepper_profile(sp, dev, steps=steps)
        del sp
    return out


# ---- the solver-options slice: ell and ebe forces, the permute
# exchange, blended resync, the unramped ghost step, checkpoints ----
OPT_TOL = 1e-12
# the sweep's cases of the slice: (mesh, parts, mode, exchange). The
# 384x16x16/256 permute case (590k tets) stays out for time
OPTIONS_SWEEP = (("96x8x8", 64, "ell", "psum"),
                 ("48x4x4", 8, "dense", "permute"),
                 ("96x8x8", 64, "dense", "permute"),
                 ("192x12x12", 64, "banded", "permute"))
# the stage-1 command line's depth on the default beam, and its
# checkpoint cadence (the published depth is 100,000 steps)
CKPT_STEPS = 15_000
CKPT_EVERY = 5_000
# unramped_beam's depth
UNRAMPED_STEPS = 5_000


class Kill(RuntimeError):
    """An injected kill (checkpoint_resume)."""


def rcb_setup(cells, parts):
    """A float64 beam of ``cells`` (length nx/ny, as the sweep's) and its
    RCB partition maps."""
    from savtpu_torch.mesh import beam_mesh

    mesh = beam_mesh(*cells, extent=(cells[0] / cells[1], 1.0, 1.0))
    return mesh_setup(mesh, parts, "rcb")


def check_ell_ebe_vs_dense(dev, cells=(96, 8, 8), parts=64):
    """The ell and ebe forces on the card against the dense K d at the
    sweep's 96x8x8/64, float64, on a seeded displacement (all three keep
    the first-touch local order). Limit 1e-12 of the max. Controls: ell
    with every column node shifted by one, ebe with one element dropped;
    each must be rejected."""
    import dataclasses

    import numpy as np
    import torch

    from savtpu_torch.parallel import ShardedProblem

    prob, maps = rcb_setup(cells, parts)
    sps = {m: ShardedProblem.build(prob, maps, fint_mode=m,
                                   dtype=torch.float64, device=dev)
           for m in ("dense", "ell", "ebe")}
    ell, ebe = sps["ell"], sps["ebe"]
    d = sps["dense"].localize(np.random.default_rng(SEED).standard_normal(
        prob.ndof))
    want = sps["dense"]._fint_stacked(d)
    L = (ell.DL - 1) // 3
    cols = ell.ell_cols
    ctl_ell = dataclasses.replace(
        ell, ell_cols=torch.where(cols < L, (cols + 1) % L, cols))
    Ke = ebe.Ke.clone()
    Ke[0, 0] = 0.0
    ctl_ebe = dataclasses.replace(ebe, Ke=Ke)
    res = {"cells": list(cells), "parts": parts, "DL": ell.DL,
           "ell_width": int(cols.shape[2]),
           "ebe_incident_width": int(ebe.nh_gather.shape[2]),
           "limit": OPT_TOL,
           "ell_max_rel": rel_max(ell._fint_stacked(d), want),
           "ebe_max_rel": rel_max(ebe._fint_stacked(d), want),
           "ell_control_max_rel": rel_max(ctl_ell._fint_stacked(d), want),
           "ebe_control_max_rel": rel_max(ctl_ebe._fint_stacked(d), want)}
    res["failures"] = [msg for bad, msg in (
        (not res["ell_max_rel"] <= OPT_TOL, "the ell force departs from K d"),
        (not res["ebe_max_rel"] <= OPT_TOL, "the ebe force departs from K d"),
        (not res["ell_control_max_rel"] > OPT_TOL,
         "the check does not reject shifted ell columns"),
        (not res["ebe_control_max_rel"] > OPT_TOL,
         "the check does not reject a dropped element"),
    ) if bad]
    return res


def check_permute_vs_psum(dev, cells=(48, 4, 4), parts=8, steps=200,
                          min_owners=2):
    """200 exchanged steps on the card with the permute exchange against
    the same run with psum, float64, dense, at one of the sweep's meshes
    (48x4x4/8, and 96x8x8/64, where a shared node has more than two
    owners and so sums contributions over several rounds in the JAX
    package's round order), from a seeded displacement; both step from
    CUDA graphs. Limit 1e-12 of the trajectory's max. The control, the
    permute exchange with its last round dropped, must be rejected; the
    most owners of a shared node must reach ``min_owners``."""
    import dataclasses

    import numpy as np
    import torch

    from savtpu_torch.parallel import ShardedProblem

    prob, maps = rcb_setup(cells, parts)
    sps = {ex: ShardedProblem.build(prob, maps, fint_mode="dense",
                                    exchange_mode=ex, dtype=torch.float64,
                                    device=dev)
           for ex in ("psum", "permute")}
    pm = sps["permute"]
    ctl = dataclasses.replace(pm, **{k: getattr(pm, k)[:, :-1] for k in (
        "nx_pack", "nx_unpack", "nx_mask", "nx_src")})
    dg = 1e-3 * np.random.default_rng(SEED).standard_normal(prob.ndof)
    traj = {}
    for name, sp in (*sps.items(), ("control", ctl)):
        d0 = sp.localize(dg)
        (traj[name], _), _ = sp.stacked_run(d0, d0, 0.0, steps, sync=True,
                                            record="traj")
    owners = np.bincount(np.concatenate(maps.shared_nodes))
    res = {"cells": list(cells), "parts": parts, "steps": steps,
           "rounds": int(pm.nx_pack.shape[1]),
           "buffer": int(pm.nx_pack.shape[2]),
           "max_owners": int(owners.max()),
           "nodes_over_two_owners": int((owners > 2).sum()),
           "limit": OPT_TOL,
           "max_rel": rel_max(traj["permute"], traj["psum"]),
           "control_max_rel": rel_max(traj["control"], traj["psum"])}
    res["failures"] = [msg for bad, msg in (
        (not res["max_owners"] >= min_owners,
         f"no shared node has {min_owners} owners"),
        (not res["max_rel"] <= OPT_TOL,
         "the permute exchange departs from psum"),
        (not res["control_max_rel"] > OPT_TOL,
         "the check does not reject a dropped permute round"),
    ) if bad]
    return res


def smoothstep(n, dtype, dev):
    import torch

    t = torch.linspace(0.0, 1.0, n, dtype=dtype, device=dev)
    return t * t * (3.0 - 2.0 * t)


def check_blend(dev, cells=(48, 4, 4), parts=8, steps=200):
    """The blend's endpoints on the card, float64, dense, plain and
    compensated steppers: w = 1 against the exchanged run (the free
    dynamics) and w = 0 against the comm-free overwrite, limit 1e-12 of
    the max (the plain stepper's bit for bit); a constant w = 1/2 must be
    rejected by both. Then the smoothstep ramp replayed from CUDA graphs
    against the eager loop, bit for bit, in float32."""
    import torch

    from savtpu_torch.parallel import ShardedProblem

    prob, maps = rcb_setup(cells, parts)
    res = {"cells": list(cells), "parts": parts, "steps": steps,
           "limit": OPT_TOL}
    failures = []
    for comp in (False, True):
        sp = ShardedProblem.build(prob, maps, fint_mode="dense",
                                  dtype=torch.float64, compensated=comp,
                                  device=dev)
        d0, dn, t0, preds = stepper_inputs(sp, steps)
        one = torch.ones(steps, dtype=sp.dtype, device=dev)

        def run(sync, blend=None, p=preds):
            return sp.stacked_run(d0, dn, t0, steps, sync=sync, preds=p,
                                  blend=blend, record="traj")[0][0]

        free, over = run(True, p=None), run(False)
        b1, b0 = run(True, one), run(False, 0.0 * one)
        h1, h0 = run(True, 0.5 * one), run(False, 0.5 * one)
        tag = "compensated" if comp else "plain"
        res[tag] = {
            "w1_vs_free_max_rel": rel_max(b1, free),
            "w0_vs_overwrite_max_rel": rel_max(b0, over),
            "w1_equal": bool(torch.equal(b1, free)),
            "w0_equal": bool(torch.equal(b0, over)),
            "control_max_rel": min(rel_max(h1, free), rel_max(h0, over))}
        r = res[tag]
        failures += [f"{tag}: {msg}" for bad, msg in (
            (not r["w1_vs_free_max_rel"] <= OPT_TOL,
             "w = 1 departs from the free dynamics"),
            (not r["w0_vs_overwrite_max_rel"] <= OPT_TOL,
             "w = 0 departs from the overwrite"),
            (not comp and not (r["w1_equal"] and r["w0_equal"]),
             "the plain stepper's endpoints are not bit for bit"),
            (not r["control_max_rel"] > OPT_TOL,
             "the check does not reject w = 1/2"),
        ) if bad]
    sp32 = ShardedProblem.build(prob, maps, fint_mode="dense",
                                dtype=torch.float32, compensated=True,
                                device=dev)
    d0, dn, t0, preds = stepper_inputs(sp32, 250)
    kw = dict(sync=True, preds=preds, record="all", save_every=5,
              blend=smoothstep(250, sp32.dtype, dev))
    a = sp32._stacked_run_eager(d0, dn, t0, 250, **kw)
    b = sp32._stacked_run_chunked(d0, dn, t0, 250, **kw)
    torch.cuda.synchronize()
    flat = lambda o: [o[0][0], o[0][1], *o[1]]  # noqa: E731
    res["replay_vs_eager_max_abs"] = worst_abs(flat(a), flat(b))
    if res["replay_vs_eager_max_abs"] != 0.0:
        failures.append("a blended graph replay differs from the eager loop")
    res["failures"] = failures
    return res


def check_options_graphs(dev, cells=(48, 4, 4), parts=8, steps=25):
    """ell, ebe and the permute exchange (dense and banded), plain and
    compensated float32, replayed from CUDA graphs against the eager
    loop: sync on and off, predictions with and without the smoothstep
    blend, save_every 1 and 5, over two full chunks and a remainder;
    bit for bit (no atomics in the ebe fold or the permute's add)."""
    import itertools

    import torch

    from savtpu_torch.parallel import ShardedProblem

    prob, maps = rcb_setup(cells, parts)
    worst, cases = 0.0, 0
    flat = lambda o: [x for x in (o[0][0], o[0][1], *o[1])  # noqa: E731
                      if x is not None]
    for (mode, ex), comp in itertools.product(
            (("ell", "psum"), ("ebe", "psum"), ("dense", "permute"),
             ("banded", "permute")), (False, True)):
        sp = ShardedProblem.build(prob, maps, fint_mode=mode,
                                  exchange_mode=ex, dtype=torch.float32,
                                  compensated=comp, device=dev)
        d0, dn, t0, preds = stepper_inputs(sp, steps)
        w = smoothstep(steps, sp.dtype, dev)
        for sync, (p, b), se in itertools.product(
                (True, False), ((None, None), (preds, None), (preds, w)),
                (1, 5)):
            kw = dict(sync=sync, preds=p, blend=b, record="all",
                      save_every=se)
            a = flat(sp._stacked_run_eager(d0, dn, t0, steps, **kw))
            c = flat(sp._stacked_run_chunked(d0, dn, t0, steps,
                                             graph_steps=10, **kw))
            torch.cuda.synchronize()
            worst = max(worst, worst_abs(a, c))
            cases += 1
    res = {"cases": cases, "replay_vs_eager_max_abs": worst}
    res["failures"] = ["a graph replay differs from the eager loop"] \
        if worst != 0.0 else []
    return res


def check_ghost_vs_cpu(dev):
    """The unramped load's ghost step on the card against the CPU,
    float64: the dense solve on the default beam (25x1x1, 312 DOFs),
    limit 1e-12; the CG on a 42x6x6 beam (6,321 DOFs, above the dense
    path's 6,144), limit 1e-10 (CG's 1e-12 residual), with its iteration
    count on each device; the control, the card's CG stopped at half its
    iterations, must be rejected."""
    import dataclasses

    import torch

    from savtpu_torch.config import Config
    from savtpu_torch.ops.element import batch_element_mkf
    from savtpu_torch.solvers import (
        ghost_step_init,
        ghost_step_init_cg,
        setup_problem,
    )

    def ghost(cells, fn, device, **kw):
        cfg = Config()
        cfg.beam_cells = cells
        cfg.beam_extent = (cells[0] / cells[1], 1.0, 1.0)
        cfg.material.ramped = False
        prob = setup_problem(cfg)
        mat = dataclasses.replace(prob.material, ramped=False)
        arrays = [t.to(device) for t in batch_element_mkf(
            prob.deg, prob.n_quad, mat, 0.0, prob.coords)]
        z = torch.zeros(prob.ndof, dtype=torch.float64, device=device)
        return prob.ndof, fn(*arrays, prob.edofs, prob.ndof,
                             prob.dirichlet_dofs, z, z, prob.dt, **kw)

    ndof_d, card = ghost((25, 1, 1), ghost_step_init, dev)
    _, cpu = ghost((25, 1, 1), ghost_step_init, "cpu")
    info_card, info_cpu, info_ctl = {}, {}, {}
    ndof_cg, cg_card = ghost((42, 6, 6), ghost_step_init_cg, dev,
                             info=info_card)
    _, cg_cpu = ghost((42, 6, 6), ghost_step_init_cg, "cpu", info=info_cpu)
    _, cg_ctl = ghost((42, 6, 6), ghost_step_init_cg, dev, info=info_ctl,
                      maxiter=max(1, info_card["iterations"] // 2))
    res = {"dense": {"ndof": ndof_d, "limit": OPT_TOL,
                     "max_abs_dn": float(cpu.abs().max()),
                     "max_rel": rel_max(card, cpu)},
           "cg": {"ndof": ndof_cg, "limit": 1e-10,
                  "iterations_card": info_card["iterations"],
                  "iterations_cpu": info_cpu["iterations"],
                  "max_rel": rel_max(cg_card, cg_cpu),
                  "control_max_rel": rel_max(cg_ctl, cg_cpu)}}
    res["failures"] = [msg for bad, msg in (
        (not res["dense"]["max_rel"] <= OPT_TOL,
         "the dense ghost step departs from the CPU's"),
        (not res["dense"]["max_abs_dn"] > 0.0, "the ghost step is zero"),
        (not res["cg"]["max_rel"] <= 1e-10,
         "the CG ghost step departs from the CPU's"),
        (not res["cg"]["control_max_rel"] > 1e-10,
         "the check does not reject a CG stopped early"),
    ) if bad]
    return res


def options_sweep_cases():
    """The sweep's cases of the solver-options slice, as it lists them
    (uncompensated), with its own step counts."""
    from savtpu_torch.benchmarks import sweep

    cases = {sweep.case_tag(c)[:4]: c for c in sweep.CASES
             if sweep.case_tag(c)[:4] in OPTIONS_SWEEP
             and not sweep.case_tag(c)[4]}
    if sorted(cases) != sorted(OPTIONS_SWEEP):
        raise RuntimeError(f"the sweep lacks a case of {OPTIONS_SWEEP}")
    return [cases[k] for k in OPTIONS_SWEEP]


def run_options_sweep(dev):
    """The slice's sweep cases through ``bench_case``, launch counts set
    to 0 just before each and read just after: the banded case must
    launch K4 once per comm-free run (its untimed and timed run), the
    others no kernel (ell, ebe and the permute exchange are tensor ops, as
    they are XLA ops in the JAX package). Returns (rows, total launches
    per kernel)."""
    import torch

    from savtpu_torch.benchmarks import sweep

    rows, totals = [], dict.fromkeys(sweep.KERNELS, 0)
    for case in options_sweep_cases():
        for fn in sweep.KERNELS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        row = sweep.bench_case(*case, device=dev)
        counts = {k: fn.launches for k, fn in sweep.KERNELS.items()}
        expect = dict.fromkeys(sweep.KERNELS, 0)
        if row["fint_mode"] == "banded":
            expect["scan_comm_free_banded"] = 2
        row.update(steps=case[5], kernel_launches=counts,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   case_s=time.perf_counter() - t0)
        rows.append(row)
        if counts != expect:
            raise RuntimeError(f"{case}: launches {counts}, expected "
                               f"{expect}")
        for k in totals:
            totals[k] += counts[k]
    return rows, totals


def run_slice_resync(root: Path, dev, steps, dtype, slice_commfree):
    """Stage 4 of the slice again, from a copy of its stage 1-3
    artifacts, with ``resync_blocks = 1``: at 9,000 steps one K3 block,
    then one blended exchanged block (no kernel), then stage 5. K3's
    launches counted from 0; the warm-up rows equal stage 1's bit for
    bit; the rel-L2 beside the slice's."""
    from savtpu_torch.pipeline import online_predictor, plotter

    shutil.copytree(root / "slice", root / "slice_resync")
    cfg = slice_config(root / "slice_resync", steps, dtype)
    cfg.surrogate.resync_blocks = 1
    zero_kernel_launches()
    t0 = time.perf_counter()
    online_predictor.run(cfg, verbose=False, device=dev)
    s4 = time.perf_counter() - t0
    launches = linear_kernel_launches()
    metrics = plotter.run(cfg, verbose=False)
    res = path_readings(cfg, metrics, {"stage4_s": round(s4, 3)}, steps,
                        SAVE_EVERY)
    ev = stage_events(cfg)["stage4_online"]
    block = cfg.surrogate.block_size
    full = (steps - cfg.surrogate.i_cri - 1) // block
    resyncs = ev["n_resync_steps"] // block
    res.update(k1_k4_launches=launches, resync_blocks=resyncs,
               comm_free_fraction=ev["comm_free_fraction"],
               slice_commfree_rel_l2_nonshared=slice_commfree)
    rel = [res["global_rel_l2_nonshared"], res["commfree_rel_l2_nonshared"]]
    res["failures"] = [msg for bad, msg in (
        (not all(math.isfinite(x) for x in rel), f"non-finite rel-L2 {rel}"),
        (not res["warmup_rows_equal"],
         "stage-4 warm-up rows differ from stage 1"),
        (resyncs != full // 2, f"{resyncs} resync blocks"),
        (launches["online_chunk"] != full - resyncs,
         f"K3 launched {launches['online_chunk']} times, expected "
         f"{full - resyncs} (none in a resync block)"),
        (any(v for k, v in launches.items() if k != "online_chunk"),
         f"another kernel launched: {launches}"),
    ) if bad]
    return cfg, res


def modeled_rows(cfg, what="modeled_h5"):
    """Every rank's stored trajectory of ``what``."""
    from savtpu_torch.io.artifacts import ArtifactStore, load_displacement

    st = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    return [load_displacement(getattr(st, what)(r))
            for r in range(cfg.partition.n_parts)], st


def run_checkpoint_resume(root: Path, dev, resync_cfg, steps, dtype):
    """Kill-and-resume, bit for bit. (1) The stage-1 command line
    (``data_prepare.main``) on the default beam at CKPT_STEPS steps with
    ``--ckpt-every`` CKPT_EVERY: an uninterrupted run; a run killed (an
    injected exception in ``ShardedSolver.run``, in its third chunk) after
    its checkpoint at step 10,000, past the 3,000-step warm-up; the same
    command with
    ``--resume``. (2) slice_resync's stage 4 with ``ckpt_every``, killed
    in its first comm-free block (after the warm-up checkpoint) and run
    again: its modeled rows against slice_resync's. Each checkpoint
    directory must be gone after the run that completes."""
    import contextlib
    import io

    import numpy as np

    from savtpu_torch.config import Config
    from savtpu_torch.io.artifacts import ArtifactStore
    from savtpu_torch.parallel import ShardedSolver
    from savtpu_torch.pipeline import data_prepare, online_predictor
    from savtpu_torch.pipeline.common import build_context
    from savtpu_torch.utils.checkpoint import load_solver_state

    res, failures = {"steps": CKPT_STEPS, "ckpt_every": CKPT_EVERY}, []
    outs = {}
    root.mkdir(parents=True, exist_ok=True)
    for tag in ("uninterrupted", "killed"):
        cfg = Config()
        cfg.workdir = str(root / tag / "Results")
        cfg.model_dir = str(root / tag / "Distributed_save")
        cfg.to_json(root / f"{tag}.json")
        outs[tag] = cfg
    argv = lambda tag, *a: ["--config", str(root / f"{tag}.json"),  # noqa
                            "--steps", str(CKPT_STEPS), "--ckpt-every",
                            str(CKPT_EVERY), "--device", str(dev), *a]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        data_prepare.main(argv("uninterrupted", "--no-resume"))
    res["uninterrupted_s"] = round(time.perf_counter() - t0, 3)
    orig, calls = ShardedSolver.run, {"n": 0}

    def dying(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise Kill("injected kill")
        return orig(self, *a, **k)

    ShardedSolver.run = dying
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            data_prepare.main(argv("killed"))
    except Kill:
        pass
    finally:
        ShardedSolver.run = orig
    cfg = outs["killed"]
    store = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    state = store.ckpt_dir("stage1") / "state.npz"
    res["killed_at_step"] = load_solver_state(state)[3] \
        if state.exists() else None
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        data_prepare.main(argv("killed", "--resume"))
    res["resumed_s"] = round(time.perf_counter() - t0, 3)
    res["resumed_log"] = [ln for ln in log.getvalue().splitlines()
                          if "resuming" in ln]
    outs_ok = [np.array_equal(a, b) for a, b in zip(
        modeled_rows(outs["uninterrupted"], "dynamics_h5")[0],
        modeled_rows(cfg, "dynamics_h5")[0])]
    res["stage1_equal"] = all(outs_ok) and len(outs_ok) == 2
    res["stage1_ckpt_gone"] = not store.ckpt_dir("stage1").exists()
    n_sync = cfg.surrogate.i_cri + 1
    failures += [msg for bad, msg in (
        (not (res["killed_at_step"] or 0) > n_sync,
         "stage 1 was not killed after a checkpoint past the warm-up"),
        (not res["resumed_log"], "stage 1 did not resume"),
        (not res["stage1_equal"],
         "the resumed stage 1 differs from the uninterrupted run"),
        (not res["stage1_ckpt_gone"], "stage 1 left its checkpoint"),
    ) if bad]

    # (2) stage 4 with checkpoints, from a copy of slice_resync's run
    shutil.copytree(Path(resync_cfg.workdir).parent, root / "stage4")
    cfg4 = slice_config(root / "stage4", steps, dtype)
    cfg4.surrogate.resync_blocks = 1
    cfg4.solver.ckpt_every = cfg4.surrogate.block_size
    ctx = build_context(cfg4, device=dev)

    def dying_block(*a, **k):
        raise Kill("injected kill")

    ctx.sp._online_run = dying_block
    try:
        online_predictor.run(cfg4, ctx=ctx, verbose=False)
    except Kill:
        pass
    del ctx.sp._online_run
    st4 = ArtifactStore(cfg4.workdir, cfg4.model_dir,
                        cfg4.surrogate.run_tag())
    state = st4.ckpt_dir("stage4") / "state.npz"
    res["stage4_killed_at_step"] = load_solver_state(state)[3] \
        if state.exists() else None
    t0 = time.perf_counter()
    online_predictor.run(cfg4, ctx=ctx, verbose=False)
    res["stage4_resumed_s"] = round(time.perf_counter() - t0, 3)
    eq = [np.array_equal(a, b) for a, b in zip(
        modeled_rows(resync_cfg)[0], modeled_rows(cfg4)[0])]
    res["stage4_equal"] = all(eq) and len(eq) == cfg4.partition.n_parts
    res["stage4_ckpt_gone"] = not st4.ckpt_dir("stage4").exists()
    failures += [msg for bad, msg in (
        (res["stage4_killed_at_step"] != cfg4.surrogate.i_cri + 1,
         "stage 4 was not killed after its warm-up checkpoint"),
        (not res["stage4_equal"],
         "the resumed stage 4 differs from slice_resync's"),
        (not res["stage4_ckpt_gone"], "stage 4 left its checkpoint"),
    ) if bad]
    res["failures"] = failures
    return res


def run_unramped_beam(root: Path, dev, steps=UNRAMPED_STEPS):
    """The default beam (25x1x1, 2 parts, float64, dense) with
    ``material.ramped = False`` through stage 1: the ghost step d_{-1}
    (the consistent-mass solve of the full load at t = 0) nonzero, the
    run finite and moving from its first step."""
    import numpy as np

    from savtpu_torch.config import Config
    from savtpu_torch.pipeline import data_prepare
    from savtpu_torch.pipeline.common import build_context

    cfg = Config()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.material.ramped = False
    cfg.solver.num_steps = steps
    t0 = time.perf_counter()
    ctx = build_context(cfg, device=dev)
    setup_s = time.perf_counter() - t0
    data_prepare.run(cfg, ctx=ctx, verbose=False)
    rows, _ = modeled_rows(cfg, "dynamics_h5")
    ev = stage_events(cfg)
    res = {"steps": steps, "ndof": ctx.prob.ndof,
           "setup_s": round(setup_s, 3),
           "ramped": ctx.sp.ramped,
           "ghost_max_abs": float(ctx.prob.dn.abs().max()),
           "first_row_max_abs": max(float(np.abs(r[:, 0]).max())
                                    for r in rows),
           "max_abs": max(float(np.abs(r).max()) for r in rows),
           "finite": all(bool(np.isfinite(r).all()) for r in rows),
           "stage1_s": ev["stage1_solve"]["seconds"],
           "stage1_steps_per_s": ev["stage1_solve"]["steps_per_sec"]}
    res["failures"] = [msg for bad, msg in (
        (res["ramped"], "the problem is ramped"),
        (not res["ghost_max_abs"] > 0.0, "the ghost step is zero"),
        (not res["finite"], "non-finite trajectory"),
        (not res["first_row_max_abs"] > 0.0,
         "the run does not move from its first step"),
    ) if bad]
    return res


# ---- the serial-solver and steady slice: the serial explicit runner
# ---- (linear and Neo-Hookean), the steady routes, the steady-only P2
# ---- path, the stage-3 grid, roofline, profiling and offload

# serial_explicit_vs_sharded's depth on the default beam, and its limit
# (savtpu's test_emulated_exchanged_matches_serial)
SERIAL_STEPS = 2_000
SERIAL_TOL = 1e-12
# serial_nh_vs_sharded's depth at nh_box_96's layout, and its limit: the
# Neo-Hookean stress is float64's eps over the strain from rest (PERF.md)
NH_SERIAL_STEPS = 200
NH_SERIAL_TOL = 1e-8
# the dense steady route, card against CPU: two LU factorizations (cuSOLVER,
# LAPACK) agree to the solve's forward error, eps * kappa(K), about 4e-12 on
# the default beam; savtpu's own dense-against-sparse steady bound is 1e-10
STEADY_DENSE_TOL = 1e-10
# the two-level PCG's sizes: the slice's beam (23,571 DOFs: the coarse
# space engages past 20,000), and the --pcg-big one (97,851 DOFs)
PCG_CELLS = (96, 8, 8)
PCG_BIG_CELLS = (192, 12, 12)
# PCG's limits: its distance from SciPy's direct solution (savtpu's
# tests/test_assembly_solvers.py bound), and its relative residual at
# most twice the direct solve's own. savtpu's small-mesh 1e-9 does not
# hold at these sizes for any float64 solve: the floor eps * kappa(K)
# grows with the mesh, and SciPy's direct solve itself reads 1.9e-9 at
# 96x8x8 and 1.8e-8 at 192x12x12 (both residuals are printed)
PCG_VS_DIRECT = 1e-7
PCG_RESIDUAL_VS_DIRECT = 2.0
# the steady-only P2 beam: 48x4x4 promotes to 97 x 9 x 9 nodes (23,571
# DOFs, PCG's route), and its limits
P2_CELLS = (48, 4, 4)
P2_TOL = 1e-8
# stage 3's grid on the default run's artifacts: two learning rates,
# each at this many epochs
GRID_EPOCHS = 10
# savtpu's refusal of the dynamic path at deg = 2, with the port's name
P2_REFUSAL = (
    "the distributed dynamic pipeline is P1-only; deg=2 is steady-only, "
    "like the reference (Data_prepare.py:42) — use "
    "savtpu_torch.pipeline.data_prepare.run or api.Simulation.steady()")


def serial_run(prob, op, steps, save_every=1):
    """``run_explicit`` over the operator ``op`` from the problem's
    (d0, d_{-1}) at t = 0, on the operator's device."""
    from savtpu_torch.solvers import make_step_fn, run_explicit

    step = make_step_fn(op, prob.F_pre, prob.lumped_M, prob.mask,
                        prob.alpha, prob.dt)
    return run_explicit(step, prob.d0, prob.dn, 0.0, prob.dt, steps,
                        save_every=save_every)[0]


def globalized(sp, traj, ndof):
    """(P, T, DL) exchanged trajectory -> (T, ndof) float64 numpy by
    global DOF (owners agree in an exchanged run)."""
    import numpy as np

    t = traj.detach().cpu().double().numpy()
    out = np.zeros((t.shape[1], ndof))
    dm = sp.dof_mask.cpu().numpy()
    for p in range(sp.n_parts):
        n = int(dm[p].sum())
        out[:, sp.local_dofs_global[p, :n]] = t[p, :, :n]
    return out


def row_rel(a, b):
    """max over the rows of b that are not zero of ||a - b|| / ||b||."""
    import numpy as np

    a, b = (np.asarray(t.detach().cpu() if hasattr(t, "detach") else t,
                       dtype=np.float64) for t in (a, b))
    nb = np.linalg.norm(b, axis=1)
    keep = nb > 0
    return float((np.linalg.norm(a - b, axis=1)[keep] / nb[keep]).max())


def default_sharded(dev, cfg=None):
    """The default Config()'s problem (25x1x1 beam, 2 RCB parts, float64)
    and its ShardedProblem, built as build_context builds it, on
    ``dev``."""
    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu_torch.solvers import setup_problem

    cfg = cfg or Config()
    prob = setup_problem(cfg)
    m = prob.mesh
    ep = partition_elements(m.tetra, m.points, cfg.partition.n_parts,
                            method=cfg.partition.method)
    maps = build_partition_maps(m.tetra, ep, m.num_points,
                                dirichlet_nodes(m.triangles, m.points))
    return prob, ShardedProblem.build(prob, maps,
                                      fint_mode=cfg.solver.fint_mode,
                                      device=dev)


def check_serial_vs_sharded(dev):
    """The serial explicit runner over FIntOperator dense, ebe and bcoo on
    the card against the same run on the CPU, then the card's 2-part
    exchanged ShardedSolver.run, globalized, against the card's serial
    dense run, on the default beam over SERIAL_STEPS steps, float64,
    limit 1e-12 (of the max and in norm row by row); "auto" resolving as
    savtpu's does (dense up to dense_cutoff DOFs, else ebe). The control,
    the serial operator with its first element's K_e zeroed, must be
    rejected."""
    import torch

    from savtpu_torch.ops.assembly import FIntOperator
    from savtpu_torch.parallel import ShardedSolver

    prob, sp = default_sharded(dev)
    res = {"steps": SERIAL_STEPS, "ndof": prob.ndof, "n_parts": sp.n_parts,
           "fint_mode": sp.fint_mode, "limit": SERIAL_TOL}
    Ke_card = prob.Ke.to(dev)
    serial = {}
    for mode in ("dense", "ebe", "bcoo"):
        t0 = time.perf_counter()
        card = serial_run(prob, FIntOperator(Ke_card, prob.edofs, prob.ndof,
                                             mode=mode), SERIAL_STEPS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = serial_run(prob, FIntOperator(prob.Ke, prob.edofs, prob.ndof,
                                            mode=mode), SERIAL_STEPS)
        t2 = time.perf_counter()
        serial[mode] = card
        res[f"serial_{mode}"] = {
            "device": str(card.device), "max_rel": rel_max(card, cpu),
            "card_s": round(t1 - t0, 3), "cpu_s": round(t2 - t1, 3)}
    res["auto_mode"] = FIntOperator(Ke_card, prob.edofs, prob.ndof).mode
    res["auto_mode_cutoff_below_ndof"] = FIntOperator(
        Ke_card, prob.edofs, prob.ndof, dense_cutoff=prob.ndof - 1).mode
    t0 = time.perf_counter()
    (traj, _), _ = ShardedSolver(sp).run(
        sp.localize(prob.d0), sp.localize(prob.dn), 0.0, SERIAL_STEPS,
        sync=True, record="traj")
    torch.cuda.synchronize()
    res["sharded_s"] = round(time.perf_counter() - t0, 3)
    g = globalized(sp, traj, prob.ndof)
    ref = serial["dense"]
    Ke_ctl = Ke_card.clone()
    Ke_ctl[0] = 0.0
    ctl = serial_run(prob, FIntOperator(Ke_ctl, prob.edofs, prob.ndof,
                                        mode="dense"), SERIAL_STEPS)
    res.update(sharded_vs_serial_max_rel=rel_max(g, ref),
               sharded_vs_serial_row_rel=row_rel(g, ref),
               max_abs=float(ref.abs().max()),
               control_max_rel=rel_max(g, ctl))
    res["failures"] = [msg for bad, msg in (
        *((not res[f"serial_{m}"]["max_rel"] <= SERIAL_TOL,
           f"the serial {m} run on the card departs from the CPU's")
          for m in ("dense", "ebe", "bcoo")),
        (any(res[f"serial_{m}"]["device"] == "cpu"
             for m in ("dense", "ebe", "bcoo")),
         "a serial run did not run on the card"),
        ((res["auto_mode"], res["auto_mode_cutoff_below_ndof"])
         != ("dense", "ebe"), "auto resolves unlike savtpu's"),
        (not res["sharded_vs_serial_max_rel"] <= SERIAL_TOL,
         "the exchanged run departs from the serial one"),
        (not res["sharded_vs_serial_row_rel"] <= SERIAL_TOL,
         "the exchanged run departs from the serial one (row norms)"),
        (not res["max_abs"] > 0.0, "the serial run does not move"),
        (not res["control_max_rel"] > SERIAL_TOL,
         "the check does not reject a zeroed element"),
    ) if bad]
    return res


def check_serial_nh_vs_sharded(dev):
    """NeoHookeanFIntOperator + run_explicit on the card against the
    sharded Neo-Hookean run at nh_box_96's layout (96x8x8, 16 box parts,
    the stencil, the grid exchange), exchanged, float64, over
    NH_SERIAL_STEPS steps from rest, limit NH_SERIAL_TOL of the max. The
    control, the serial operator without its first element, must be
    rejected."""
    import torch

    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.parallel import ShardedProblem, ShardedSolver
    from savtpu_torch.solvers import NeoHookeanFIntOperator

    prob, maps, _ = box_setup((96, 8, 8), 16)
    mat = NeoHookean.from_engineering(**NH_MAT)
    sp = ShardedProblem.build(prob, maps, material=mat,
                              exchange_mode="grid", device=dev)
    t0 = time.perf_counter()
    (traj, _), _ = ShardedSolver(sp).run(
        sp.localize(prob.d0), sp.localize(prob.dn), 0.0, NH_SERIAL_STEPS,
        sync=True, record="traj")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    coords = prob.coords.to(dev)
    ref = serial_run(prob, NeoHookeanFIntOperator(
        mat, coords, prob.edofs, prob.ndof), NH_SERIAL_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the first element (at the clamp, where the run strains first)
    ctl = serial_run(prob, NeoHookeanFIntOperator(
        mat, coords[1:], prob.edofs[1:], prob.ndof), NH_SERIAL_STEPS)
    g = globalized(sp, traj, prob.ndof)
    res = {"steps": NH_SERIAL_STEPS, "ndof": prob.ndof,
           "elements": len(prob.edofs), "n_parts": sp.n_parts,
           "fint_mode": sp.fint_mode,
           "nh_stencil_dims": list(sp.nhs_dims or ()),
           "exchange_mode": sp.exchange_mode, "limit": NH_SERIAL_TOL,
           "serial_device": str(ref.device),
           "max_rel": rel_max(g, ref), "max_abs": float(ref.abs().max()),
           "control_max_rel": rel_max(g, ctl),
           "sharded_s": round(t1 - t0, 3), "serial_s": round(t2 - t1, 3)}
    res["failures"] = [msg for bad, msg in (
        (res["fint_mode"] != "nh" or not res["nh_stencil_dims"],
         "the sharded run is not on the Neo-Hookean stencil"),
        (res["serial_device"] == "cpu", "the serial run is on the CPU"),
        (not res["max_rel"] <= NH_SERIAL_TOL,
         "the sharded Neo-Hookean run departs from the serial one"),
        (not res["max_abs"] > 0.0, "the serial run does not move"),
        (not res["control_max_rel"] > NH_SERIAL_TOL,
         "the check does not reject a dropped element"),
    ) if bad]
    return res


def beam_problem(cells, deg=1):
    """A float64 beam of ``cells`` (length nx/ny, as the sweep's)."""
    from savtpu_torch.config import Config
    from savtpu_torch.solvers import setup_problem

    cfg = Config()
    cfg.beam_cells = cells
    cfg.beam_extent = (cells[0] / cells[1], 1.0, 1.0)
    cfg.solver.deg = deg
    return setup_problem(cfg)


def steady_pcg_vs_direct(prob, dev, control=False):
    """steady_displacement of ``prob`` (past 6,000 DOFs: host PCG) against
    SciPy's sparse direct solve of the same system: seconds, iterations,
    both relative residuals and their distance; with ``control`` also a
    PCG stopped at an eighth of its iterations."""
    import dataclasses

    import numpy as np

    from savtpu_torch.ops.element import batch_element_mkf
    from savtpu_torch.solvers import steady_displacement
    from savtpu_torch.solvers import steady as st

    info = {}
    t0 = time.perf_counter()
    d = steady_displacement(prob, device=dev, info=info)
    pcg_s = time.perf_counter() - t0
    mat = dataclasses.replace(prob.material, ramped=False)
    Ke = prob.Ke.numpy()
    Fe = batch_element_mkf(prob.deg, prob.n_quad, mat, 0.0,
                           prob.coords)[2].numpy()
    args = (Ke, Fe, prob.edofs, prob.ndof, prob.dirichlet_dofs)
    t0 = time.perf_counter()
    x = st._steady_solve_sparse_host(*args)
    direct_s = time.perf_counter() - t0
    K, F, _ = st._dirichlet_system(*args)
    nF = np.linalg.norm(F)
    res = {"ndof": prob.ndof, "route": info["route"],
           "pcg_s": round(pcg_s, 3), "pcg_setup_s": info.get("setup_s"),
           "pcg_iterations": info.get("iterations"),
           "coarse_cells": info.get("coarse_cells"),
           "pcg_rel_residual": info.get("rel_residual"),
           "direct_s": round(direct_s, 3),
           "direct_rel_residual": float(np.linalg.norm(F - K @ x) / nF),
           "pcg_vs_direct": float(np.linalg.norm(d - x) / np.linalg.norm(x))}
    if control:
        xc, _ = st._steady_solve_pcg(
            *args, points=prob.mesh.points,
            maxiter=max(1, info["iterations"] // 8))
        res["control_vs_direct"] = float(np.linalg.norm(xc - x)
                                         / np.linalg.norm(x))
    return res


def check_steady_routes(dev):
    """The steady routes: the dense route on the default beam (312 DOFs,
    torch.linalg.solve on the card) against the CPU (STEADY_DENSE_TOL);
    two-level PCG at PCG_CELLS (23,571 DOFs, the coarse space engaged)
    against SciPy's direct solve (PCG_VS_DIRECT; residual at most
    PCG_RESIDUAL_VS_DIRECT times the direct solve's),
    both timed; ``eigen_modes`` on the default beam on the card against
    the CPU (1e-10 of the largest). The control, PCG stopped at an eighth
    of its iterations, must be rejected."""
    import dataclasses

    from savtpu_torch.config import Config
    from savtpu_torch.ops.element import batch_element_mkf
    from savtpu_torch.solvers import (
        eigen_modes,
        setup_problem,
        steady_displacement,
    )

    prob = setup_problem(Config())
    info = {}
    card = steady_displacement(prob, device=dev, info=info)
    cpu = steady_displacement(prob, device="cpu")
    mat = dataclasses.replace(prob.material, ramped=False)
    Me, Ke, _ = batch_element_mkf(prob.deg, prob.n_quad, mat, 0.0,
                                  prob.coords)
    ddofs = prob.dirichlet_dofs
    f_card = eigen_modes(Me.to(dev), Ke.to(dev), prob.edofs, prob.ndof,
                         ddofs)
    f_cpu = eigen_modes(Me, Ke, prob.edofs, prob.ndof, ddofs)
    res = {"dense": {"ndof": prob.ndof, "route": info["route"],
                     "limit": STEADY_DENSE_TOL,
                     "max_rel": rel_max(card, cpu),
                     "max_abs": float(abs(cpu).max())},
           "eigen_modes": {"limit": 1e-10, "device": str(f_card.device),
                           "max_rel": rel_max(f_card, f_cpu),
                           "zero_modes": int((f_cpu == 0).sum()),
                           "first_hz": [float(f) for f in f_cpu[
                               len(ddofs):len(ddofs) + 4]]},
           "pcg": {"cells": list(PCG_CELLS), "limit_vs_direct":
                   PCG_VS_DIRECT,
                   "limit_residual_vs_direct": PCG_RESIDUAL_VS_DIRECT,
                   **steady_pcg_vs_direct(beam_problem(PCG_CELLS), dev,
                                          control=True)}}
    pcg = res["pcg"]
    res["failures"] = [msg for bad, msg in (
        (res["dense"]["route"] != "dense", "the default beam is not dense"),
        (not res["dense"]["max_rel"] <= STEADY_DENSE_TOL,
         "the dense steady route on the card departs from the CPU's"),
        (not res["dense"]["max_abs"] > 0.0, "the steady solution is zero"),
        (res["eigen_modes"]["device"] == "cpu", "eigen_modes ran on the CPU"),
        (not res["eigen_modes"]["max_rel"] <= 1e-10,
         "eigen_modes on the card depart from the CPU's"),
        (res["eigen_modes"]["zero_modes"] != len(ddofs),
         "a constrained DOF is not a zero mode"),
        (pcg["route"] != "pcg" or pcg["coarse_cells"] is None,
         "the 96x8x8 solve did not take two-level PCG"),
        (not pcg["pcg_rel_residual"]
         <= PCG_RESIDUAL_VS_DIRECT * pcg["direct_rel_residual"],
         "PCG's residual is above its limit"),
        (not pcg["pcg_vs_direct"] <= PCG_VS_DIRECT,
         "PCG departs from the direct solve"),
        (not pcg["control_vs_direct"] > PCG_VS_DIRECT,
         "the check does not reject a PCG stopped early"),
    ) if bad]
    return res


def check_steady_big(dev):
    """--pcg-big: two-level PCG at PCG_BIG_CELLS (97,851 DOFs) against
    SciPy's direct solve, both timed (same limits as steady_routes)."""
    res = {"cells": list(PCG_BIG_CELLS),
           **steady_pcg_vs_direct(beam_problem(PCG_BIG_CELLS), dev)}
    res["failures"] = [msg for bad, msg in (
        (res["route"] != "pcg", "the solve did not take PCG"),
        (not res["pcg_rel_residual"]
         <= PCG_RESIDUAL_VS_DIRECT * res["direct_rel_residual"],
         "PCG's residual is above its limit"),
        (not res["pcg_vs_direct"] <= PCG_VS_DIRECT,
         "PCG departs from the direct solve"),
    ) if bad]
    return res


def vtk_displacement(path):
    """The (3 * points,) displacement of a steady VTK written by
    ``data_prepare`` (its three SCALARS fields)."""
    import numpy as np

    lines = Path(path).read_text().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("POINT_DATA")).split()[1])
    out = {}
    for i, ln in enumerate(lines):
        if ln.startswith("SCALARS displacement-"):
            out[ln.split()[1][-1]] = np.array(lines[i + 2 : i + 2 + n],
                                              dtype=np.float64)
    return np.stack([out["x"], out["y"], out["z"]], axis=1).reshape(-1)


def stage1_steady(cfg, prob):
    """A path's stage-1 steady solve, as its ``steady_solve`` event
    records it (route, PCG iterations and residual, the solve's seconds
    with the VTK write), against SciPy's sparse direct solve of the same
    system (PCG's fallback): its seconds, and the relative distance of
    the steady VTK's displacement from it. A route other than PCG, or a
    distance above PCG_VS_DIRECT, fails the path."""
    import dataclasses

    import numpy as np

    from savtpu_torch.io.artifacts import ArtifactStore
    from savtpu_torch.ops.element import batch_element_mkf
    from savtpu_torch.solvers import steady as st

    ev = stage_events(cfg)["steady_solve"]
    mat = dataclasses.replace(prob.material, ramped=False)
    Fe = batch_element_mkf(prob.deg, prob.n_quad, mat, 0.0,
                           prob.coords.cpu())[2].numpy()
    t0 = time.perf_counter()
    x = st._steady_solve_sparse_host(prob.Ke.cpu().numpy(), Fe, prob.edofs,
                                     prob.ndof, prob.dirichlet_dofs)
    direct_s = time.perf_counter() - t0
    store = ArtifactStore(cfg.workdir, cfg.model_dir,
                          cfg.surrogate.run_tag())
    d = vtk_displacement(store.steady_vtk())
    res = {**{k: ev.get(k) for k in ("ndof", "route", "iterations",
                                     "rel_residual", "coarse_cells",
                                     "setup_s", "seconds")},
           "direct_s": round(direct_s, 3),
           "vs_direct": float(np.linalg.norm(d - x) / np.linalg.norm(x))}
    res["failures"] = [msg for bad, msg in (
        (res["route"] != "pcg", f"the steady solve took {res['route']}"),
        (not res["vs_direct"] <= PCG_VS_DIRECT,
         "the steady VTK departs from the direct solve"),
    ) if bad]
    return res


def run_p2_steady(root: Path, dev):
    """The steady-only P2 path through the stage-1 command line: a
    P2_CELLS beam at ``solver.deg = 2`` (23,571 DOFs, PCG), on the card
    and again with ``--device cpu``: the VTK written, the displacements
    within P2_TOL, the tip deflection within 30% of Euler-Bernoulli (as
    savtpu's tests/test_pipeline.py checks), and build_context refusing
    deg = 2 with savtpu's message."""
    import numpy as np

    from savtpu_torch.config import Config
    from savtpu_torch.mesh import read_vtk
    from savtpu_torch.pipeline import data_prepare
    from savtpu_torch.pipeline.common import build_context

    out, secs = {}, {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        cfg = Config()
        cfg.workdir = str(root / tag / "Results")
        cfg.model_dir = str(root / tag / "Distributed_save")
        cfg.beam_cells = P2_CELLS
        cfg.beam_extent = (P2_CELLS[0] / P2_CELLS[1], 1.0, 1.0)
        cfg.solver.deg = 2
        path = root / f"{tag}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        cfg.to_json(str(path))
        t0 = time.perf_counter()
        data_prepare.main(["--config", str(path), *extra])
        secs[tag] = round(time.perf_counter() - t0, 3)
        vtk = Path(cfg.workdir) / "Static" / "steady_distributed.vtk"
        out[tag] = (cfg, vtk_displacement(vtk), read_vtk(vtk),
                    stage_events(cfg)["steady_solve"])
    cfg, d, mesh, ev = out["card"]
    d_cpu = out["cpu"][1]
    L = P2_CELLS[0] / P2_CELLS[1]
    tip = int(np.argmax(mesh.points[:, 0]))
    eb = 0.5 * L**4 / (8 * 1e6 / 12.0)
    try:
        build_context(cfg, device=dev)
        refusal = None
    except NotImplementedError as e:
        refusal = str(e)
    res = {"cells": list(P2_CELLS), "ndof": 3 * mesh.num_points,
           "tetra10": len(mesh.cells.get("tetra10", ())),
           "route": ev["route"], "pcg_iterations": ev.get("iterations"),
           "pcg_rel_residual": ev.get("rel_residual"),
           "card_s": secs["card"], "cpu_s": secs["cpu"],
           "steady_solve_s": ev["seconds"],
           "limit": P2_TOL, "max_rel": rel_max(d, d_cpu),
           "tip_deflection": float(d[3 * tip + 1]),
           "euler_bernoulli": -eb,
           "tip_vs_euler_bernoulli": abs(d[3 * tip + 1] + eb) / eb,
           "refusal": refusal}
    res["failures"] = [msg for bad, msg in (
        (res["ndof"] != 23_571 or not res["tetra10"],
         "the VTK does not hold the P2 mesh"),
        (res["route"] != "pcg", "the P2 solve did not take PCG"),
        (not res["max_rel"] <= P2_TOL,
         "the card's P2 run departs from the CPU's"),
        (not np.isfinite(d).all(), "non-finite displacement"),
        (not res["tip_vs_euler_bernoulli"] < 0.3,
         "the tip deflection is off Euler-Bernoulli by 30% or more"),
        (refusal != P2_REFUSAL,
         "build_context does not refuse deg = 2 with savtpu's message"),
    ) if bad]
    return res


def run_stage3_grid(workdir: Path, dev, epochs=GRID_EPOCHS):
    """Stage 3's grid through its command line on the default run's stage
    1-2 artifacts in ``workdir``: ``--grid-lrs`` of two learning rates
    (twice and four times the default's, so no run-tag directory of the
    default run is overwritten) at ``epochs`` epochs. Each combination's
    run-tag directory must hold every rank's model.npz with a finite
    final training loss."""
    from savtpu_torch.io.artifacts import ArtifactStore, load_params_meta
    from savtpu_torch.pipeline import model_training

    cfg = lstm_config(workdir, epochs)
    path = workdir / "grid.json"
    cfg.to_json(str(path))
    lr = cfg.surrogate.learning_rate
    lrs = (2 * lr, 4 * lr)
    t0 = time.perf_counter()
    model_training.main(["--config", str(path), "--epochs", str(epochs),
                         "--grid-lrs", *(repr(v) for v in lrs)])
    seconds = time.perf_counter() - t0
    runs = {}
    for v in lrs:
        cfg.surrogate.learning_rate = v
        store = ArtifactStore(cfg.workdir, cfg.model_dir,
                              cfg.surrogate.run_tag())
        losses = [load_params_meta(store.model_file(r))["final_train_loss"]
                  if store.model_file(r).exists() else None
                  for r in range(cfg.partition.n_parts)]
        runs[cfg.surrogate.run_tag()] = losses
    res = {"epochs": epochs, "learning_rates": list(lrs),
           "seconds": round(seconds, 3), "run_tags": runs}
    res["failures"] = [msg for bad, msg in (
        (len(runs) != 2, "the grid did not give two run tags"),
        (any(x is None or not math.isfinite(float(x))
             for losses in runs.values() for x in losses),
         "a combination lacks a model or has a non-finite loss"),
    ) if bad]
    return res


def check_roofline_profile_offload(sp_slice, sweep_rows, sweep_sps, dev,
                                   root: Path, traj_rows, k3):
    """Phase 4's utilities: ``roofline`` of the slice's exchanged stepper
    (1,000 replayed steps with record "none", after a warm-up), of K3's
    online block at the slice (``k3`` = (ms per block, steps a block, its
    band plan) from its phase-4 timing) and of the sweep's K1 rows
    (exchanged) and K4 rows (comm-free) from their measured steps/s and
    ``bytes_floor_per_step`` (for K3 and K4 with their band plan: the Kd
    rows they keep in shared memory are read once a run); no share may
    pass 100%. ``profile_trace`` around 100 replayed slice
    steps, whose Chrome trace must name the step's kernels;
    ``fetch_into`` against one direct ``copy_`` into the host array and
    a bulk ``.cpu()``, at the slice's trajectory (P x traj_rows x DL
    float32) and at its full depth (100,000 steps, save_every 50: P x
    2,000 x DL), GB/s each, best of 3 in turns, the copies equal bit for
    bit."""
    import numpy as np
    import torch

    from savtpu_torch.ops.band_plan import BandPlan
    from savtpu_torch.utils import profile_trace
    from savtpu_torch.utils.offload import fetch_into
    from savtpu_torch.utils.roofline import (
        bytes_floor_per_step,
        flops_model,
        roofline,
    )

    def line(sp, sps, plan=None):
        counted = bytes_floor_per_step(sp, plan)
        b = counted["bytes_per_step_floor"]
        f = flops_model(sp)["flops_per_step"]
        r = roofline(sps, bytes_per_step=b, flops_per_step=f, device=dev)
        out = {"steps_per_s": sps, "bytes_per_step_floor": b,
               "flops_per_step": f,
               **{k: r[k] for k in ("achieved_GBps", "pct_hbm_peak",
                                    "pct_fp32_peak",
                                    "pct_tensor_bf16_peak")}}
        if plan is not None:
            out.update(plan=vars(plan), resident_operator_bytes=counted[
                "resident_operator_bytes"], bytes_per_step_reread=(
                    bytes_floor_per_step(sp)["bytes_per_step_floor"]))
        return out

    sp = sp_slice
    d0 = torch.zeros((sp.n_parts, sp.DL), dtype=sp.dtype, device=dev)
    steps = 1000
    sp.stacked_run(d0, d0, 0.0, steps, sync=True, record="none")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp.stacked_run(d0, d0, 0.0, steps, sync=True, record="none")
    torch.cuda.synchronize()
    res = {"slice_exchanged": {"fint_mode": sp.fint_mode, **line(
        sp, steps / (time.perf_counter() - t0))}}
    k3_ms, k3_steps, k3_plan = k3
    res["slice_online_banded"] = {"ms_per_block": k3_ms,
                                  "steps_per_block": k3_steps, **line(
                                      sp, k3_steps / (k3_ms / 1e3), k3_plan)}
    for row, sp_k in zip(sweep_rows, sweep_sps):
        key = "exchanged" if sp_k.fint_mode == "pallas" else "sync_avoiding"
        tag = (f"sweep_{row['mesh']}_p{row['n_parts']}_{row['fint_mode']}_"
               f"{key}")
        plan = (None if sp_k.fint_mode != "banded" else
                BandPlan(**planned_band("banded_scan", sp_k.band_Kd)))
        res[tag] = line(sp_k, row[f"{key}_steps_per_sec"], plan)
    with profile_trace(root / "trace") as prof:
        sp.stacked_run(d0, d0, 0.0, 100, sync=True, record="none")
        torch.cuda.synchronize()
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    res["profile_trace"] = {
        "steps": 100, "trace_bytes": Path(prof.trace_path).stat().st_size,
        "kernel_events": sum(kernels.values()),
        "kernel_names": len(kernels),
        "top_kernels": {k[:60]: n for k, n in top}}
    res["offload"] = {}
    for tag, rows in (("slice", traj_rows), ("full_depth", 2000)):
        src = torch.randn((sp.n_parts, rows, sp.DL), dtype=torch.float32,
                          device=dev)
        nbytes = src.numel() * src.element_size()
        dst = {k: np.empty(tuple(src.shape), np.float32)
               for k in ("fetch_into", "copy", "bulk_cpu")}
        ways = {"fetch_into": lambda: fetch_into(dst["fetch_into"], src),
                "copy": lambda: torch.from_numpy(dst["copy"]).copy_(src),
                "bulk_cpu": lambda: dst["bulk_cpu"].__setitem__(
                    Ellipsis, src.cpu().numpy())}
        t = {k: [] for k in ways}
        for _ in range(3):
            for k, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t[k].append(time.perf_counter() - t0)
        want = src.cpu().numpy()
        res["offload"][tag] = {
            "shape": list(src.shape), "bytes": nbytes,
            **{f"{k}_GBps": nbytes / min(v) / 1e9 for k, v in t.items()},
            "equal": all(np.array_equal(a, want) for a in dst.values())}
        del src, dst, want
    res["failures"] = [msg for bad, msg in (
        (not all("pct_hbm_peak" in v for k, v in res.items()
                 if k.startswith(("slice", "sweep"))),
         "no peaks for this card"),
        (res["profile_trace"]["kernel_events"] < 100,
         "the trace does not name the step's kernels"),
        (not all(v["equal"] for v in res["offload"].values()),
         "fetch_into copies unlike .cpu()"),
        (any(v.get("pct_hbm_peak", 0.0) > 100.0 for k, v in res.items()
             if k.startswith(("slice", "sweep"))),
         "a share of the HBM peak above 100%: the count misses on-chip "
         "reuse"),
    ) if bad]
    return res


# ---- the device mesh: torch.distributed in place of shard_map, stages 1
# ---- and 4 over NCCL ranks, one process and one card each

# the default configuration's stage 1 in pallas mode under the mesh runs
# this prefix of its 100,000 steps: K1 once a step on every rank
MESH_K1_STEPS = 3_000
# the mesh's result against the emulated run's over several ranks (the
# all-reduce adds in another order): float64 1e-12, the float32 slice
# 1e-4 (K3's own limit against its plain version is 3e-5 a block)
MESH_TOL = {"float64": 1e-12, "float32": 1e-4}
# a rank still running after this many seconds prints its stacks and
# exits, which fails the spawn: a hung collective fails the script
MESH_RANK_LIMIT_S = 240
# the float32 envelope (ROADMAP C1): the mesh's departure from the
# emulated run (a) and from a float64 run of the same problem (c), each at
# most this many times the emulated run's own departure from the float64
# run (b); tests/test_torch_mesh.py holds the same factor on the CPU
MESH_ENVELOPE = 3.0


def linear_fit_inputs(P=16, G=200, D=8, seed=SEED):
    """The mesh path's linear fit: the default surrogate config with
    arch "linear", and seeded windows (X, Y, feature mask) of P models of
    D features at its n_past and n_future (P the slice's parts, D its
    modal width)."""
    import numpy as np

    from savtpu_torch.config import Config

    cfg = Config().surrogate
    cfg.arch = "linear"
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (P, G, cfg.n_past, D))
    Y = rng.uniform(0.0, 1.0, (P, G, cfg.n_future, D))
    return cfg, X, Y, np.ones((P, D))


def linear_fit_rank(mesh, rank, out_dir):
    """One rank's ``fit_stacked(mesh=, arch="linear")`` on
    :func:`linear_fit_inputs`: its block of the maps and the history
    written to out_dir/linear_rank<rank>.npz; returns its readings."""
    import numpy as np
    import torch

    from savtpu_torch.models.training import fit_stacked

    cfg, X, Y, fm = linear_fit_inputs()
    t0 = time.perf_counter()
    model, hist = fit_stacked(cfg, X, Y, fm, mesh=mesh,
                              log_fn=lambda *a: None)
    torch.cuda.synchronize()
    fit_s = round(time.perf_counter() - t0, 3)
    np.savez(Path(out_dir, f"linear_rank{rank}.npz"),
             **{f"param.{k}": v for k, v in model.arrays().items()},
             **{f"hist.{k}": v for k, v in hist.items()})
    return {"fit_s": fit_s, "models": model.n_models,
            "device": str(model.lin.W.device)}


def mesh_world(n_parts: int) -> int:
    """The mesh path's ranks for ``n_parts`` parts: one a card, the most
    the cards allow that divide the part count (1 on one card)."""
    import torch

    n = torch.cuda.device_count()
    return max(d for d in range(1, n + 1) if n_parts % d == 0)


def mesh_rank(rank, world, init, jobs, out_dir, limit_s):
    """One rank of the mesh path, a process of its own on card ``rank``:
    joins the NCCL process group at ``init``, runs each job's stages
    through ``api.Simulation(cfg, device_mesh=make_device_mesh())`` with
    the kernels' counts set to 0 just before each stage and read just
    after, and writes its readings to out_dir/rank<rank>.json. An
    exception ends the process, which fails the spawn and the script; so
    does running past ``limit_s`` seconds (its stacks are printed)."""
    import faulthandler
    import os
    from datetime import timedelta

    faulthandler.dump_traceback_later(limit_s, exit=True)

    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from savtpu_torch import api
    from savtpu_torch.config import Config
    from savtpu_torch.parallel import make_device_mesh

    torch.cuda.set_device(rank)
    # the ranks share the host: each assembles the whole problem there
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=300),
                            device_id=torch.device("cuda", rank))
    sim = ctx = fn = None
    try:
        mesh = make_device_mesh()
        readings = {}
        for job in jobs:
            if job.get("kind") == "linear_fit":
                readings[job["name"]] = linear_fit_rank(mesh, rank, out_dir)
                continue
            cfg = Config.from_json(job["cfg"])
            sim = api.Simulation(cfg, verbose=False, device_mesh=mesh)
            t0 = time.perf_counter()
            ctx = sim.ctx
            rec = {"world": world, "backend": dist.get_backend(),
                   "device": str(ctx.device), "parts": list(ctx.parts),
                   "setup_s": round(time.perf_counter() - t0, 3)}
            for stage, fn in (("stage1", sim.generate_data),
                              ("stage4", sim.run_online)):
                if stage not in job["stages"]:
                    continue
                torch.cuda.synchronize()
                zero_kernel_launches()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                rec[f"{stage}_s"] = round(time.perf_counter() - t0, 3)
                rec[f"{stage}_launches"] = linear_kernel_launches()
            readings[job["name"]] = rec
    finally:
        # the stepper's captured graphs hold NCCL work that the
        # communicator waits for when it is destroyed: free them first
        # (the last stage's bound method holds the Simulation too)
        sim = ctx = fn = None
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(readings))


def spawn_mesh(root: Path, world: int, jobs, limit_s=MESH_RANK_LIMIT_S):
    """Run ``jobs`` over ``world`` ranks (:func:`mesh_rank`); returns
    their readings in rank order and the spawn's wall seconds. The
    kernels are built before (phase 1), so no rank runs nvcc."""
    import torch
    import torch.multiprocessing as mp

    out = root / f"mesh_world{world}"
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(world, f"file://{out}/pg", jobs,
                                        str(out), limit_s),
                       nprocs=world, join=True, start_method="spawn")
    wall = round(time.perf_counter() - t0, 3)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)], wall


def artifact_diff(cfg_a, cfg_b, what, n_parts, rows=None):
    """Every part's stored ``what`` of two runs: (equal bit for bit, the
    largest |a - b| over b's largest, the largest |a - b|); ``rows`` cuts
    b to its first rows."""
    import numpy as np

    from savtpu_torch.io.artifacts import ArtifactStore, load_displacement

    sa, sb = (ArtifactStore(c.workdir, c.model_dir, c.surrogate.run_tag())
              for c in (cfg_a, cfg_b))
    equal, rel, err = True, 0.0, 0.0
    for r in range(n_parts):
        a = load_displacement(getattr(sa, what)(r))
        b = load_displacement(getattr(sb, what)(r))
        if rows is not None:
            b = b[:, :rows]
        if a.shape != b.shape or not np.isfinite(a).all():
            raise RuntimeError(f"{what} of part {r}: shapes {a.shape}, "
                               f"{b.shape} or non-finite")
        equal &= bool(np.array_equal(a, b))
        d = float(np.abs(a - b).max())
        err = max(err, d)
        rel = max(rel, d / max(float(np.abs(b).max()), 1e-300))
    return equal, rel, err


def float32_envelope(root: Path, dev, steps, cfg_mesh, cfg_emulated):
    """C1's float32 envelope on the card: the slice's stages 1 and 4 again
    in float64 (compensated, emulated) from a copy of the float32 slice's
    stage 2-3 artifacts; (a) the mesh run against the float32 emulated
    run, (b) that run against the float64 one, (c) the mesh run against
    the float64 one, each artifact_diff's largest |a - b| over b's
    largest, for the dynamics and the modeled rows."""
    from savtpu_torch import api

    shutil.copytree(root / "slice", root / "slice_f64")
    cfg64 = slice_config(root / "slice_f64", steps, "float64")
    t0 = time.perf_counter()
    sim = api.Simulation(cfg64, device=dev, verbose=False)
    sim.generate_data()
    sim.run_online()
    run_s = round(time.perf_counter() - t0, 3)
    del sim
    P = cfg_mesh.partition.n_parts
    out = {"float64_stages_1_4_s": run_s, "factor": MESH_ENVELOPE}
    for what in ("dynamics_h5", "modeled_h5"):
        a = artifact_diff(cfg_mesh, cfg_emulated, what, P)[1]
        b = artifact_diff(cfg_emulated, cfg64, what, P)[1]
        c = artifact_diff(cfg_mesh, cfg64, what, P)[1]
        out[what.split("_")[0]] = {"a_mesh_vs_emulated": a,
                                   "b_emulated_vs_float64": b,
                                   "c_mesh_vs_float64": c}
    shutil.rmtree(root / "slice_f64", ignore_errors=True)
    return out


def check_block_split(sp, args, kw, n_sm, table, parts=4):
    """What a rank of a four-card mesh computes for its block of the
    slice's 16 parts, against the same parts in the one-card batch: K3 on
    parts 0..parts-1 alone (as band_plan plans that many parts) against
    those rows of K3 on all 16, and the exchanged step's band matvec and
    translation mean (``ShardedProblem._translation_mean``, a sum over
    each part's nodes) likewise. A reading of where a mesh's float32
    rounding can depart from the emulated run's; no check."""
    import types

    import torch

    from savtpu_torch.ops.band_plan import band_plan
    from savtpu_torch.ops.online_banded import (
        band_matvec,
        block_distance,
        online_chunk,
    )

    Kd, Kl, hi = args[0], args[1], args[2]
    P, nc, Bk, _ = Kd.shape
    full = online_chunk(*args, **kw)
    block = online_chunk(*[a[:parts] for a in args], **kw)
    rows = tuple(t[:parts] for t in full)
    dist = block_distance(block, rows)
    y = band_matvec(Kd, Kl, hi)
    yb = band_matvec(Kd[:parts], Kl[:parts], hi[:parts])
    d = hi.new_zeros((P, sp.DL))
    n = min(sp.DL, hi.shape[1])
    d[:, :n] = hi[:, :n]
    block_sp = types.SimpleNamespace(
        local_dofs_global=sp.local_dofs_global[:parts],
        dof_mask=sp.dof_mask[:parts])
    tm = type(sp)._translation_mean(sp, d)
    tmb = type(sp)._translation_mean(block_sp, d[:parts].contiguous())
    torch.cuda.synchronize()
    return {
        "parts": [P, parts],
        "k3_plans": {str(n): vars(band_plan(n, nc, Bk, hi.dtype, n_sm,
                                            table)) for n in (P, parts)},
        "k3_bits_equal": {k: bool(torch.equal(a, b)) for k, a, b in zip(
            ("hi", "lo", "v", "shared", "traj"), block, rows)},
        "k3_max_rel": {k: v["max_rel"] for k, v in dist.items()},
        "band_matvec_bits_equal": bool(torch.equal(yb, y[:parts])),
        "band_matvec_max_abs": float((yb - y[:parts]).abs().max()),
        "translation_mean_bits_equal": bool(torch.equal(tmb, tm[:parts])),
        "translation_mean_max_rel": float(
            (tmb - tm[:parts]).abs().max()
            / tm[:parts].abs().max().clamp(min=1e-30)),
    }


def run_mesh_path(root: Path, dev, steps, dtype, slice_times,
                  limit_s=MESH_RANK_LIMIT_S):
    """Phase 3's mesh path. The slice: stages 1 and 4 over
    ``mesh_world(16)`` ranks from a copy of phase 3's slice (its stage
    2-3 artifacts feed stage 4), held against phase 3's emulated
    dynamics and modeled rows, K3 once a comm-free block on every rank.
    The default configuration in pallas mode: stage 1 over
    ``mesh_world(2)`` ranks for MESH_K1_STEPS steps, K1 once a step on
    every rank, held against the same prefix run emulated here. At one
    rank both must equal the emulated runs bit for bit, over several
    within MESH_TOL; in float32 the slice also within MESH_ENVELOPE of
    float32's own departure from a float64 run (:func:`float32_envelope`).
    The linear surrogate's ``fit_stacked(mesh=)`` over ``mesh_world(16)``
    ranks: the blocks joined in rank order and every rank's history
    equal to the unsharded fit's bit for bit. Returns {phase name:
    readings with "failures"}."""
    import numpy as np
    import torch

    from savtpu_torch import api
    from savtpu_torch.models.training import fit_stacked
    from savtpu_torch.ops.dense_step import batched_fint_matvec

    shutil.copytree(root / "slice", root / "mesh_slice")
    cfg_s = slice_config(root / "mesh_slice", steps, dtype)
    cfg_ref = slice_config(root / "slice", steps, dtype)
    cfg_s.to_json(root / "mesh_slice.json")
    cfg_d = lstm_config(root / "mesh_default", 1, fint_mode="pallas")
    cfg_d.solver.num_steps = MESH_K1_STEPS
    cfg_d.to_json(root / "mesh_default.json")
    cfg_e = lstm_config(root / "mesh_default_emulated", 1,
                        fint_mode="pallas")
    cfg_e.solver.num_steps = MESH_K1_STEPS
    batched_fint_matvec.launches = 0
    t0 = time.perf_counter()
    api.Simulation(cfg_e, device=dev, verbose=False).generate_data()
    emulated_s = round(time.perf_counter() - t0, 3)
    emulated_k1 = batched_fint_matvec.launches

    jobs = {"mesh_slice": dict(cfg=str(root / "mesh_slice.json"),
                               stages=["stage1", "stage4"],
                               world=mesh_world(cfg_s.partition.n_parts)),
            "mesh_default_pallas": dict(
                cfg=str(root / "mesh_default.json"), stages=["stage1"],
                world=mesh_world(cfg_d.partition.n_parts)),
            "mesh_linear_fit": dict(kind="linear_fit",
                                    world=mesh_world(16))}
    readings, walls = {}, {}
    for world in sorted({j["world"] for j in jobs.values()}):
        mine = [dict(name=n, **j) for n, j in jobs.items()
                if j["world"] == world]
        ranks, walls[world] = spawn_mesh(root, world, mine, limit_s)
        for j in mine:
            readings[j["name"]] = [r[j["name"]] for r in ranks]

    out = {}
    # the slice against phase 3's emulated run
    ranks = readings["mesh_slice"]
    world = len(ranks)
    blocks = -(-(steps - cfg_s.surrogate.i_cri - 1)
               // cfg_s.surrogate.block_size)
    P = cfg_s.partition.n_parts
    dyn = artifact_diff(cfg_s, cfg_ref, "dynamics_h5", P)
    mod = artifact_diff(cfg_s, cfg_ref, "modeled_h5", P)
    k3 = [r["stage4_launches"]["online_chunk"] for r in ranks]
    other = [{k: v for k, v in r[f"{s}_launches"].items()
              if v and not (s == "stage4" and k == "online_chunk")}
             for r in ranks for s in ("stage1", "stage4")]
    ev = stage_events(cfg_s)
    tol = MESH_TOL[dtype]
    res = {
        "world": world, "backend": ranks[0]["backend"],
        "devices": [r["device"] for r in ranks],
        "parts_per_rank": [len(r["parts"]) for r in ranks],
        "setup_s_per_rank": [r["setup_s"] for r in ranks],
        "stage1_s_per_rank": [r["stage1_s"] for r in ranks],
        "stage4_s_per_rank": [r["stage4_s"] for r in ranks],
        "emulated_stage_s": {k: slice_times[k]
                             for k in ("stage1_s", "stage4_s")},
        "stage1_solve_s_per_rank": ev["stage1_solve"]["rank_seconds"],
        "stage4_online_s_per_rank": ev["stage4_online"]["rank_seconds"],
        "stage1_steps_per_s": ev["stage1_solve"]["steps_per_sec"],
        "stage4_steps_per_s": ev["stage4_online"]["steps_per_sec"],
        "spawn_wall_s": walls[world],
        "online_banded_launches_per_rank": k3, "blocks": blocks,
        "dynamics_equal": dyn[0], "dynamics_max_rel": dyn[1],
        "modeled_equal": mod[0], "modeled_max_rel": mod[1], "tol": tol,
    }
    res["failures"] = [msg for bad, msg in (
        (any(n != blocks for n in k3),
         f"K3 launched {k3} times on the ranks, not once a comm-free "
         f"block ({blocks})"),
        (any(other), f"another kernel launched: {other}"),
        (world == 1 and not (dyn[0] and mod[0]),
         "one rank: not the emulated run's bits"),
        (not (dyn[1] <= tol and mod[1] <= tol),
         f"the mesh departs from the emulated run: {dyn[1]:.3e}, "
         f"{mod[1]:.3e}"),
    ) if bad]
    if dtype == "float32":
        env = float32_envelope(root, dev, steps, cfg_s, cfg_ref)
        res["float32_envelope"] = env
        res["failures"] += [
            f"{k}: the mesh leaves float32's envelope ({v})"
            for k, v in env.items() if isinstance(v, dict) and not (
                v["a_mesh_vs_emulated"]
                <= MESH_ENVELOPE * v["b_emulated_vs_float64"]
                and v["c_mesh_vs_float64"]
                <= MESH_ENVELOPE * v["b_emulated_vs_float64"])]
    out["mesh_slice_96x8x8_p16"] = res

    # the linear fit under the mesh against the unsharded fit
    ranks = readings["mesh_linear_fit"]
    world = len(ranks)
    cfg_l, X, Y, fm = linear_fit_inputs()
    t0 = time.perf_counter()
    ref_model, ref_hist = fit_stacked(cfg_l, X, Y, fm, device=dev,
                                      log_fn=lambda *a: None)
    torch.cuda.synchronize()
    ref_s = round(time.perf_counter() - t0, 3)
    ref = {**{f"param.{k}": v for k, v in ref_model.arrays().items()},
           **{f"hist.{k}": v for k, v in ref_hist.items()}}
    got = [dict(np.load(root / f"mesh_world{world}" / f"linear_rank{r}.npz"))
           for r in range(world)]
    blocks_equal = all(
        np.array_equal(np.concatenate([g[k] for g in got]), v)
        for k, v in ref.items() if k.startswith("param."))
    hist_equal = all(np.array_equal(g[k], v) for g in got
                     for k, v in ref.items() if k.startswith("hist."))
    res = {"world": world, "models": int(X.shape[0]),
           "models_per_rank": [r["models"] for r in ranks],
           "devices": [r["device"] for r in ranks],
           "fit_s_per_rank": [r["fit_s"] for r in ranks],
           "unsharded_fit_s": ref_s, "blocks_equal": blocks_equal,
           "history_equal": hist_equal}
    res["failures"] = [msg for bad, msg in (
        (not blocks_equal, "the ranks' blocks are not the unsharded maps"),
        (not hist_equal, "a rank's history is not the unsharded one"),
        (sum(res["models_per_rank"]) != res["models"],
         "the blocks do not cover the models"),
    ) if bad]
    out["mesh_linear_fit"] = res

    # the default configuration's stage 1 in pallas mode
    ranks = readings["mesh_default_pallas"]
    world = len(ranks)
    dyn = artifact_diff(cfg_d, cfg_e, "dynamics_h5",
                        cfg_d.partition.n_parts)
    k1 = [r["stage1_launches"]["batched_fint_matvec"] for r in ranks]
    other = [{k: v for k, v in r["stage1_launches"].items()
              if v and k != "batched_fint_matvec"} for r in ranks]
    ev = stage_events(cfg_d)
    res = {
        "world": world, "backend": ranks[0]["backend"], "steps":
        MESH_K1_STEPS, "parts_per_rank": [len(r["parts"]) for r in ranks],
        "setup_s_per_rank": [r["setup_s"] for r in ranks],
        "stage1_s_per_rank": [r["stage1_s"] for r in ranks],
        "emulated_stage1_s": emulated_s,
        "emulated_fint_matvec_launches": emulated_k1,
        "stage1_solve_s_per_rank": ev["stage1_solve"]["rank_seconds"],
        "stage1_steps_per_s": ev["stage1_solve"]["steps_per_sec"],
        "emulated_stage1_steps_per_s": stage_events(cfg_e)[
            "stage1_solve"]["steps_per_sec"],
        "spawn_wall_s": walls[world],
        "fint_matvec_launches_per_rank": k1,
        "dynamics_equal": dyn[0], "dynamics_max_rel": dyn[1],
        "dynamics_max_abs": dyn[2], "tol": MESH_TOL["float64"],
    }
    res["failures"] = [msg for bad, msg in (
        (any(n != MESH_K1_STEPS for n in k1),
         f"K1 launched {k1} times on the ranks, not once a step "
         f"({MESH_K1_STEPS})"),
        (any(other), f"another kernel launched: {other}"),
        (world == 1 and not dyn[0], "one rank: not the emulated run's bits"),
        (not dyn[1] <= MESH_TOL["float64"],
         f"the mesh departs from the emulated run: {dyn[1]:.3e}"),
    ) if bad]
    out["mesh_default_pallas_stage1"] = res
    shutil.rmtree(root / "mesh_slice", ignore_errors=True)
    return out


def run_stages(cfg, dev, first: int = 1):
    """The five stages (from stage ``first``) through api.Simulation,
    timed one by one."""
    import torch

    from savtpu_torch import api

    sim = api.Simulation(cfg, device=dev, verbose=False)
    times = {}
    stages = (("stage1_s", sim.generate_data),
              ("stage2_s", sim.extract_shared),
              ("stage3_s", sim.train),
              ("stage4_s", sim.run_online),
              ("stage5_s", sim.compare))
    for name, fn in stages[first - 1 :]:
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
    ap.add_argument("--lstm-steps", type=int, default=LSTM_STEPS,
                    help="the default-config (LSTM) run's depth in steps "
                         "in phase 3; 100000 is the published depth")
    ap.add_argument("--lstm-epochs", type=int, default=LSTM_EPOCHS,
                    help="training epochs of the default-config (LSTM) "
                         "run in phase 3; 3450 is the published depth")
    ap.add_argument("--nh-steps", type=int, default=NH_STEPS,
                    help="nh_box_96's depth in steps (expfit and hybrid); "
                         "100000 is the published depth")
    ap.add_argument("--surrogate-epochs", type=int,
                    default=SURROGATE_EPOCHS,
                    help="training epochs of the hybrids' residual LSTMs "
                         "(nh_box_96, tube_hybrid)")
    ap.add_argument("--leg-epochs", type=int, default=LEG_EPOCHS,
                    help="training epochs of the default run's ensemble "
                         "and per-rank legs")
    ap.add_argument("--tube-steps", type=int, default=TUBE_STEPS,
                    help="tube_hybrid's depth in steps; 100000 is the "
                         "published depth")
    ap.add_argument("--pcg-big", action="store_true",
                    help="also solve the 192x12x12 beam's steady state "
                         "(97,851 DOFs) by PCG and by SciPy's direct "
                         "solver, timed (phase 2 steady_pcg_192x12x12)")
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
    from savtpu_torch.utils.roofline import device_peaks

    peaks = device_peaks(dev)
    if peaks is None:
        print(f"chip_smoke: no peaks for {kind!r} in utils/roofline.py",
              file=sys.stderr)
        return 2
    global PEAK_BYTES, PEAK_F32
    PEAK_BYTES = peaks["hbm_GBps"] * 1e9
    PEAK_F32 = peaks["fp32_tflops"] * 1e12
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    clock.phase(0, "device", kind=kind, count=count, nvidia_smi=smi,
                torch=torch.__version__, cuda=torch.version.cuda,
                peaks=peaks)

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
        S3_slice = int(sp.sld.shape[1])
        shapes = dict(P=P, nc=nc, Bk=Bk, S3=S3_slice, Tc=Tc,
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
        # what a rank of a four-card mesh computes for its 4 of the 16
        # parts, against those parts in the one-card batch (ROADMAP C1)
        clock.phase(2, "online_banded_block_of_4_vs_16", **check_block_split(
            sp, args, kw, n_sm, tables["online_banded"]))
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

        # the .msh round trip and the native partition route; then K3 at
        # irregular_96's band (an RCM band of the irregular Delaunay beam
        # in 16 graph parts), as band_plan plans it
        mesh_io, irr_msh = check_mesh_io_and_route(tmp / "meshes")
        clock.phase(2, "mesh_io_and_partition_route", **mesh_io)
        if mesh_io["failures"]:
            raise RuntimeError(f"mesh IO: {mesh_io['failures']}")
        irr_sp = build_context(irregular_config(tmp / "k3_irr", irr_msh),
                               device=dev).sp
        args_i, kw_i = k3_inputs(irr_sp, dev, Tc, SEED)
        Pi, nci, Bki, _ = irr_sp.band_Kd.shape
        shapes_i = dict(P=Pi, nc=nci, Bk=Bki, S3=int(irr_sp.sld.shape[1]),
                        Tc=Tc, save_every=SAVE_EVERY, dtype="float32")
        k3_plan_i = band_plan(Pi, nci, Bki, torch.float32, n_sm,
                              tables["online_banded"])
        k3_irr = check_online_block(args_i, kw_i)
        torch.cuda.synchronize()
        clock.phase(2, "online_banded_irregular_96_vs_plain",
                    shapes=shapes_i, **k3_irr)
        if k3_irr["failures"]:
            raise RuntimeError(f"online_banded at irregular_96: "
                               f"{k3_irr['failures']}")
        del irr_sp

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

        # the surrogate slice: the hybrid's block, the ridge map, a seed
        # ensemble, per-rank epochs with mixed teacher forcing and dropout
        surrogates = check_surrogates(S3, S3_slice, dev)
        torch.cuda.synchronize()
        clock.phase(2, "surrogates_vs_cpu", S3=S3, S3_slice=S3_slice,
                    **surrogates)
        if surrogates["failures"]:
            raise RuntimeError(f"surrogates: {surrogates['failures']}")

        # the structured-box slice's forces and exchange (float64)
        for name, check in (("nh_stencil_vs_cpu", check_nh_stencil_vs_cpu),
                            ("grid_vs_psum", check_grid_vs_psum),
                            ("lin_stencil_vs_dense",
                             check_lin_stencil_vs_dense)):
            res = check(dev)
            torch.cuda.synchronize()
            clock.phase(2, name, **res)
            if res["failures"]:
                raise RuntimeError(f"{name}: {res['failures']}")

        # the unstructured slice's forces and exchange (float64): the
        # windowed Neo-Hookean layout, the tube's stencils, its seam
        from savtpu_torch.mesh import tube_mesh

        irr = mesh_setup(irregular_mesh(), 16, "graph")
        big = mesh_setup(tube_mesh(*TUBE_BIG), 64, "box", axis=2)
        for name, check in (("nh_window_vs_cpu",
                             lambda: check_nh_window_vs_cpu(dev, irr)),
                            ("tube_stencil_vs_reference",
                             lambda: check_tube_stencil(dev, big))):
            res = check()
            torch.cuda.synchronize()
            clock.phase(2, name, **res)
            if res["failures"]:
                raise RuntimeError(f"{name}: {res['failures']}")
        res, tube_grid_sp = check_tube_grid_vs_psum(dev, big)
        clock.phase(2, "tube_grid_vs_psum", **res)
        if res["failures"]:
            raise RuntimeError(f"tube_grid_vs_psum: {res['failures']}")
        del big

        # the solver-options slice: the ell and ebe forces, the permute
        # exchange, the blend, their graph replays, the ghost step
        for name, check in (("ell_ebe_vs_dense", check_ell_ebe_vs_dense),
                            ("permute_vs_psum", check_permute_vs_psum),
                            ("permute_vs_psum_96x8x8_p64",
                             lambda d: check_permute_vs_psum(
                                 d, (96, 8, 8), 64, min_owners=3)),
                            ("blend_endpoints", check_blend),
                            ("options_graph_replays", check_options_graphs),
                            ("ghost_step_vs_cpu", check_ghost_vs_cpu)):
            res = check(dev)
            torch.cuda.synchronize()
            clock.phase(2, name, **res)
            if res["failures"]:
                raise RuntimeError(f"{name}: {res['failures']}")

        # the serial-solver and steady slice: the serial runner against
        # the exchanged runs (linear, Neo-Hookean), the steady routes
        checks_s = [("serial_explicit_vs_sharded", check_serial_vs_sharded),
                    ("serial_nh_vs_sharded", check_serial_nh_vs_sharded),
                    ("steady_routes", check_steady_routes)]
        if opts.pcg_big:
            checks_s.append(("steady_pcg_192x12x12", check_steady_big))
        for name, check in checks_s:
            res = check(dev)
            torch.cuda.synchronize()
            clock.phase(2, name, **res)
            if res["failures"]:
                raise RuntimeError(f"{name}: {res['failures']}")

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

        # the slice's stage 4 again with a resync block, then the
        # checkpointed stages 1 and 4 killed and resumed, then the
        # unramped default beam
        resync_cfg, resync = run_slice_resync(tmp, dev, steps, opts.dtype,
                                              commfree)
        clock.phase(3, "slice_resync", **resync)
        if resync["failures"]:
            raise RuntimeError(f"slice_resync: {resync['failures']}")
        zero_kernel_launches()
        ckpt = run_checkpoint_resume(tmp / "ckpt", dev, resync_cfg, steps,
                                     opts.dtype)
        ckpt["k1_k4_launches"] = linear_kernel_launches()
        clock.phase(3, "checkpoint_resume", **ckpt)
        if ckpt["failures"]:
            raise RuntimeError(f"checkpoint_resume: {ckpt['failures']}")
        zero_kernel_launches()
        unramped = run_unramped_beam(tmp / "unramped", dev)
        unramped["k1_k4_launches"] = linear_kernel_launches()
        clock.phase(3, "unramped_beam", **unramped)
        if unramped["failures"]:
            raise RuntimeError(f"unramped_beam: {unramped['failures']}")
        if any(unramped["k1_k4_launches"].values()):
            raise RuntimeError("unramped_beam launched a linear kernel")
        # the steady-only P2 path through the stage-1 command line
        zero_kernel_launches()
        p2 = run_p2_steady(tmp / "p2", dev)
        p2["k1_k4_launches"] = linear_kernel_launches()
        clock.phase(3, "p2_steady", **p2)
        if p2["failures"]:
            raise RuntimeError(f"p2_steady: {p2['failures']}")

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
        # the sweep's ell and permute cases (K4 on the banded one)
        opt_rows, opt_totals = run_options_sweep(dev)
        for row in opt_rows:
            clock.phase(3, f"sweep_{row['mesh']}_p{row['n_parts']}_"
                        f"{row['fint_mode']}_{row['exchange_mode']}", **row)
        from savtpu_torch.benchmarks.sweep import KERNELS

        options_launches = {
            "sweep_options": {fn.__name__: opt_totals[k]
                              for k, fn in KERNELS.items()},
            "slice_resync": resync["k1_k4_launches"],
            "checkpoint_resume": ckpt["k1_k4_launches"],
            "unramped_beam": unramped["k1_k4_launches"]}

        # the headline bench (K2 in its pallas leg) and train_bench
        (tmp / "bench").mkdir()
        bench_res, bench_line, bench_launches = run_bench_path(tmp / "bench")
        print(bench_line, flush=True)
        for name, res in bench_res.items():
            clock.phase(3, name, **res)
        failures = {n: r["failures"] for n, r in bench_res.items()
                    if r["failures"]}
        if failures:
            raise RuntimeError(f"bench paths: {failures}")

        # the unstructured slice: irregular_96 from its binary .msh (K3
        # in stage 4), tube_hybrid from an ASCII .msh
        irr_path, irr_sp96 = run_irregular_path(tmp, dev, irr_msh, steps)
        clock.phase(3, "irregular_96", **irr_path)
        if irr_path["failures"]:
            raise RuntimeError(f"irregular_96: {irr_path['failures']}")
        tube_path = run_tube_path(tmp, dev, opts.tube_steps,
                                  opts.surrogate_epochs)
        clock.phase(3, "tube_hybrid", **tube_path)
        if tube_path["failures"]:
            raise RuntimeError(f"tube_hybrid: {tube_path['failures']}")
        unstructured_launches = {"irregular_96": irr_path["k1_k4_launches"],
                                 "tube_hybrid": tube_path["k1_k4_launches"]}

        # nh_box_96 through the stages (expfit), stages 3-5 again with
        # the hybrid, then the sweep's Neo-Hookean row
        nh_path, nh_hybrid, nh_sp = run_nh_box_path(
            tmp, dev, opts.nh_steps)
        clock.phase(3, "nh_box_96", **nh_path)
        clock.phase(3, "nh_box_96_hybrid",
                    surrogate_epochs=opts.surrogate_epochs, **nh_hybrid)
        for name, res in (("nh_box_96", nh_path),
                          ("nh_box_96_hybrid", nh_hybrid)):
            if res["failures"]:
                raise RuntimeError(f"{name}: {res['failures']}")

        # the default Config(): the LSTM-fed run at --lstm-steps steps,
        # the training cut to --lstm-epochs epochs; then its stage 4 on
        # K1; then the linear, ensemble and per-rank legs on its artifacts
        lstm_path, legs, grid = run_lstm_path(
            tmp / "lstm", dev, opts.lstm_epochs, opts.leg_epochs,
            opts.lstm_steps)
        clock.phase(3, "lstm_default_config", **lstm_path)
        if lstm_path["failures"]:
            raise RuntimeError(f"LSTM path: {lstm_path['failures']}")
        for name, res in legs.items():
            clock.phase(3, f"default_config_{name}", **res)
        failures = {n: r["failures"] for n, r in legs.items()
                    if r["failures"]}
        if failures:
            raise RuntimeError(f"default-config legs: {failures}")
        clock.phase(3, "stage3_grid", **grid)
        if grid["failures"]:
            raise RuntimeError(f"stage3_grid: {grid['failures']}")
        surrogate_launches = {
            "nh_box_96": nh_path["k1_k4_launches"],
            "nh_box_96_hybrid": nh_hybrid["k1_k4_launches"],
            **{f"default_config_{n}": r["k1_k4_launches"]
               for n, r in legs.items()}}

        # the device mesh: the slice's stages 1 and 4 (K3 on every rank)
        # and the default configuration's stage 1 in pallas mode (K1 on
        # every rank) over NCCL ranks, one a card
        mesh_paths = run_mesh_path(tmp, dev, steps, opts.dtype, times)
        for name, res in mesh_paths.items():
            clock.phase(3, name, **res)
        failures = {n: r["failures"] for n, r in mesh_paths.items()
                    if r["failures"]}
        if failures:
            raise RuntimeError(f"mesh paths: {failures}")

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
        # and at irregular_96's band
        bound_i, bound_by_i, nbytes_i, flops_i = k3_bound(args_i, Tc,
                                                          SAVE_EVERY)
        kern_i, plain_i, plain_runs_i = in_turns(
            lambda: online_chunk_plain(*args_i, **kw_i),
            lambda: online_chunk(*args_i, **kw_i), 1, 5)
        k3_irr_timing = {
            "ms": kern_i, "plain_ms": plain_i, "plain_ms_runs": plain_runs_i,
            "bound_ms": bound_i, "bound_by": bound_by_i, "bytes": nbytes_i,
            "flops": flops_i,
            "bound_band_reread_ms": band_reread_ms(args_i[0], Tc),
            "plan": vars(k3_plan_i), "shapes": shapes_i,
            "launches": irr_path["k1_k4_launches"]["online_chunk"],
            "max_abs_err": k3_irr["max_abs_err"]}
        clock.phase(4, "online_banded_irregular_96_timing", **k3_irr_timing)
        del args_i
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
        clock.phase(4, "nh_stepper_profile", nh_box_96={
            "exchanged": stepper_profile(nh_sp, dev, steps=300),
            "comm_free": stepper_profile(nh_sp, dev, steps=300, sync=False,
                                         save_every=SAVE_EVERY)})
        del nh_sp
        clock.phase(4, "irregular_96_stepper_profile",
                    exchanged=stepper_profile(irr_sp96, dev, steps=300))
        del irr_sp96
        clock.phase(4, "tube_stepper_profile", tube_4x48x256_p64={
            "exchanged": stepper_profile(tube_grid_sp, dev, steps=300)})
        del tube_grid_sp
        clock.phase(4, "nh_window_stepper_profile",
                    irregular_96x8x8_p16=window_profiles(dev, irr))
        del irr
        clock.phase(4, "lstm_epoch_timing", **lstm_timing(S3, dev))
        res = check_roofline_profile_offload(
            ctx.sp, sweep_rows, [sweep_sp[k] for k in SWEEP_PATH], dev,
            tmp, steps // SAVE_EVERY, k3=(kern, Tc, k3_plan))
        clock.phase(4, "roofline_profile_offload", **res)
        if res["failures"]:
            raise RuntimeError(f"roofline_profile_offload: "
                               f"{res['failures']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def on_surrogate_paths(fn_name):
        return {path: counts[fn_name]
                for path, counts in surrogate_launches.items()}

    def on_unstructured_paths(fn_name):
        return {path: counts[fn_name]
                for path, counts in unstructured_launches.items()}

    def on_options_paths(fn_name):
        return {path: counts.get(fn_name, 0)
                for path, counts in options_launches.items()}

    print(json.dumps({"kernels": [{
        "name": "online_banded",
        "route": "cuda",
        "source": "savtpu_torch/csrc/online_banded.cu",
        "replaces": "savtpu/ops/pallas_banded.py:234",
        "launches": launches,
        "launches_bench": bench_launches["online_chunk"],
        "launches_surrogate_paths": on_surrogate_paths("online_chunk"),
        "launches_unstructured_paths": on_unstructured_paths("online_chunk"),
        "launches_options_paths": on_options_paths("online_chunk"),
        "launches_mesh_paths": {"mesh_slice_per_rank": mesh_paths[
            "mesh_slice_96x8x8_p16"]["online_banded_launches_per_rank"]},
        "irregular_96": {k: k3_irr_timing[k] for k in (
            "ms", "plain_ms", "plain_ms_runs", "launches", "max_abs_err",
            "bound_ms", "bound_by")},
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
        "launches_bench": bench_launches[
            "batched_fint_matvec" if name == "fint_matvec" else name],
        "max_abs_err": checks[f"{name}_{tag}"]["max_abs_err"],
        "ms": timing[f"{name}_{tag}"]["ms"],
        "plain_ms": timing[f"{name}_{tag}"]["plain_ms"],
        "bound_ms": timing[f"{name}_{tag}"]["bound_ms"],
        "bound_by": timing[f"{name}_{tag}"]["bound_by"],
        "library_ms": timing[f"{name}_{tag}"].get("library_ms"),
        **({"launches_lstm_stage4_pallas": lstm_path["k1_leg_launches"],
            "launches_mesh_paths": {
                "mesh_default_pallas_stage1_per_rank": mesh_paths[
                    "mesh_default_pallas_stage1"][
                    "fint_matvec_launches_per_rank"]}}
           if name == "fint_matvec" else {}),
        "launches_surrogate_paths": on_surrogate_paths(
            "batched_fint_matvec" if name == "fint_matvec" else name),
        "launches_unstructured_paths": on_unstructured_paths(
            "batched_fint_matvec" if name == "fint_matvec" else name),
        "launches_options_paths": on_options_paths(
            "batched_fint_matvec" if name == "fint_matvec" else name),
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
