"""The comm-free online block on the banded layout: compensated state,
per-step prediction overwrite and recording, for all parts at once.

Replaces ``savtpu/ops/pallas_banded.py:234`` (``_online_kernel``, called
through ``pallas_online_chunk``), the production stage-4 kernel of the
sync-avoiding run. Per step and part:

- translation-mean centering: x = hi - mean_c(hi) on the real DOFs of
  each component c,
- block-tridiagonal matvec y_c = Kd_c x_c + Kl_c x_{c-1} + Kl_{c+1}^T
  x_{c+1},
- increment delta = (c1 v + c2 (F ramp(t) - y) / M) bc, replaced at the
  valid shared slots by pred - (hi + lo),
- TwoSum of (hi, delta) and renormalisation into (hi, lo); v = delta,
- hi recorded every ``save_every``-th step and the shared rows every
  step.

Three pieces, as for every kernel of the port:

- ``online_chunk_plain``: the plain PyTorch version, with the op order of
  the compensated branch of ``ShardedProblem.stacked_run``. The CPU path
  and the tests use it.
- ``csrc/online_banded.cu``: the CUDA kernel. One part runs on a thread
  block cluster of B blocks (``ops/band_plan.py`` picks B: 6 at the
  16-part slice on an H100), each block walking all steps for its own
  range of rows, with hi, lo, v and the per-DOF coefficients of its rows
  in shared memory. The band matvec's transposed-term shares, the new hi
  and the partial sums of the translation mean cross blocks through
  distributed shared memory, two cluster barriers a step; every block
  adds the partials in the same order, so all use the same mean. The
  shared-slot overwrite and gather are direct indexed accesses through a
  slot map built from ``sld``: the TPU needed one-hot matmuls only
  because arbitrary-index gathers do not vectorise there, and those are
  exact, so the values are the same. It is compiled with
  ``-fmad=false``: the update and the compensation round exactly like
  the plain version. Only the order of the sums inside the band matvec
  and the translation mean differs.
- ``online_chunk``: the wrapper. A tensor on the CPU takes the plain
  version; a CUDA tensor launches the kernel or raises.
  ``online_chunk.launches`` counts the kernel launches.

What bounds the kernel on an H100: the band, read every step. One part's
Kd and Kl are 2 nc Bk^2 values (3.7 MB at nc=7, Bk=256, float32), far
above the 227 KB a block may hold; all parts' band (58.7 MB) is just over
the 50 MB L2. With one block per part only P of the 132 SMs pulled it (16
at the slice), Kl twice a step; over a cluster of 6 blocks each block
keeps most of its Kd rows in shared memory and streams the rest and its
Kl rows once, about 36 MB a step over 96 SMs.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .band_plan import (
    band_plan,
    check_band_operands,
    check_band_plan,
    cluster_table,
)
from .dense_step import sm_count
from .material import linear_ramp


def band_matvec(Kd: torch.Tensor, Kl: torch.Tensor, x: torch.Tensor):
    """y = K x for block-tridiagonal K: (P, nc, Bk, Bk) diagonal blocks
    Kd, sub-diagonal blocks Kl (super-diagonal = Kl[c+1]^T by symmetry),
    x (P, nc*Bk) -> y (P, nc*Bk)."""
    P = x.shape[0]
    _, nc, Bk, _ = Kd.shape
    xc = x.reshape(P, nc, Bk, 1)
    y = torch.matmul(Kd, xc)
    if nc > 1:
        y[:, 1:] = y[:, 1:] + torch.matmul(Kl[:, 1:], xc[:, :-1])
        y[:, :-1] = y[:, :-1] + torch.matmul(
            Kl[:, 1:].transpose(-1, -2), xc[:, 1:]
        )
    return y.reshape(P, nc * Bk)


def _coeffs(dt: float, alpha: float):
    beta = 0.5 * float(alpha) * float(dt)
    return (1.0 - beta) / (1.0 + beta), float(dt) ** 2 / (1.0 + beta)


def online_chunk_plain(Kd, Kl, hi, lo, v, Fp, lM, bc, dm, sld, smask,
                       preds, *, t0, i0, dt, alpha, ramped, save_every):
    """Plain PyTorch version of the online block.

    Layout (DLB = nc*Bk): hi, lo, v (P, DLB) state; Fp, lM, bc, dm
    (P, DLB) force, lumped mass, Dirichlet mask and real-DOF mask; sld
    (P, S3) shared local DOF ids with smask (P, S3) 1 on valid slots;
    preds (P, Tc, S3). Step k runs at t = t0 + dt*(i0 + k). Returns
    (hi, lo, v, shared (P, Tc, S3), traj (P, Tc//save_every, DLB))."""
    P, DLB = hi.shape
    Tc = preds.shape[1]
    dtype, dev = hi.dtype, hi.device
    c1v, c2v = _coeffs(dt, alpha)
    c1 = torch.tensor(c1v, dtype=dtype, device=dev)
    c2 = torch.tensor(c2v, dtype=dtype, device=dev)
    dtc = torch.tensor(dt, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    t0 = torch.as_tensor(t0, dtype=dtype).to(dev)
    i = torch.tensor(float(i0), dtype=dtype, device=dev)
    # valid shared slots address the state; padded ones an appended zero
    idx = torch.where(smask > 0, sld, torch.full_like(sld, DLB))
    pad = torch.zeros((P, 1), dtype=dtype, device=dev)
    comp = torch.arange(DLB, device=dev) % 3
    csel = torch.stack([(comp == c).to(dtype) for c in range(3)]) * dm[:, None, :]
    counts = torch.clamp(csel.sum(dim=2), min=1.0)  # (P, 3)
    shared, traj = [], []
    for k in range(Tc):
        mean = (csel * hi[:, None, :]).sum(dim=2) / counts
        tbar = (mean[:, :, None] * csel).sum(dim=1)
        f = band_matvec(Kd, Kl, hi - tbar)
        tn = t0 + dtc * i
        ramp = linear_ramp(tn) if ramped else one
        delta = (c1 * v + c2 * ((Fp * ramp - f) / lM)) * bc
        # overwrite: the increment at a shared slot is pred - (hi + lo)
        cur = (torch.gather(torch.cat([hi, pad], 1), 1, idx)
               + torch.gather(torch.cat([lo, pad], 1), 1, idx))
        tgt = (preds[:, k, :] - cur) * smask
        delta = torch.cat([delta, pad], 1).scatter(1, idx, tgt)[:, :DLB]
        s = hi + delta
        z = s - hi
        e = (hi - (s - z)) + (delta - z)
        lo1 = lo + e
        hi = s + lo1
        lo = lo1 - (hi - s)
        v = delta
        i = i + one
        if k % save_every == 0:
            traj.append(hi)
        shared.append(torch.gather(torch.cat([hi, pad], 1), 1, idx) * smask)
    return hi, lo, v, torch.stack(shared, dim=1), torch.stack(traj, dim=1)


# Kernel against plain version, each output on its scale (chip_smoke.py
# phase 2, the gpu test leg). With the band zeroed no result depends on a
# sum order and the kernel must equal the plain version bit for bit: that
# holds the rounding of the update and the compensation. With the band
# the two sum the matvec in different orders, so the compensated state
# hi + lo, v and the recordings drift apart at round-off level, by at
# most RTOL. The float32 limit is five times the kernel's reading at the
# 16-part slice's shapes (6.0e-6 on an H100). A control that drops the
# compensation drifts as far (8.0e-6), so the bit-for-bit check is the
# one that holds the compensation (PERF.md). lo alone is not held with
# the band: once hi differs by an ulp, lo holds different bits.
RTOL = {torch.float32: 3e-5, torch.float64: 1e-12}


def block_distance(out_a, out_b) -> dict:
    """Max abs and scaled differences of two online-block results (hi,
    lo, v, shared, traj) and of their compensated states hi + lo, summed
    in float64. hi, lo and the state are scaled by b's state, the others
    by their own size in b."""
    names = ("hi", "lo", "v", "shared", "traj")
    a = dict(zip(names, out_a))
    b = dict(zip(names, out_b))
    a["state"] = a["hi"].double() + a["lo"].double()
    b["state"] = b["hi"].double() + b["lo"].double()
    state_scale = float(b["state"].abs().max())
    out = {}
    for name in (*names, "state"):
        err = float((a[name].double() - b[name].double()).abs().max())
        scale = (state_scale if name in ("hi", "lo", "state")
                 else float(b[name].abs().max()))
        out[name] = {"max_abs": err, "max_rel": err / max(scale, 1e-30)}
    return out


# 16 tensor pointers and the stream, 10 ints, 5 doubles (csrc signature)
_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [
    ctypes.c_double] * 5


def online_chunk(Kd, Kl, hi, lo, v, Fp, lM, bc, dm, sld, smask, preds, *,
                 t0, i0, dt, alpha, ramped, save_every, plan=None):
    """The online block for all parts (arguments and results as in
    :func:`online_chunk_plain`). CPU tensors run the plain version; CUDA
    tensors launch the kernel of ``csrc/online_banded.cu`` as
    ``band_plan.band_plan`` plans it. ``plan`` (a ``BandPlan``, from
    ``band_plan.forced_band_plan``) overrides the plan, so that the checks
    can run every launch shape; it is refused for a shape it does not fit
    and on a CPU tensor. The solver never passes it."""
    P, nc, Bk, _ = Kd.shape
    if plan is not None:
        check_band_plan("online_chunk", plan, nc, Bk, hi.dtype)
    if hi.device.type == "cpu":
        if plan is not None:
            raise ValueError("online_chunk: plan= sets the CUDA kernel's "
                             "launch; a CPU tensor runs the plain version")
        return online_chunk_plain(
            Kd, Kl, hi, lo, v, Fp, lM, bc, dm, sld, smask, preds,
            t0=t0, i0=i0, dt=dt, alpha=alpha, ramped=ramped,
            save_every=save_every,
        )
    if hi.device.type != "cuda":
        raise ValueError(f"online_chunk: unsupported device {hi.device}")
    dtype, dev = hi.dtype, hi.device
    sfx = kernels.suffix(dtype)
    DLB = nc * Bk
    Tc, S3 = preds.shape[1], preds.shape[2]
    if Tc % save_every:
        raise ValueError("online_chunk: Tc must be a multiple of save_every")
    vecs = (hi, lo, v, Fp, lM, bc, dm)
    kernels.check_tensors(
        "online_chunk", dev, dtype,
        [("Kd", Kd, (P, nc, Bk, Bk)), ("Kl", Kl, (P, nc, Bk, Bk)),
         ("preds", preds, (P, Tc, S3)), ("smask", smask, (P, S3))]
        + [(f"vec{j}", t, (P, DLB)) for j, t in enumerate(vecs)])
    check_band_operands("online_chunk", Kd, Kl)
    if sld.shape != (P, S3) or sld.device != dev:
        raise ValueError("online_chunk: sld must be (P, S3) on the device")
    if plan is None:
        plan = band_plan(P, nc, Bk, dtype, sm_count(dev),
                         cluster_table("online_banded", dtype, dev))
    slot = kernels.slot_map(sld, smask, DLB)

    outs = [torch.empty((P, DLB), dtype=dtype, device=dev) for _ in range(3)]
    shared = torch.zeros((P, Tc, S3), dtype=dtype, device=dev)
    traj = torch.empty((P, Tc // save_every, DLB), dtype=dtype, device=dev)
    fn = kernels.function("online_banded", f"savtpu_online_banded_{sfx}",
                          _ARGTYPES)
    c1, c2 = _coeffs(dt, alpha)
    ptrs = [t.data_ptr() for t in (Kd, Kl, *vecs, slot, preds, *outs,
                                   shared, traj)]
    err = fn(*ptrs, kernels.stream(dev), P, nc, Bk, S3, Tc, save_every,
             1 if ramped else 0, plan.blocks, plan.resident, plan.smem,
             float(t0), float(i0), float(dt), c1, c2)
    kernels.check("online_banded", err, "online_banded launch")
    online_chunk.launches += 1
    return outs[0], outs[1], outs[2], shared, traj


online_chunk.launches = 0
