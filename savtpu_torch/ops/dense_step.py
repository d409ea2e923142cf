"""The dense local-K step kernels, K1 and K2 (``fint_mode="pallas"``).

Counterpart of ``savtpu/ops/pallas_step.py``:

- K1, :func:`batched_fint_matvec`, replaces ``_matvec_kernel``
  (``pallas_step.py:59``): one step's F_int = K d for every part. The
  stepper calls it once per step (``ShardedProblem._fint_stacked``), in
  the exchanged and the generic comm-free runs; on the card those steps
  replay from CUDA graphs (``parallel/sharded.py``).
- K2, :func:`scan_comm_free`, replaces ``_scan_kernel``
  (``pallas_step.py:97``): the whole comm-free scan, uncompensated, with
  optional prediction overwrite of the shared slots and per-step
  recording of the shared rows. ``ShardedSolver.run`` sends a comm-free
  run to it when its gate allows. :func:`scan_plan` picks its launch: one
  block per part with K in shared memory where a part's K fits there,
  else the rows of each part split over several blocks, K resident in
  their shared memory where the rows fit, streamed every step otherwise.

Three pieces each, as for every kernel of the port: the plain PyTorch
version (``*_plain``), which the CPU path and the tests use; the CUDA
kernel in ``csrc/dense_step.cu`` (design and bounds are described there);
and the wrapper, which takes the plain version for a CPU tensor and
launches the kernel, or raises, for a CUDA tensor. ``<wrapper>.launches``
counts the kernel launches.

Rounding: K2's plain version follows the kernel, which follows the TPU
kernel: t = t0 + i dt, and the coefficients formed from t0, dt, alpha
already cast to the state dtype. The generic stepper accumulates t += dt
and forms dt^2 in double, so the two differ at round-off in float32 and
agree in float64. The shared-slot overwrite and recording use indices
where the TPU used one-hot matmuls; those were exact, so the values are
the same.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import kernels

# Kernel against plain version, on the scale of the plain result
# (max |a - b| / max |b|, chip_smoke.py phase 2 and the gpu test legs). The
# kernel sums each row in another order than the plain version; K2 carries
# that difference through its steps. Each float32 limit sits between the
# kernel's reading on an H100 80GB HBM3 and a control that the same
# comparison must reject (PERF.md). K1 at the sweep's shapes: 1.5e-7, and
# 2.7e-4 for the product on TF32-rounded inputs. K2: 9.4e-5 after 1,000
# steps at DL 526, and 11.7 for the plain version with the overwrite
# dropped. With K zeroed K2 must equal its plain version bit for bit.
MATVEC_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SCAN_RTOL = {torch.float32: 1e-3, torch.float64: 1e-12}


def batched_fint_matvec_plain(K: torch.Tensor, d: torch.Tensor):
    """(P, DL, DL) K and (P, DL) d -> (P, DL) K d, as the sum of each
    row's products."""
    return (K * d[:, None, :]).sum(dim=2)


def step_scalars(t0, dt, alpha, dtype, device):
    """t0 and dt, and the step's coefficients dt^2, 0.5 dt alpha and
    0.5 alpha dt, formed from t0, dt and alpha cast to ``dtype``."""
    t0c = torch.as_tensor(t0, dtype=dtype).to(device)
    dtc = torch.tensor(dt, dtype=dtype, device=device)
    alc = torch.tensor(alpha, dtype=dtype, device=device)
    return t0c, dtc, dtc * dtc, (0.5 * dtc) * alc, (0.5 * alc) * dtc


def ramp_at(t0c, dtc, i: int, ramped: bool):
    """The load ramp min(t, 1) at t = t0 + i dt (1 when unramped)."""
    if not ramped:
        return torch.ones((), dtype=dtc.dtype, device=dtc.device)
    i_t = torch.tensor(float(i), dtype=dtc.dtype, device=dtc.device)
    return torch.clamp(t0c + i_t * dtc, max=1.0)


def central_difference_plain(f, d0, dn, Fp, lM, bc, ramp, dt2, hda, had):
    """One central-difference step with mass-proportional damping, in the
    TPU kernels' evaluation order (``csrc/common.cuh``)."""
    num = ((dt2 * (Fp * ramp - f) + (2.0 * lM) * d0) - lM * dn
           + (hda * lM) * dn)
    return (num / (lM + had * lM)) * bc


def scan_comm_free_plain(K, d0, dn, t0, F_pre, lM, bc, sld, smask, preds,
                         *, num_steps, dt, alpha, ramped, record_shared):
    """Plain PyTorch version of the whole comm-free scan.

    K (P, DL, DL); d0, dn, F_pre, lM, bc (P, DL); sld (P, S3) shared local
    DOF ids with smask (P, S3) 1 on valid slots; preds (P, >= num_steps,
    S3) or None. Step i runs at t = t0 + i dt; with preds, each step's d1
    at the valid shared slots is replaced by the step's row. Returns
    (d0, dn, t_final, shared (P, num_steps, S3) or None)."""
    P, DL = d0.shape
    dev = d0.device
    t0c, dtc, dt2, hda, had = step_scalars(t0, dt, alpha, d0.dtype, dev)
    # valid shared slots address the state; padded ones an appended column
    idx = torch.where(smask > 0, sld, torch.full_like(sld, DL))
    pad = d0.new_zeros((P, 1))
    shared = []
    for i in range(num_steps):
        f = batched_fint_matvec_plain(K, d0)
        ramp = ramp_at(t0c, dtc, i, ramped)
        d1 = central_difference_plain(f, d0, dn, F_pre, lM, bc, ramp, dt2,
                                      hda, had)
        if preds is not None:
            d1 = torch.cat([d1, pad], 1).scatter(1, idx, preds[:, i, :])
            d1 = d1[:, :DL]
        if record_shared:
            shared.append(torch.cat([d1, pad], 1).gather(1, idx))
        d0, dn = d1, d0
    t_final = t0c + num_steps * dtc
    return d0, dn, t_final, (torch.stack(shared, 1) if record_shared
                             else None)


def scan_fits(DL: int, dtype) -> bool:
    """Whether K2's per-part state (six (DL,) vectors and the slot map)
    fits in one block's shared memory: the gate's size rule."""
    smem = _one_block_smem(DL, _itemsize(dtype), False)
    return smem <= kernels.SMEM_PER_BLOCK


@dataclass(frozen=True)
class ScanPlan:
    """How K2 is launched: ``blocks`` blocks per part, each owning
    ``rows`` consecutive rows (the last may own fewer), with K kept in
    shared memory (``resident``) or streamed every step, and ``smem``
    bytes of dynamic shared memory per block."""

    blocks: int
    rows: int
    resident: bool
    smem: int


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _one_block_smem(DL, it, resident) -> int:
    # d0, dn, y, Fp, lM, bc, the slot map, and K if resident
    return 6 * DL * it + 4 * DL + (DL * DL * it if resident else 0)


def _split_smem(DL, rows, it, resident) -> int:
    # K's rows (pitch padded to 16 bytes) if resident, the part's d (same
    # padding); y, dn, Fp, lM, bc and the slot map of the block's rows
    DLp = -(-DL * it // 16) * 16 // it
    return ((rows * DLp * it if resident else 0) + DLp * it
            + 5 * rows * it + 4 * rows)


def forced_plan(DL: int, dtype, blocks: int, resident: bool) -> ScanPlan:
    """The plan with ``blocks`` blocks per part (fewer if the rows run
    out first) and the given residency; :func:`scan_plan` picks among
    these."""
    it = _itemsize(dtype)
    if blocks == 1:
        return ScanPlan(1, DL, resident, _one_block_smem(DL, it, resident))
    rows = -(-DL // blocks)
    blocks = -(-DL // rows)
    return ScanPlan(blocks, rows, resident,
                    _split_smem(DL, rows, it, resident))


def scan_plan(P: int, DL: int, dtype, sm_count: int,
              smem_per_block: int = kernels.SMEM_PER_BLOCK) -> ScanPlan:
    """K2's launch for P parts of DL rows on a card with ``sm_count`` SMs:

    - one block per part with K in shared memory, where one part's K fits
      there beside the state;
    - else B = sm_count // P blocks per part (P B <= sm_count, one block
      per SM, all co-resident), K's rows kept in each block's shared
      memory where they fit, streamed every step where they do not;
    - one block per part, K streamed, where the parts leave no SM for a
      second block each (B < 2)."""
    one = forced_plan(DL, dtype, 1, True)
    if one.smem <= smem_per_block:
        return one
    B = sm_count // P
    if B < 2:
        return forced_plan(DL, dtype, 1, False)
    plan = forced_plan(DL, dtype, B, True)
    if plan.smem <= smem_per_block:
        return plan
    return forced_plan(DL, dtype, B, False)


def sm_count(device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def scaled_error(out_a, out_b) -> float:
    """Largest max |a - b| / max |b| over paired outputs (None pairs
    skipped), in float64."""
    worst = 0.0
    for a, b in zip(out_a, out_b):
        if a is None and b is None:
            continue
        a, b = a.double(), b.double()
        err = float((a - b).abs().max())
        worst = max(worst, err / max(float(b.abs().max()), 1e-30))
    return worst


# K, d, out and the stream; P, DL
_MATVEC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
# 13 tensor pointers and the stream; 11 ints; t0, dt, alpha
_SCAN_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 11
                  + [ctypes.c_double] * 3)


def batched_fint_matvec(K: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """F_int = K d for every part (arguments as in
    :func:`batched_fint_matvec_plain`). CPU tensors run the plain
    version; CUDA tensors launch K1 of ``csrc/dense_step.cu``."""
    if d.device.type == "cpu":
        return batched_fint_matvec_plain(K, d)
    if d.device.type != "cuda":
        raise ValueError(
            f"batched_fint_matvec: unsupported device {d.device}")
    sfx = kernels.suffix(d.dtype)
    P, DL = d.shape
    kernels.check_tensors("batched_fint_matvec", d.device, d.dtype,
                          [("K", K, (P, DL, DL)), ("d", d, (P, DL))])
    out = torch.empty_like(d)
    fn = kernels.function("dense_step", f"savtpu_fint_matvec_{sfx}",
                          _MATVEC_ARGTYPES)
    err = fn(K.data_ptr(), d.data_ptr(), out.data_ptr(),
             kernels.stream(d.device), P, DL)
    kernels.check("dense_step", err, "fint_matvec launch")
    batched_fint_matvec.launches += 1
    return out


batched_fint_matvec.launches = 0


def scan_comm_free(K, d0, dn, t0, F_pre, lM, bc, sld, smask, preds, *,
                   num_steps, dt, alpha, ramped, record_shared, plan=None):
    """The whole comm-free scan (arguments and results as in
    :func:`scan_comm_free_plain`). CPU tensors run the plain version;
    CUDA tensors launch K2 of ``csrc/dense_step.cu`` as :func:`scan_plan`
    plans it. ``plan`` (a :class:`ScanPlan`, from :func:`forced_plan`)
    overrides the plan, so that the checks can run every launch shape at
    any size; the solver never passes it."""
    if d0.device.type == "cpu":
        return scan_comm_free_plain(
            K, d0, dn, t0, F_pre, lM, bc, sld, smask, preds,
            num_steps=num_steps, dt=dt, alpha=alpha, ramped=ramped,
            record_shared=record_shared,
        )
    if d0.device.type != "cuda":
        raise ValueError(f"scan_comm_free: unsupported device {d0.device}")
    dtype, dev = d0.dtype, d0.device
    sfx = kernels.suffix(dtype)
    P, DL = d0.shape
    S3 = sld.shape[1]
    if num_steps <= 0:
        raise ValueError("scan_comm_free: num_steps must be positive")
    specs = [("K", K, (P, DL, DL)), ("smask", smask, (P, S3))] + [
        (name, t, (P, DL)) for name, t in (
            ("d0", d0), ("dn", dn), ("F_pre", F_pre), ("lM", lM),
            ("bc", bc))]
    if preds is not None:
        if preds.dim() != 3 or preds.shape[1] < num_steps:
            raise ValueError(
                f"scan_comm_free: preds must be (P, >= {num_steps}, S3)")
        preds = preds[:, :num_steps].contiguous()
        specs.append(("preds", preds, (P, num_steps, S3)))
    kernels.check_tensors("scan_comm_free", dev, dtype, specs)
    if sld.shape != (P, S3) or sld.device != dev:
        raise ValueError("scan_comm_free: sld must be (P, S3) on the device")
    if not scan_fits(DL, dtype):
        raise ValueError(
            f"scan_comm_free: DL={DL} {dtype} state exceeds a block's "
            "shared memory")
    n_sm = sm_count(dev)
    if plan is None:
        plan = scan_plan(P, DL, dtype, n_sm)
    if plan.smem > kernels.SMEM_PER_BLOCK or (
            plan.blocks > 1 and P * plan.blocks > n_sm):
        raise ValueError(f"scan_comm_free: {plan} does not fit {P} parts "
                         f"on {n_sm} SMs")
    slot = kernels.slot_map(sld, smask, DL)
    d0_out = torch.empty_like(d0)
    dn_out = torch.empty_like(d0)
    shared = (torch.zeros((P, num_steps, S3), dtype=dtype, device=dev)
              if record_shared else None)
    split = plan.blocks > 1
    # the split kernel's double-buffered d and its per-part arrival counts
    buf = torch.empty((2, P, DL), dtype=dtype, device=dev) if split else None
    ctr = torch.zeros(P, dtype=torch.int32, device=dev) if split else None
    fn = kernels.function("dense_step", f"savtpu_scan_comm_free_{sfx}",
                          _SCAN_ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(K), ptr(d0), ptr(dn), ptr(F_pre), ptr(lM), ptr(bc),
             ptr(slot), ptr(preds), ptr(d0_out), ptr(dn_out), ptr(shared),
             ptr(buf), ptr(ctr), kernels.stream(dev), P, DL, S3,
             int(num_steps), int(preds is not None),
             int(bool(record_shared)), int(bool(ramped)), plan.blocks,
             plan.rows, int(plan.resident), plan.smem, float(t0), float(dt),
             float(alpha))
    kernels.check("dense_step", err, "scan_comm_free launch")
    scan_comm_free.launches += 1
    t0c, dtc = step_scalars(t0, dt, alpha, dtype, dev)[:2]
    return d0_out, dn_out, t0c + num_steps * dtc, shared


scan_comm_free.launches = 0
