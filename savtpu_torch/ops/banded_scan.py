"""K4: the comm-free scan on the banded (block-tridiagonal) layout.

Replaces ``savtpu/ops/pallas_banded.py:55`` (``_kernel``, called through
``pallas_scan_comm_free_banded``): num_steps central-difference steps of
every part, with no exchange, no prediction overwrite, no recording and no
compensation. ``ShardedSolver.run`` sends a comm-free banded run with
``record="none"`` to it when its gate allows (the sweep's sync-avoiding
mode).

The solver's (P, DL) vectors are fitted to the kernel's (P, nc*Bk) layout
as savtpu fits them (``pallas_banded.py:153-157``): the real span
n = min(DL-1, nc*Bk) is copied, pad slots get lM = 1 and 0 elsewhere, so
they stay 0; the results are cut back to (P, DL) with the dummy slot 0
(``:191-194``).

Three pieces, as for every kernel of the port: the plain PyTorch version
:func:`scan_comm_free_banded_plain`; the CUDA kernel in
``csrc/banded_scan.cu`` (one part per thread block cluster, its rows split
over the cluster's blocks, the state exchanged through distributed shared
memory; its design and bound are described there); and the wrapper
:func:`scan_comm_free_banded`, which takes the plain version for a CPU
tensor and launches the kernel, or raises, for a CUDA tensor, as
``ops/band_plan.py`` plans it. ``scan_comm_free_banded.launches`` counts
the kernel launches.

Rounding: the plain version follows the kernel, which follows the TPU
kernel (t = t0 + i dt, coefficients from t0, dt, alpha in the state
dtype); only the band matvec's sum order differs.
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
from .dense_step import (
    central_difference_plain,
    ramp_at,
    sm_count,
    step_scalars,
)
from .online_banded import band_matvec

# Kernel against plain version, on the scale of the plain state (max
# |a - b| / max |b| over d0 and dn; chip_smoke.py phase 2 and the gpu test
# legs). The float32 limit sits between the kernel's reading on an H100
# 80GB HBM3, 7.5e-5 after 1,000 steps at the 96x8x8/16 shapes, and a
# control that the same comparison must reject, the band matvec without
# its super-diagonal term (2.4e5: the state diverges; PERF.md). With the
# band zeroed the kernel must equal its plain version bit for bit.
RTOL = {torch.float32: 1e-3, torch.float64: 1e-12}


def fit(v: torch.Tensor, DLB: int, fill: float = 0.0) -> torch.Tensor:
    """(P, DL) solver layout -> (P, DLB) kernel layout: the real span
    n = min(DL-1, DLB) copied, ``fill`` elsewhere."""
    P, DL = v.shape
    n = min(DL - 1, DLB)
    out = torch.full((P, DLB), fill, dtype=v.dtype, device=v.device)
    out[:, :n] = v[:, :n]
    return out


def unfit(v: torch.Tensor, DL: int) -> torch.Tensor:
    """(P, DLB) kernel layout -> (P, DL) solver layout, dummy slot 0."""
    P, DLB = v.shape
    n = min(DL - 1, DLB)
    out = torch.zeros((P, DL), dtype=v.dtype, device=v.device)
    out[:, :n] = v[:, :n]
    return out


def scan_fitted_plain(Kd, Kl, d0, dn, Fp, lM, bc, *, t0, num_steps, dt,
                      alpha, ramped, matvec=band_matvec):
    """The scan on the kernel's (P, nc*Bk) layout; returns (d0, dn).
    ``matvec(Kd, Kl, x)`` is the band product (the kernel checks pass a
    deliberately wrong one as a control)."""
    t0c, dtc, dt2, hda, had = step_scalars(t0, dt, alpha, d0.dtype,
                                           d0.device)
    for i in range(num_steps):
        f = matvec(Kd, Kl, d0)
        ramp = ramp_at(t0c, dtc, i, ramped)
        d1 = central_difference_plain(f, d0, dn, Fp, lM, bc, ramp, dt2,
                                      hda, had)
        d0, dn = d1, d0
    return d0, dn


def scan_comm_free_banded_plain(Kd, Kl, d0, dn, t0, F_pre, lM, bc, *,
                                num_steps, dt, alpha, ramped,
                                matvec=band_matvec):
    """Plain PyTorch version of the banded comm-free scan. Kd, Kl
    (P, nc, Bk, Bk); d0, dn, F_pre, lM, bc (P, DL) in the solver's layout.
    Returns (d0, dn, t_final) in that layout."""
    P, nc, Bk, _ = Kd.shape
    DLB, DL = nc * Bk, d0.shape[1]
    a, b = scan_fitted_plain(
        Kd, Kl, fit(d0, DLB), fit(dn, DLB), fit(F_pre, DLB),
        fit(lM, DLB, 1.0), fit(bc, DLB), t0=t0, num_steps=num_steps, dt=dt,
        alpha=alpha, ramped=ramped, matvec=matvec,
    )
    t0c, dtc = step_scalars(t0, dt, alpha, d0.dtype, d0.device)[:2]
    return unfit(a, DL), unfit(b, DL), t0c + num_steps * dtc


def scan_fits(nc: int, Bk: int, dtype) -> bool:
    """Whether K4's per-part state (six (nc*Bk,) vectors) fits in one
    block's shared memory: the gate's size rule."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 6 * nc * Bk * itemsize <= kernels.SMEM_PER_BLOCK


# 9 tensor pointers and the stream; P, nc, Bk, num_steps, ramped, blocks,
# resident rows, shared-memory bytes; t0, dt, alpha
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
             + [ctypes.c_double] * 3)


def scan_comm_free_banded(Kd, Kl, d0, dn, t0, F_pre, lM, bc, *, num_steps,
                          dt, alpha, ramped, plan=None):
    """The banded comm-free scan (arguments and results as in
    :func:`scan_comm_free_banded_plain`). CPU tensors run the plain
    version; CUDA tensors launch K4 of ``csrc/banded_scan.cu`` as
    ``band_plan.band_plan`` plans it. ``plan`` (a ``BandPlan``, from
    ``band_plan.forced_band_plan``) overrides the plan, so that the checks
    can run every launch shape; it is refused for a shape it does not fit
    and on a CPU tensor. The solver never passes it."""
    P, nc, Bk, _ = Kd.shape
    if plan is not None:
        check_band_plan("scan_comm_free_banded", plan, nc, Bk, d0.dtype)
    if d0.device.type == "cpu":
        if plan is not None:
            raise ValueError("scan_comm_free_banded: plan= sets the CUDA "
                             "kernel's launch; a CPU tensor runs the plain "
                             "version")
        return scan_comm_free_banded_plain(
            Kd, Kl, d0, dn, t0, F_pre, lM, bc, num_steps=num_steps, dt=dt,
            alpha=alpha, ramped=ramped,
        )
    if d0.device.type != "cuda":
        raise ValueError(
            f"scan_comm_free_banded: unsupported device {d0.device}")
    dtype, dev = d0.dtype, d0.device
    sfx = kernels.suffix(dtype)
    DLB, DL = nc * Bk, d0.shape[1]
    if num_steps <= 0:
        raise ValueError("scan_comm_free_banded: num_steps must be positive")
    kernels.check_tensors(
        "scan_comm_free_banded", dev, dtype,
        [("Kd", Kd, (P, nc, Bk, Bk)), ("Kl", Kl, (P, nc, Bk, Bk))]
        + [(name, t, (P, DL)) for name, t in (
            ("d0", d0), ("dn", dn), ("F_pre", F_pre), ("lM", lM),
            ("bc", bc))])
    check_band_operands("scan_comm_free_banded", Kd, Kl)
    if not scan_fits(nc, Bk, dtype):
        raise ValueError(
            f"scan_comm_free_banded: nc*Bk={DLB} {dtype} state exceeds a "
            "block's shared memory")
    if plan is None:
        plan = band_plan(P, nc, Bk, dtype, sm_count(dev),
                         cluster_table("banded_scan", dtype, dev))
    vecs = (fit(d0, DLB), fit(dn, DLB), fit(F_pre, DLB), fit(lM, DLB, 1.0),
            fit(bc, DLB))
    d0_out = torch.empty((P, DLB), dtype=dtype, device=dev)
    dn_out = torch.empty_like(d0_out)
    fn = kernels.function("banded_scan", f"savtpu_banded_scan_{sfx}",
                          _ARGTYPES)
    err = fn(Kd.data_ptr(), Kl.data_ptr(), *[v.data_ptr() for v in vecs],
             d0_out.data_ptr(), dn_out.data_ptr(), kernels.stream(dev), P,
             nc, Bk, int(num_steps), int(bool(ramped)), plan.blocks,
             plan.resident, plan.smem, float(t0), float(dt), float(alpha))
    kernels.check("banded_scan", err, "banded_scan launch")
    scan_comm_free_banded.launches += 1
    t0c, dtc = step_scalars(t0, dt, alpha, dtype, dev)[:2]
    return unfit(d0_out, DL), unfit(dn_out, DL), t0c + num_steps * dtc


scan_comm_free_banded.launches = 0
