"""Roofline accounting of the explicit step (port of
``savtpu/utils/roofline.py``): a measured steps/s as a share of the
card's peaks.

* ``flops_model(sp)``: analytic flops a step per F_int mode, the operator
  plus the update algebra (exact loop-structure counts for the stencil
  forces, 2 flops per stored coefficient for the matrix modes);
* ``bytes_floor_per_step(sp, plan=None)``: the device-memory traffic of
  a step that re-reads its operator: the carry read and written, the
  per-DOF coefficient arrays, and the mode's operator data, as the JAX
  package counts them; given the band plan of K3 or K4, less the Kd rows
  that kernel keeps in shared memory across steps;
* ``roofline(...)``: achieved GB/s and GFLOP/s and their share of the
  peaks of ``device_peaks``.

The peaks are NVIDIA's H100 SXM data sheet: HBM3 3,350 GB/s, float32 off
the tensor cores 67 TFLOP/s, dense BF16 on the tensor cores 989 TFLOP/s.
The explicit step does a few flops a byte, so ``pct_hbm_peak`` is the
axis that matters. Both functions read a ``ShardedProblem``'s tensors
(``lM``, ``denseK``, ``band_Kd``/``band_Kl``, ``ell_blocks``/
``ell_cols``, ``Ke``, ``nhs_*``) and count as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# device-name substring -> peaks:
#   hbm_GBps: device memory bandwidth, GB/s
#   fp32_tflops: float32 off the tensor cores, TFLOP/s
#   tensor_bf16_tflops: dense BF16 on the tensor cores, TFLOP/s
_PEAKS = {
    "h100": {"hbm_GBps": 3350.0, "fp32_tflops": 67.0,
             "tensor_bf16_tflops": 989.0},
}


def device_peaks(device=None) -> Optional[dict]:
    """The peaks of the given (default: the current CUDA) card; None on
    the CPU and on cards without a table row."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    key = name.lower().replace(" ", "")
    for sub, row in _PEAKS.items():
        if sub in key:
            return dict(row, device_kind=name)
    return None


def _numel(t) -> int:
    return int(np.prod(tuple(t.shape)))


def _stencil_cell_flops(G6, material: str) -> float:
    """Exact flops per cell of the structured-box force kernels, by
    replaying their loop structure against the per-type gradients G6
    (6, 4, 3): exactly-zero gradient entries are pruned, as the JAX
    package's kernels prune them at trace time. ``log`` and ``div``
    count as one flop each. Curvilinear grids prune nothing: pass ones."""
    G6 = np.asarray(G6)
    total = 0
    for t in range(6):
        G = G6[t] if G6.ndim == 3 else G6  # (4, 3)
        nz = [[a for a in range(4) if G[a, j] != 0.0] for j in range(3)]
        # gradient H/F_ij = sum_a u[a,i] G[a,j]: 3 rows i per j
        grad = sum(3 * (2 * len(nz[j]) - 1) for j in range(3) if nz[j])
        if material == "neo_hookean":
            grad += 3           # + identity on the diagonal
            cof = 9 * 3         # cofactor matrix: 2 mul + 1 sub each
            det = 5
            coef = 4            # log, mul, sub, div
            stress = 9 * 3      # mu*F + coef*cof
        else:
            cof = det = 0
            coef = 0
            tr_adds = max(0, sum(1 for j in range(3) if nz[j]) - 1)
            # sigma (6 entries): add H_ij+H_ji, mul mu, lmd*tr on the
            # diagonal (mul+add)
            stress = 6 * 2 + 3 * 2 + tr_adds
        force = 0
        for a in range(4):
            for i in range(3):
                terms = sum(1 for j in range(3) if G[a, j] != 0.0)
                if terms:
                    force += 2 * terms - 1 + 1  # muls+adds, then *w
        acc = 12  # 3 components x 4 corners accumulated
        total += grad + cof + det + coef + stress + force + acc
    return float(total)


def flops_model(sp) -> dict:
    """Analytic flops a step, per F_int mode: the operator application
    plus the explicit update."""
    P, DL = sp.lM.shape
    mode = sp.fint_mode
    if mode in ("dense", "pallas"):
        fint = 2.0 * _numel(sp.denseK)
    elif mode == "banded":
        # diagonal blocks once, sub-diagonal blocks twice (lower and the
        # transposed upper)
        fint = 2.0 * _numel(sp.band_Kd) + 4.0 * _numel(sp.band_Kl)
    elif mode == "ell":
        fint = 2.0 * _numel(sp.ell_blocks)
    elif mode == "ebe":
        fint = 2.0 * _numel(sp.Ke)
    elif mode in ("stencil", "nh"):
        NX, NY, NZ = sp.nhs_dims
        cells = (NX - 1) * (NY - (0 if sp.nhs_wrap else 1)) * (NZ - 1)
        material = "neo_hookean" if mode == "nh" else "linear"
        if sp.nhs_Gc is not None:
            per_cell = _stencil_cell_flops(np.ones((6, 4, 3)), material)
        else:
            per_cell = _stencil_cell_flops(sp.nhs_G.cpu().numpy(), material)
        fint = P * cells * per_cell
    else:
        fint = 0.0
    # the update: ~7 flops a DOF, +10 for the TwoSum/renormalize pair
    update = (17.0 if sp.compensated else 7.0) * P * DL
    return {
        "fint_flops_per_step": float(fint),
        "update_flops_per_step": float(update),
        "flops_per_step": float(fint + update),
        "source": "analytic model (savtpu_torch/utils/roofline.py)",
    }


def resident_band_rows(plan, DLB: int) -> int:
    """The Kd rows of one part of DLB rows that a band plan (``ops/
    band_plan.BandPlan``) keeps in shared memory: the first ``resident``
    of each block's ``rows`` (the last block owns fewer)."""
    return sum(min(plan.resident, DLB - r0)
               for r0 in range(0, DLB, plan.rows))


def bytes_floor_per_step(sp, plan=None) -> dict:
    """Device-memory traffic of a step that re-reads its operator: (a)
    the carry read and its successor written, (b) the per-DOF
    coefficients (lumped M, F_pre, the Dirichlet mask) read, (c) the
    mode's operator data read whole, as the JAX package counts it. A kernel that keeps part of the
    operator on chip across steps reads less a step, so a share of the
    peak from this count can pass 100% for it: for the banded kernels
    (K3, K4) pass the ``plan`` they ran with, and the Kd rows it keeps
    resident (read once a run, not once a step) are left out."""
    itemsize = sp.lM.element_size()
    P, DL = sp.lM.shape
    ncarry = 3 if sp.compensated else 2  # (hi, lo, v) vs (d, v)
    nodal_arrays = 2 * ncarry + 3
    nodal = nodal_arrays * P * DL * itemsize

    mode = sp.fint_mode
    op = resident = 0
    if mode in ("dense", "pallas") and sp.denseK is not None:
        op = _numel(sp.denseK) * itemsize
    elif mode == "banded" and sp.band_Kd is not None:
        op = (_numel(sp.band_Kd) + _numel(sp.band_Kl)) * itemsize
        if plan is not None:
            Pb, nc, Bk, _ = sp.band_Kd.shape
            resident = Pb * resident_band_rows(plan, nc * Bk) * Bk * itemsize
    elif mode == "ell" and sp.ell_blocks is not None:
        # 3x3 block values and their column indices
        op = (_numel(sp.ell_blocks) * itemsize
              + _numel(sp.ell_cols) * sp.ell_cols.element_size())
    elif mode == "ebe":
        op = _numel(sp.Ke) * itemsize
    elif mode in ("stencil", "nh"):
        # congruent cells stream no operator; curvilinear grids stream
        # the per-cell gradients
        if sp.nhs_Gc is not None:
            op = (_numel(sp.nhs_Gc) + _numel(sp.nhs_dJwc)) * itemsize
    out = {
        "bytes_per_step_floor": float(nodal + op - resident),
        "nodal_bytes": float(nodal),
        "operator_bytes": float(op - resident),
        "carry_arrays": ncarry,
    }
    if plan is not None:
        out["resident_operator_bytes"] = float(resident)
    return out


def roofline(steps_per_sec: float, *, bytes_per_step: float = 0.0,
             flops_per_step: float = 0.0, device=None) -> dict:
    """Achieved GB/s and GFLOP/s, and their shares of the device peaks
    (where ``device_peaks`` has a row)."""
    out = {
        "achieved_GBps": bytes_per_step * steps_per_sec / 1e9,
        "achieved_GFLOPs": flops_per_step * steps_per_sec / 1e9,
    }
    if bytes_per_step > 0:
        out["arithmetic_intensity_flops_per_byte"] = (
            flops_per_step / bytes_per_step
        )
    peaks = device_peaks(device)
    if peaks:
        out["device_kind"] = peaks["device_kind"]
        out["pct_hbm_peak"] = round(
            100.0 * out["achieved_GBps"] / peaks["hbm_GBps"], 2
        )
        out["pct_fp32_peak"] = round(
            100.0 * out["achieved_GFLOPs"] / (peaks["fp32_tflops"] * 1e3), 2
        )
        out["pct_tensor_bf16_peak"] = round(
            100.0 * out["achieved_GFLOPs"]
            / (peaks["tensor_bf16_tflops"] * 1e3),
            3,
        )
        out["peaks"] = peaks
    return out
