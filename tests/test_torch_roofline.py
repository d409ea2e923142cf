"""The port's roofline accounting (``utils/roofline.py``) against
savtpu's, on the CPU in float64: ``flops_model`` and
``bytes_floor_per_step`` equal exactly for every F_int mode (dense,
pallas, banded, ell, ebe; the linear and Neo-Hookean stencils on a box
partition of the beam, the Neo-Hookean stencil on the curvilinear tube;
plain and compensated), ``roofline``'s shares against the H100 peaks,
and ``device_peaks`` on the CPU.

The counts are held twice: savtpu's functions applied to the port's own
tensors (as NumPy arrays) give the port's numbers exactly in every mode;
and savtpu's functions on savtpu's problem give them too wherever the
two layouts store the same operator. They do not in two places, which
the counts then show: savtpu pads the pallas layout's DL to a multiple of
256 for its kernel's tiles (the port's K1 needs no padding), and the
port's ell column indices are int64 where savtpu's are int32.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NH = dict(E=1e6, nu=0.3, rho=1.0, fz=0.5)


def _pair(mesh_kind, n_parts, method, axis=0, **kw):
    """savtpu's and the port's ShardedProblem on the same mesh and
    partition, float64; ``nh=True`` in kw gives both the Neo-Hookean
    material."""
    from savtpu.config import Config as JConfig
    from savtpu.mesh import generator as jg
    from savtpu.ops.material import NeoHookean as JNH
    from savtpu.parallel import ShardedProblem as JSP
    from savtpu.parallel import build_partition_maps as j_maps
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.mesh import generator as tg
    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.parallel import ShardedProblem
    from savtpu_torch.parallel import build_partition_maps as t_maps
    from savtpu_torch.parallel import partition_elements
    from savtpu_torch.solvers import setup_problem

    kind, dims = mesh_kind
    if kind == "beam":
        ext = (float(dims[0]) / dims[1], 1.0, 1.0)
        mt, mj = tg.beam_mesh(*dims, extent=ext), jg.beam_mesh(*dims,
                                                               extent=ext)
    else:
        mt, mj = tg.tube_mesh(*dims), jg.tube_mesh(*dims)
    cj, ct = JConfig(), Config()
    cj.partition.dirichlet_axis = ct.partition.dirichlet_axis = axis
    pj, pt = j_setup(cj, mesh=mj), setup_problem(ct, mesh=mt)
    ep = partition_elements(mt.tetra, mt.points, n_parts, method)
    dn = dirichlet_nodes(mt.triangles, mt.points, axis=axis)
    nh = kw.pop("nh", False)
    sj = JSP.build(pj, j_maps(mt.tetra, ep, mt.num_points, dn),
                   material=JNH.from_engineering(**NH) if nh else None, **kw)
    st = ShardedProblem.build(
        pt, t_maps(mt.tetra, ep, mt.num_points, dn), device="cpu",
        material=NeoHookean.from_engineering(**NH) if nh else None, **kw)
    return sj, st


def _as_numpy(sp):
    """The attributes the counts read, as NumPy arrays (savtpu's
    functions take these)."""
    from types import SimpleNamespace

    names = ("lM", "denseK", "band_Kd", "band_Kl", "ell_blocks", "ell_cols",
             "Ke", "nhs_G", "nhs_Gc", "nhs_dJwc")
    out = {n: (None if getattr(sp, n) is None
               else getattr(sp, n).cpu().numpy()) for n in names}
    return SimpleNamespace(fint_mode=sp.fint_mode,
                           compensated=sp.compensated,
                           nhs_dims=sp.nhs_dims, nhs_wrap=sp.nhs_wrap, **out)


CASES = {
    "dense": (("beam", (8, 2, 2)), 2, "rcb", dict(fint_mode="dense")),
    "pallas": (("beam", (8, 2, 2)), 2, "rcb", dict(fint_mode="pallas")),
    "banded": (("beam", (8, 2, 2)), 2, "rcb", dict(fint_mode="banded")),
    "banded_compensated": (("beam", (8, 2, 2)), 2, "rcb",
                           dict(fint_mode="banded", compensated=True)),
    "ell": (("beam", (8, 2, 2)), 3, "rcb", dict(fint_mode="ell")),
    "ebe": (("beam", (8, 2, 2)), 3, "rcb", dict(fint_mode="ebe")),
    "stencil": (("beam", (8, 4, 4)), 4, "box",
                dict(fint_mode="stencil", exchange_mode="grid")),
    "nh_stencil": (("beam", (8, 4, 4)), 4, "box", dict(nh=True)),
    "nh_tube": (("tube", (2, 8, 6)), 4, "box", dict(nh=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_equal_savtpus(case):
    from savtpu.utils.roofline import bytes_floor_per_step as j_bytes
    from savtpu.utils.roofline import flops_model as j_flops

    from savtpu_torch.utils.roofline import (
        bytes_floor_per_step,
        flops_model,
    )

    mesh_kind, n_parts, method, kw = CASES[case]
    sj, st = _pair(mesh_kind, n_parts, method,
                   axis=2 if mesh_kind[0] == "tube" else 0, **dict(kw))
    assert st.fint_mode == sj.fint_mode
    if case == "nh_tube":
        assert st.nhs_Gc is not None and sj.nhs_Gc is not None
    ft, bt = flops_model(st), bytes_floor_per_step(st)
    keys = ("fint_flops_per_step", "update_flops_per_step", "flops_per_step")
    as_np = _as_numpy(st)
    fn, bn = j_flops(as_np), j_bytes(as_np)
    assert [ft[k] for k in keys] == [fn[k] for k in keys]
    assert bt == bn
    fj, bj = j_flops(sj), j_bytes(sj)
    if case != "pallas":
        assert [ft[k] for k in keys] == [fj[k] for k in keys]
    if case not in ("pallas", "ell"):
        assert bt == bj
    if case == "ell":
        # the same blocks; the port's int64 column indices
        assert bt["operator_bytes"] - bj["operator_bytes"] == 4 * int(
            np.prod(tuple(st.ell_cols.shape)))
    if case == "pallas":
        assert sj.DL % 256 == 0 and st.DL < sj.DL
    assert ft["flops_per_step"] > 0
    assert bt["bytes_per_step_floor"] > bt["nodal_bytes"] or case in (
        "stencil", "nh_stencil")


@pytest.mark.parametrize("blocks,resident", [(1, 0), (1, None), (3, 5),
                                             (4, None)])
def test_band_plan_leaves_out_resident_rows(blocks, resident):
    """With the plan of K3 or K4, the Kd rows it keeps in shared memory
    (the first ``resident`` of each block's rows) leave the count; every
    other term, and the count with no plan, stay savtpu's."""
    from savtpu_torch.ops.band_plan import forced_band_plan
    from savtpu_torch.utils.roofline import (
        bytes_floor_per_step,
        resident_band_rows,
    )

    mesh_kind, n_parts, method, kw = CASES["banded"]
    _, st = _pair(mesh_kind, n_parts, method, **dict(kw))
    P, nc, Bk, _ = st.band_Kd.shape
    DLB = nc * Bk
    plan = forced_band_plan(nc, Bk, st.dtype, blocks, resident)
    rows = sum(min(plan.resident, len(range(r0, min(DLB, r0 + plan.rows))))
               for r0 in range(0, DLB, plan.rows))
    assert resident_band_rows(plan, DLB) == rows
    full, less = bytes_floor_per_step(st), bytes_floor_per_step(st, plan)
    cut = P * rows * Bk * st.band_Kd.element_size()
    assert less["resident_operator_bytes"] == cut
    assert less["bytes_per_step_floor"] == full["bytes_per_step_floor"] - cut
    assert less["operator_bytes"] == full["operator_bytes"] - cut
    assert less["nodal_bytes"] == full["nodal_bytes"]
    assert (cut == 0) == (plan.resident == 0)
    assert "resident_operator_bytes" not in full


def test_roofline_shares(monkeypatch):
    from savtpu_torch.utils import roofline as rl

    peaks = {"hbm_GBps": 3350.0, "fp32_tflops": 67.0,
             "tensor_bf16_tflops": 989.0, "device_kind": "NVIDIA H100"}
    monkeypatch.setattr(rl, "device_peaks", lambda device=None: dict(peaks))
    out = rl.roofline(10_000.0, bytes_per_step=3.35e7, flops_per_step=6.7e7)
    assert out["achieved_GBps"] == pytest.approx(335.0)
    assert out["achieved_GFLOPs"] == pytest.approx(670.0)
    assert out["arithmetic_intensity_flops_per_byte"] == pytest.approx(2.0)
    assert out["pct_hbm_peak"] == 10.0
    assert out["pct_fp32_peak"] == 1.0
    assert out["pct_tensor_bf16_peak"] == round(100 * 670 / 989e3, 3)
    assert out["device_kind"] == "NVIDIA H100"
    assert not {"pct_vpu_peak_f32", "pct_mxu_peak_bf16"} & set(out)


def test_device_peaks_on_the_cpu():
    from savtpu_torch.utils.roofline import device_peaks, roofline

    assert device_peaks("cpu") is None
    if not torch.cuda.is_available():
        assert device_peaks() is None
    out = roofline(100.0, bytes_per_step=1e6, device="cpu")
    assert out["achieved_GBps"] == pytest.approx(0.1)
    assert "pct_hbm_peak" not in out


def test_h100_row_is_the_data_sheet(monkeypatch):
    from savtpu_torch.utils import roofline as rl

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    p = rl.device_peaks("cuda")
    assert (p["hbm_GBps"], p["fp32_tflops"], p["tensor_bf16_tflops"]) == (
        3350.0, 67.0, 989.0)
    assert p["hbm_GBps"] * 1e9 == 3.35e12 and p["fp32_tflops"] * 1e12 == 67e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert rl.device_peaks("cuda") is None
