"""The port's scale-out sweep (savtpu_torch/benchmarks/sweep.py) against
the JAX package's benchmarks/sweep.py: the same cases, rows with the same
keys, and, on tiny cases run on the CPU in float64, final states equal to
savtpu's ``ShardedSolver.run(record="none")`` from the same zero state
(1e-12 of the norm on the real slots; the Neo-Hookean case to the
conditioning of its stress at the strains of 20 steps from rest, see
``test_nh_case_matches_savtpu``). savtpu's pallas and banded
comm-free runs go through its Pallas kernels in interpret mode, the
port's through the plain versions of K2 and K4.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from savtpu_torch.benchmarks import sweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# the keys of a row of the JAX package's bench_case (psum exchange)
SAVTPU_ROW_KEYS = {
    "mesh", "elements", "ndof", "n_parts", "DL", "fint_mode",
    "exchange_mode", "compensated", "psum_volume_dofs_per_part",
    "sync_avoiding_steps_per_sec", "sync_avoiding_elem_updates_per_sec",
    "exchanged_steps_per_sec", "exchanged_elem_updates_per_sec",
    "sync_avoid_speedup",
}


def _savtpu_sweep_lists():
    """CASES and QUICK of benchmarks/sweep.py, read without importing it
    (importing it configures JAX's compilation cache)."""
    tree = ast.parse((ROOT / "benchmarks" / "sweep.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("CASES", "QUICK"):
                out[name] = ast.literal_eval(node.value)
    return out["CASES"], out["QUICK"]


def test_cases_are_savtpus():
    cases, quick = _savtpu_sweep_lists()
    assert sweep.CASES == cases
    assert sweep.QUICK == quick


def test_unported_cases_are_skipped_with_a_reason():
    """Only ref (the reference repository's mesh, which this repository
    does not hold) is skipped; every other case, ell, permute and the
    Neo-Hookean one too, is run."""
    for case in sweep.CASES:
        mesh = sweep.case_tag(case)[0]
        unported = mesh == "ref_beam_256"
        reason = sweep.skip_reason(case)
        assert (reason is not None) == unported, (case, reason)
        if unported:
            with pytest.raises(NotImplementedError):
                sweep.bench_case(*case, device="cpu")


@pytest.mark.parametrize("case", [
    (8, 1, 1, 2, "dense", 20),
    (8, 1, 1, 2, "pallas", 20),
    (25, 2, 2, 2, "banded", 20),
])
def test_sweep_case_matches_savtpu(case, monkeypatch):
    """The port's bench_case on the CPU in float64: its row has savtpu's
    keys, and the final state of each timed run equals savtpu's run from
    the same zero state."""
    import jax.numpy as jnp
    from savtpu.config import Config as JConfig
    from savtpu.parallel import ShardedProblem as JShardedProblem
    from savtpu.parallel import build_partition_maps as j_maps
    from savtpu.parallel.sharded import ShardedSolver as JSolver
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import ShardedSolver as TSolver
    from savtpu_torch.parallel import partition_elements

    nx, ny, nz, parts, mode, steps = case
    carries = {}
    real_run = TSolver.run

    def spy(self, *args, **kw):
        out = real_run(self, *args, **kw)
        carries[kw["sync"]] = out[1]  # the last (timed) run of each mode
        return out

    monkeypatch.setattr(TSolver, "run", spy)
    row = sweep.bench_case(*case, device="cpu", dtype=torch.float64)
    assert SAVTPU_ROW_KEYS <= set(row)
    assert row["fint_mode"] == mode and row["n_parts"] == parts
    assert row["sync_avoiding_steps_per_sec"] > 0

    cfg = JConfig()
    cfg.beam_cells = (nx, ny, nz)
    cfg.beam_extent = (float(nx) / max(ny, 1), 1.0, 1.0)
    pj = j_setup(cfg, dtype=jnp.float64)
    m = pj.mesh
    ep = partition_elements(m.tetra, m.points, parts, "rcb")
    maps = j_maps(m.tetra, ep, m.num_points,
                  dirichlet_nodes(m.triangles, m.points))
    sj = JShardedProblem.build(pj, maps, fint_mode=mode, dtype=jnp.float64)
    assert row["elements"] == len(m.tetra) and row["ndof"] == pj.ndof
    assert row["psum_volume_dofs_per_part"] == sj.SD
    jsol = JSolver(sj, mesh=None)
    d0 = sj.localize(np.zeros(pj.ndof))
    n = row["DL"] - 1
    for sync in (False, True):
        (_, _), cj = jsol.run(d0, d0, 0.0, steps, sync=sync, record="none")
        ct = carries[sync]
        for a, b, name in zip(ct[:2], cj[:2], ("d", "d_prev")):
            a = a.numpy()[:, :n]
            b = np.asarray(b)[:, :n]
            assert np.abs(a).max() > 0.0
            err = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert err <= 1e-12, (sync, name, err)
        assert float(ct[2]) == pytest.approx(float(cj[2]), rel=1e-13)


def _savtpu_nh_problem(nx, ny, nz, parts):
    """savtpu's sweep problem of the Neo-Hookean case, float64."""
    import jax.numpy as jnp
    from savtpu.config import Config as JConfig
    from savtpu.ops.material import NeoHookean as JNeoHookean
    from savtpu.parallel import ShardedProblem as JShardedProblem
    from savtpu.parallel import build_partition_maps as j_maps
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import partition_elements

    cfg = JConfig()
    cfg.beam_cells = (nx, ny, nz)
    cfg.beam_extent = (float(nx) / max(ny, 1), 1.0, 1.0)
    pj = j_setup(cfg, dtype=jnp.float64)
    m = pj.mesh
    ep = partition_elements(m.tetra, m.points, parts, "rcb")
    maps = j_maps(m.tetra, ep, m.num_points,
                  dirichlet_nodes(m.triangles, m.points))
    return pj, JShardedProblem.build(
        pj, maps, dtype=jnp.float64,
        material=JNeoHookean.from_engineering(E=1e6, nu=0.3, rho=1.0,
                                              fz=0.5))


def test_nh_case_takes_the_stencil_in_both_packages():
    """The sweep's Neo-Hookean case (48x4x4, 8 RCB parts): RCB cuts the
    beam into 6-cell boxes, so both packages take the gather-free stencil
    on the same 7x5x5 node boxes."""
    case = next(c for c in sweep.CASES if len(c) > 8 and c[8])
    nx, ny, nz, parts, mode = case[:5]
    assert (nx, ny, nz, parts, mode) == (48, 4, 4, 8, "auto")
    _, st = sweep.build_case(*case[:5], *case[6:], device="cpu")
    _, sj = _savtpu_nh_problem(nx, ny, nz, parts)
    assert st.fint_mode == sj.fint_mode == "nh"
    assert st.nhs_dims == sj.nhs_dims == (7, 5, 5)


def test_nh_case_matches_savtpu(monkeypatch):
    """The Neo-Hookean case's bench_case on a tiny beam on the CPU in
    float64 against savtpu's run(record="none") from the same zero state.
    From rest the strains after 20 steps are about 1e-8, and near F = I
    the first Piola stress cancels to O(strain), so the packages' sum
    orders agree to float64's eps over the strain (1.2e-8 and 1.3e-8
    measured, not 1e-12): the bound held is 16 eps / strain, with the
    strain taken as max |d| over the cell size. tests/test_torch_nh.py
    holds the same path at 1e-12 from 1e-2 strains."""
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    from savtpu_torch.parallel import ShardedSolver as TSolver

    nx, ny, nz, parts, steps = 8, 2, 2, 2, 20
    carries = {}
    real_run = TSolver.run

    def spy(self, *args, **kw):
        out = real_run(self, *args, **kw)
        carries[kw["sync"]] = out[1]
        return out

    monkeypatch.setattr(TSolver, "run", spy)
    row = sweep.bench_case(nx, ny, nz, parts, "auto", steps, "psum", False,
                           True, device="cpu", dtype=torch.float64)
    assert SAVTPU_ROW_KEYS <= set(row) and row["fint_mode"] == "nh"
    pj, sj = _savtpu_nh_problem(nx, ny, nz, parts)
    assert row["DL"] == sj.DL and row["psum_volume_dofs_per_part"] == sj.SD
    d0 = sj.localize(np.zeros(pj.ndof))
    n, cell = row["DL"] - 1, 1.0 / ny
    for sync in (False, True):
        (_, _), cj = JSolver(sj, mesh=None).run(d0, d0, 0.0, steps,
                                                sync=sync, record="none")
        for a, b, name in zip(carries[sync][:2], cj[:2], ("d", "d_prev")):
            a = a.numpy()[:, :n]
            b = np.asarray(b)[:, :n]
            strain = np.abs(b).max() / cell
            assert strain > 0.0
            err = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert err <= 16 * np.finfo(np.float64).eps / strain, (
                sync, name, err, strain)


def test_main_writes_only_out_and_lists_skips(tmp_path):
    """--only over the cases that cannot run here: nothing runs, every
    case is listed as skipped in the --out file, and the exit code is
    0."""
    out = tmp_path / "sweep.json"
    rc = sweep.main(["--only", "ref", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["results"] == []
    assert len(res["skipped"]) == 2
    assert all("beam_coarse.vtk" in s["skipped"] for s in res["skipped"])
    assert res["device"] == {"type": "cpu"}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sweep.json"]


def test_failed_case_is_recorded_and_exits_nonzero(tmp_path, monkeypatch):
    """A supported case that raises is recorded with its error and the
    sweep exits with 1."""
    def broken(*args, **kw):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(sweep, "bench_case", broken)
    out = tmp_path / "sweep.json"
    rc = sweep.main(["--only", "25x1x1/2/dense", "--device", "cpu",
                     "--out", str(out)])
    assert rc == 1
    row = json.loads(out.read_text())["results"][0]
    assert row["error"] == "RuntimeError: broken on purpose"
    assert row["mesh"] == "25x1x1" and row["fint_mode"] == "dense"


def test_default_device_is_cuda():
    """Without --device the sweep runs on CUDA, and raises where there is
    none instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sweep would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.main(["--quick", "--out", "unused.json"])
