"""The port's scale-out sweep (savtpu_torch/benchmarks/sweep.py) against
the JAX package's benchmarks/sweep.py: the same cases, rows with the same
keys, and, on tiny cases run on the CPU in float64, final states equal to
savtpu's ``ShardedSolver.run(record="none")`` from the same zero state
(1e-12 of the norm on the real slots). savtpu's pallas and banded
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
    """ref (the reference repository's mesh), ell, permute and the
    Neo-Hookean case are skipped; every other case is run."""
    for case in sweep.CASES:
        mesh, _, mode, exch, _ = sweep.case_tag(case)
        nh = len(case) > 8 and case[8]
        unported = (mesh == "ref_beam_256" or mode == "ell"
                    or exch == "permute" or nh)
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


def test_main_writes_only_out_and_lists_skips(tmp_path):
    """--only over unported cases: nothing runs, every case is listed as
    skipped in the --out file, and the exit code is 0."""
    out = tmp_path / "sweep.json"
    rc = sweep.main(["--only", "ell", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["results"] == []
    assert len(res["skipped"]) == 1
    assert "not ported" in res["skipped"][0]["skipped"]
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
