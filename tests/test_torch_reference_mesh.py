"""The reference-mesh branches of the port's entry points against the JAX
package's: where the reference repository's mesh exists
(``savtpu_torch.benchmarks.REF_MESH``, the path the JAX package's
``bench.py``, ``benchmarks/sweep.py`` and ``benchmarks/partition_quality.py``
read), the port's bench, sweep and partition_quality read it as those do.

The mesh is absent here, so each test writes its own: an unstructured
beam of the reference's size (``irregular_beam_mesh(10, 2, 2)``, 99 nodes
/ 272 tets, with its boundary triangles) written with the port's
``write_vtk`` into the test's temporary directory, and every module's
``REF_MESH`` pointed at it. savtpu's side reads the same file with its own
``read_vtk`` and builds with its own ``setup_problem`` and partitioner.

Tolerances: the meshes, partitions, rows' static fields and partition
rows exactly; the sweep's final states 1e-12 of the norm in float64, as
tests/test_torch_sweep.py holds the generated cases.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from savtpu.config import Config as JConfig
from savtpu.mesh import dirichlet_nodes as j_dirichlet
from savtpu.mesh import read_vtk as j_read_vtk
from savtpu.parallel import ShardedProblem as JShardedProblem
from savtpu.parallel import build_partition_maps as j_maps
from savtpu.parallel import partition_elements as j_partition
from savtpu.parallel.sharded import ShardedSolver as JSolver
from savtpu.solvers import setup_problem as j_setup

import savtpu_torch.benchmarks as benchmarks
from savtpu_torch.benchmarks import bench, partition_quality, sweep
from savtpu_torch.mesh import irregular_beam_mesh, write_vtk
from savtpu_torch.parallel import ShardedSolver as TSolver

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

MODULES = (benchmarks, bench, sweep, partition_quality)
REF_CASES = [c for c in sweep.CASES if c[0] == "ref"]


def _by_path(name, rel):
    """A module of the JAX repository's by its file (its benchmarks are
    not a package)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _point_at(monkeypatch, path):
    for mod in MODULES:
        monkeypatch.setattr(mod, "REF_MESH", path)


@pytest.fixture
def ref_vtk(tmp_path, monkeypatch):
    """A written stand-in of the reference mesh, every module's REF_MESH
    pointed at it."""
    path = tmp_path / "Mesh_info" / "beam_coarse.vtk"
    write_vtk(path, irregular_beam_mesh(10, 2, 2))
    _point_at(monkeypatch, path)
    return path


def _savtpu_ref(path, n_parts=2):
    """savtpu's problem on the file: its read_vtk, setup_problem (float64)
    and RCB partition, and its partition maps."""
    prob = j_setup(JConfig(), mesh=j_read_vtk(path), dtype=jnp.float64)
    m = prob.mesh
    epart = j_partition(m.tetra, m.points, n_parts, method="rcb")
    maps = j_maps(m.tetra, epart, m.num_points,
                  j_dirichlet(m.triangles, m.points))
    return prob, epart, maps


def test_skip_reason_only_where_the_mesh_is_absent(tmp_path, monkeypatch):
    assert len(REF_CASES) == 2
    _point_at(monkeypatch, tmp_path / "absent.vtk")
    for case in sweep.CASES:
        reason = sweep.skip_reason(case)
        assert (reason is not None) == (case[0] == "ref"), case
        if reason:
            assert str(tmp_path / "absent.vtk") in reason
    write_vtk(tmp_path / "absent.vtk", irregular_beam_mesh(10, 2, 2))
    assert all(sweep.skip_reason(case) is None for case in sweep.CASES)


def test_bench_problem_is_savtpus_on_the_reference_mesh(ref_vtk):
    prob, epart, maps, problem = bench.headline_problem()
    pj, ej, mj = _savtpu_ref(ref_vtk)
    m = prob.mesh
    assert np.array_equal(m.points, np.asarray(pj.mesh.points))
    assert np.array_equal(m.tetra, np.asarray(pj.mesh.tetra))
    assert np.array_equal(m.triangles, np.asarray(pj.mesh.triangles))
    assert prob.ndof == pj.ndof
    assert np.array_equal(epart, ej)
    assert np.array_equal(maps.global_shared, mj.global_shared)
    assert (m.num_points, len(m.tetra)) == (99, 272)
    assert problem == ("cantilever beam, reference mesh beam_coarse.vtk, "
                       "99 nodes / 272 tets, 2 shards")


def test_bench_problem_without_the_mesh_is_the_generated_beam(
        tmp_path, monkeypatch):
    _point_at(monkeypatch, tmp_path / "absent.vtk")
    prob, _, _, problem = bench.headline_problem()
    assert problem == ("cantilever beam, generated 25x1x1, 104 nodes / "
                       "150 tets, 2 shards")
    assert len(prob.mesh.tetra) == 150


@pytest.mark.parametrize("case", REF_CASES, ids=lambda c: c[4])
def test_sweep_ref_rows_match_savtpu(case, ref_vtk, monkeypatch):
    """The ``ref`` rows at 20 steps in float64: savtpu's static fields,
    and each timed run's final state savtpu's ``ShardedSolver.run`` from
    the same zero state on savtpu's problem of the same file."""
    _, _, _, n_parts, mode, _ = case
    steps = 20
    carries = {}
    real_run = TSolver.run

    def spy(self, *args, **kw):
        out = real_run(self, *args, **kw)
        carries[kw["sync"]] = out[1]  # the last (timed) run of each mode
        return out

    monkeypatch.setattr(TSolver, "run", spy)
    row = sweep.bench_case("ref", 0, 0, n_parts, mode, steps,
                           device="cpu", dtype=torch.float64)
    pj, _, mj = _savtpu_ref(ref_vtk, n_parts)
    sj = JShardedProblem.build(pj, mj, fint_mode=mode, dtype=jnp.float64)
    assert {k: row[k] for k in ("mesh", "elements", "ndof", "n_parts")} == {
        "mesh": "ref_beam_256", "elements": len(pj.mesh.tetra),
        "ndof": pj.ndof, "n_parts": n_parts}
    # (savtpu pads the pallas layout's DL to 256; the real slots lead)
    assert row["fint_mode"] == mode
    assert row["psum_volume_dofs_per_part"] == sj.SD
    d0 = sj.localize(np.zeros(pj.ndof))
    n = row["DL"] - 1
    for sync in (False, True):
        (_, _), cj = JSolver(sj, mesh=None).run(d0, d0, 0.0, steps,
                                                sync=sync, record="none")
        for a, b, name in zip(carries[sync][:2], cj[:2], ("d", "d_prev")):
            a = a.numpy()[:, :n]
            b = np.asarray(b)[:, :n]
            assert np.linalg.norm(b) > 0, (sync, name)
            err = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert err <= 1e-12, (sync, name, err)


def test_sweep_main_runs_the_ref_cases(ref_vtk, tmp_path, monkeypatch):
    """--only ref with the mesh present: both cases run (nothing skipped)
    through bench_case, here at 20 of their 20,000 steps."""
    calls = []
    real = sweep.bench_case

    def short(*case, **kw):
        calls.append(case)
        return real(*case[:5], 20, *case[6:], **kw)

    monkeypatch.setattr(sweep, "bench_case", short)
    out = tmp_path / "sweep.json"
    assert sweep.main(["--only", "ref", "--device", "cpu",
                       "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["skipped"] == []
    assert [c[4] for c in calls] == ["dense", "pallas"]
    assert [(r["mesh"], r["elements"]) for r in res["results"]] == [
        ("ref_beam_256", 272)] * 2
    assert all(r["sync_avoiding_steps_per_sec"] > 0 for r in res["results"])


def test_partition_quality_reference_rows_equal_savtpus(ref_vtk, tmp_path):
    jpq = _by_path("savtpu_partition_quality",
                   "benchmarks/partition_quality.py")
    out = tmp_path / "pq.json"
    assert partition_quality.main(["--out", str(out)]) == 0
    rows = [r for r in json.loads(out.read_text())
            if r["geometry"] == "gmsh_beam_unstructured"]
    mj = j_read_vtk(ref_vtk)
    assert [(r["n_parts"], r["method"]) for r in rows] == [
        (n, m) for n in (4, 8, 16) for m in ("graph", "rcb", "slab")]
    for r in rows:
        ref = jpq.measure(mj.tetra, mj.points, r["n_parts"], r["method"])
        ref.update(geometry="gmsh_beam_unstructured",
                   elements=len(mj.tetra))
        r, ref = dict(r), dict(ref)
        r.pop("partition_seconds")
        ref.pop("partition_seconds")
        assert r == ref
