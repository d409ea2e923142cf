"""The port's measurement entry points (savtpu_torch/benchmarks/bench.py,
train_bench.py and partition_quality.py) against the JAX package's root
``bench.py``, ``benchmarks/train_bench.py`` and
``benchmarks/partition_quality.py`` (imported by path), on the CPU at
small sizes:

* the reference loop: its per-rank CSR operators, stepped 200 steps in
  float64 by ``baseline_run`` (no exchange, as the reference at
  MODEL=True), give each rank's state of savtpu's comm-free
  ``ShardedSolver.run``; stepped with the psum added, savtpu's exchanged
  run (dense), each within 1e-10 of the norm;
* ``_roofline_row``'s byte and flop counts and shares of the peaks equal
  savtpu's exactly, with both packages' peak tables set to the H100's,
  savtpu's TPU share names mapped to the port's, and only the layout
  difference ``tests/test_torch_roofline.py`` documents (savtpu pads the
  pallas DL to 256: there savtpu's function runs on the port's tensors);
* ``bench.main`` at reduced steps prints a last line with the six keys
  of savtpu's, finite rates above 0, and details with savtpu's keys;
* none of the three modules writes anything but its ``--details`` /
  ``--out`` file: not into the working directory, not into the repo;
* ``--device cuda`` without a card raises; a failing K2 fails the bench
  (no dense leg in its place), and a pallas leg on a card that did not
  launch K2 once a run raises;
* ``make_data`` equals savtpu's exactly and train_bench prints savtpu's
  keys; partition_quality's rows equal savtpu's ``measure`` exactly
  (but for the partitioning seconds) on every geometry.
"""

import ast
import hashlib
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from savtpu_torch.benchmarks import bench, partition_quality, train_bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# the JAX package's peak table keys for the H100's numbers, so that its
# shares are comparable: vpu -> float32 off the tensor cores, mxu -> bf16
H100 = {"hbm_GBps": 3350.0, "fp32_tflops": 67.0,
        "tensor_bf16_tflops": 989.0, "device_kind": "NVIDIA H100"}
H100_AS_TPU = {"hbm_GBps": 3350.0, "vpu_tflops_f32": 67.0,
               "mxu_tflops_bf16": 989.0, "device_kind": "NVIDIA H100"}
SHARES = {"pct_hbm_peak": "pct_hbm_peak",
          "pct_fp32_peak": "pct_vpu_peak_f32",
          "pct_tensor_bf16_peak": "pct_mxu_peak_bf16"}

SMALL = ["--steps", "200", "--scale-steps", "20",
         "--scale-cells", "24", "4", "4", "--scale-parts", "4"]


def _by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(rel, first_key):
    """The keys of the dict literal in ``rel`` that starts with
    ``first_key`` (read without importing the file)."""
    tree = ast.parse((ROOT / rel).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Dict) and node.keys
                and isinstance(node.keys[0], ast.Constant)
                and node.keys[0].value == first_key):
            return {k.value for k in node.keys}
    raise AssertionError(f"no dict starting with {first_key!r} in {rel}")


def _default_problems():
    """savtpu's and the port's default problem (Config()'s beam, 2 RCB
    parts; the port's partition for both) and their partition maps."""
    import jax.numpy as jnp
    from savtpu.config import Config as JConfig
    from savtpu.parallel import build_partition_maps as j_maps
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        build_partition_maps,
        partition_elements,
    )
    from savtpu_torch.solvers import setup_problem

    pt = setup_problem(Config(), dtype=torch.float64)
    mesh = pt.mesh
    epart = partition_elements(mesh.tetra, mesh.points, 2, method="rcb")
    dn = dirichlet_nodes(mesh.triangles, mesh.points)
    mt = build_partition_maps(mesh.tetra, epart, mesh.num_points, dn)
    pj = j_setup(JConfig(), dtype=jnp.float64)
    assert np.array_equal(np.asarray(pj.mesh.tetra), mesh.tetra)
    mj = j_maps(mesh.tetra, epart, mesh.num_points, dn)
    return pt, mt, pj, mj


def _exchanged_run(ops, n_steps, dt, alpha, ndof):
    """``baseline_run``'s update with the psum it leaves out: every rank's
    K d added into one global vector at its DOFs and read back."""
    states = [(np.zeros_like(op.F_pre), np.zeros_like(op.F_pre))
              for op in ops]
    tn = 0.0
    for _ in range(n_steps):
        ramp = min(tn, 1.0)
        F = np.zeros((ndof, 1))
        for op, (d0, _) in zip(ops, states):
            F[op.gdofs] += op.K.dot(d0)
        for p, op in enumerate(ops):
            d0, dn = states[p]
            lM = op.lM
            d1 = (dt * dt * (op.F_pre * ramp - F[op.gdofs]) + 2 * lM * d0
                  - lM * dn + 0.5 * dt * alpha * lM * dn) / (
                      lM + 0.5 * alpha * dt * lM)
            d1[op.dirichlet] = 0.0
            states[p] = (d1, d0)
        tn += dt
    return states


def test_baseline_matches_savtpu_runs():
    import jax.numpy as jnp
    from savtpu.parallel import ShardedProblem as JSP
    from savtpu.parallel.sharded import ShardedSolver as JSolver

    pt, mt, pj, mj = _default_problems()
    sp = JSP.build(pj, mj, fint_mode="dense", dtype=jnp.float64)
    sol = JSolver(sp, mesh=None)
    z = sp.localize(np.zeros(pj.ndof))
    ops = bench.baseline_operators(pt, mt)
    assert len(ops) == 2 and all(op.K.format == "csr" for op in ops)
    steps = 200
    runs = {
        False: bench.baseline_run(ops, steps, pt.dt, pt.alpha),
        True: _exchanged_run(ops, steps, pt.dt, pt.alpha, pt.ndof),
    }
    for sync, states in runs.items():
        (_, _), carry = sol.run(z, z, 0.0, steps, sync=sync, record="none")
        ref = np.asarray(carry[0])
        for p, op in enumerate(ops):
            n = len(op.gdofs)
            assert np.array_equal(sp.local_dofs_global[p, :n], op.gdofs)
            r = ref[p, :n]
            assert np.abs(r).max() > 0
            err = np.abs(states[p][0][:, 0] - r).max() / np.abs(r).max()
            assert err <= 1e-10, (sync, p, err)
    # the exchange matters: the two runs are far apart
    d_free, d_exch = runs[False][0][0], runs[True][0][0]
    assert np.abs(d_free - d_exch).max() > 1e-3 * np.abs(d_exch).max()


def test_numpy_baseline_rate_is_best_of_reps():
    pt, mt, _, _ = _default_problems()
    best, rates = bench._numpy_baseline_steps_per_sec(pt, mt, n_steps=20)
    assert len(rates) == bench.BASELINE_REPS == 3
    assert best == max(rates) and all(r > 0 for r in rates)


def _numpy_view(sp):
    """The port's problem's attributes the counts read, as NumPy arrays
    (savtpu's functions take these)."""
    from types import SimpleNamespace

    names = ("lM", "denseK", "band_Kd", "band_Kl", "ell_blocks", "ell_cols",
             "Ke", "nhs_G", "nhs_Gc", "nhs_dJwc")
    arrays = {n: (None if getattr(sp, n) is None
                  else getattr(sp, n).cpu().numpy()) for n in names}
    return SimpleNamespace(fint_mode=sp.fint_mode,
                           compensated=sp.compensated, nhs_dims=sp.nhs_dims,
                           nhs_wrap=sp.nhs_wrap, **arrays)


def _leg_pair(leg):
    """savtpu's and the port's ShardedProblem of a bench leg at a small
    size, float32 as the bench steps them."""
    import jax.numpy as jnp
    from savtpu.config import Config as JConfig
    from savtpu.parallel import ShardedProblem as JSP
    from savtpu.parallel import build_partition_maps as j_maps
    from savtpu.solvers import setup_problem as j_setup

    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu_torch.solvers import setup_problem

    mode, cells, n_parts, method, comp = leg
    cj, ct = JConfig(), Config()
    if cells is not None:
        ext = (float(cells[0]) / cells[1], 1.0, 1.0)
        cj.beam_cells = ct.beam_cells = cells
        cj.beam_extent = ct.beam_extent = ext
    pt = setup_problem(ct, dtype=torch.float64)
    pj = j_setup(cj, dtype=jnp.float64)
    mesh = pt.mesh
    epart = partition_elements(mesh.tetra, mesh.points, n_parts, method)
    dn = dirichlet_nodes(mesh.triangles, mesh.points)
    sj = JSP.build(pj, j_maps(mesh.tetra, epart, mesh.num_points, dn),
                   fint_mode=mode, dtype=jnp.float32, compensated=comp)
    st = ShardedProblem.build(
        pt, build_partition_maps(mesh.tetra, epart, mesh.num_points, dn),
        fint_mode=mode, dtype=torch.float32, compensated=comp, device="cpu")
    return sj, st


LEGS = {
    # the headline's legs: Config()'s beam in 2 RCB parts
    "dense": ("dense", None, 2, "rcb", False),
    "pallas": ("pallas", None, 2, "rcb", False),
    # the scale row's legs, at 24x4x4 in 4 parts
    "banded_compensated": ("banded", (24, 4, 4), 4, "rcb", True),
    "stencil_compensated": ("stencil", (24, 4, 4), 4, "box", True),
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_roofline_row_equals_savtpus(leg, monkeypatch):
    import savtpu.utils.roofline as jrl

    import savtpu_torch.utils.roofline as trl

    monkeypatch.setattr(jrl, "device_peaks",
                        lambda device=None: dict(H100_AS_TPU))
    monkeypatch.setattr(trl, "device_peaks", lambda device=None: dict(H100))
    jbench = _by_path("savtpu_root_bench", "bench.py")
    sj, st = _leg_pair(LEGS[leg])
    assert st.fint_mode == sj.fint_mode == LEGS[leg][0]
    sps = 12345.6
    row = bench._roofline_row(st, sps)
    refs = [jbench._roofline_row(_numpy_view(st), sps)]
    if leg == "pallas":
        # savtpu pads the pallas DL to 256 for its kernel's tiles
        assert sj.DL % 256 == 0 and st.DL < sj.DL
    else:
        refs.append(jbench._roofline_row(sj, sps))
    flop_keys = ("fint_flops_per_step", "update_flops_per_step",
                 "flops_per_step")
    for ref in refs:
        assert row["bytes_model"] == ref["bytes_model"]
        assert ([row["flops_model"][k] for k in flop_keys]
                == [ref["flops_model"][k] for k in flop_keys])
        for k in ("achieved_GBps", "achieved_GFLOPs",
                  "arithmetic_intensity_flops_per_byte"):
            assert row[k] == ref[k], k
        for ours, theirs in SHARES.items():
            assert row[ours] == ref[theirs], ours
    assert row["pct_hbm_peak"] > 0


def _last_json_line(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return json.loads(lines[-1])


def test_bench_prints_savtpus_line(tmp_path, capsys):
    details = tmp_path / "out" / "details.json"
    assert bench.main(["--device", "cpu", "--details", str(details),
                       *SMALL]) == 0
    line = _last_json_line(capsys.readouterr().out)
    assert set(line) == _dict_keys("bench.py", "metric")
    assert len(line) == 6
    assert line["metric"] == "sync_avoiding_timesteps_per_sec"
    for k, v in line.items():
        if k not in ("metric", "unit"):
            assert math.isfinite(v) and v > 0, (k, v)
    d = json.loads(details.read_text())
    assert _dict_keys("bench.py", "problem") <= set(d)
    assert d["device"] == {"type": "cpu"}
    assert d["problem"].startswith("cantilever beam, generated 25x1x1, "
                                   "104 nodes / 150 tets")
    assert set(d["sync_avoiding_by_mode"]) == {"dense", "pallas"}
    assert set(d["rep_steps_per_sec"]) == {"dense_avoid", "pallas_avoid",
                                           "dense_exch"}
    for key, rates in d["rep_steps_per_sec"].items():
        assert len(rates) == bench.REPS
        assert d["roofline_toy"][key]["achieved_GBps"] > 0
    assert d["sync_avoiding_by_mode"]["pallas"] == max(
        d["rep_steps_per_sec"]["pallas_avoid"])
    assert len(d["numpy_reference_rep_steps_per_sec"]) == 3
    scale = d["scale_96x8x8_16shards"]
    assert (scale["mesh"], scale["n_parts"], scale["elements"]) == (
        "24x4x4", 4, 2304)
    assert set(scale["by_mode"]) == set(scale["roofline"]) == {
        "banded", "stencil"}
    assert scale["sync_avoiding_steps_per_sec"] == max(
        scale["by_mode"].values())
    # on the CPU the kernels' plain versions run: nothing is launched
    assert not any(n for leg in d["kernel_launches"].values()
                   for n in leg.values())


def _repo_state():
    """What the modules must leave alone: the JAX package's result files
    byte for byte, and the file lists of the directories they live in."""
    files = [ROOT / "BENCH_DETAILS.json"] + sorted(
        (ROOT / "benchmarks").glob("*.json"))
    digests = {str(f): hashlib.sha256(f.read_bytes()).hexdigest()
               for f in files}
    listings = {str(d): sorted(p.name for p in d.iterdir()
                               if p.name != "__pycache__")
                for d in (ROOT, ROOT / "benchmarks",
                          ROOT / "savtpu_torch" / "benchmarks")}
    return digests, listings


WRITERS = {
    "bench": (bench, ["--device", "cpu", *SMALL], "--details"),
    "train_bench": (train_bench, ["--device", "cpu", "--epochs", "1"],
                    "--out"),
    "partition_quality": (partition_quality, [], "--out"),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writes_only_its_output_file(name, tmp_path, monkeypatch):
    mod, argv, flag = WRITERS[name]
    cwd, out = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = _repo_state()
    assert mod.main(argv) == 0
    assert list(cwd.iterdir()) == []
    assert not out.exists()
    assert mod.main(argv + [flag, str(out / "r.json")]) == 0
    assert list(cwd.iterdir()) == []
    assert [p.name for p in out.iterdir()] == ["r.json"]
    json.loads((out / "r.json").read_text())
    assert _repo_state() == before


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((bench, []), (bench, ["--device", "cuda"]),
                      (train_bench, ["--epochs", "1"]),
                      (train_bench, ["--epochs", "1", "--device", "cuda"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)


def test_failing_k2_fails_the_bench(monkeypatch):
    """No dense leg in place of the pallas one: K2's error reaches the
    caller."""
    from savtpu_torch.ops import dense_step

    def broken(*args, **kwargs):
        raise RuntimeError("K2 did not launch")

    monkeypatch.setattr(dense_step, "scan_comm_free", broken)
    with pytest.raises(RuntimeError, match="K2 did not launch"):
        bench.main(["--device", "cpu", *SMALL])


def test_pallas_leg_without_k2_on_a_card_raises(monkeypatch):
    """On a card the pallas comm-free leg must launch K2 once a run; a run
    that took another path (here the CPU's plain version, which launches
    nothing) is refused."""
    from savtpu_torch.config import Config
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import (
        ShardedProblem,
        build_partition_maps,
        partition_elements,
    )
    from savtpu_torch.solvers import setup_problem

    prob = setup_problem(Config(), dtype=torch.float64)
    mesh = prob.mesh
    epart = partition_elements(mesh.tetra, mesh.points, 2, method="rcb")
    maps = build_partition_maps(mesh.tetra, epart, mesh.num_points,
                                dirichlet_nodes(mesh.triangles, mesh.points))
    sp = ShardedProblem.build(prob, maps, fint_mode="pallas",
                              dtype=torch.float32, device="cpu")
    monkeypatch.setattr(bench, "synchronize", lambda dev: None)
    with pytest.raises(RuntimeError, match="launched K2 0 times"):
        bench._timed_leg(sp, prob.ndof, 20, 2, False, torch.device("cuda"))
    leg = bench._timed_leg(sp, prob.ndof, 20, 2, False, torch.device("cpu"))
    assert len(leg["rep_steps_per_sec"]) == 2


def test_make_data_equals_savtpus():
    jtb = _by_path("savtpu_train_bench", "benchmarks/train_bench.py")
    for kw in ({}, dict(G=40, n_past=5, n_future=3, D=4, seed=7)):
        X, Y = train_bench.make_data(**kw)
        XJ, YJ = jtb.make_data(**kw)
        assert X.dtype == XJ.dtype == np.float32
        assert np.array_equal(X, XJ) and np.array_equal(Y, YJ)


def test_train_bench_prints_savtpus_keys(tmp_path, capsys):
    out = tmp_path / "train.json"
    assert train_bench.main(["--epochs", "2", "--device", "cpu", "--out",
                             str(out)]) == 0
    res = json.loads(out.read_text())
    keys = _dict_keys("benchmarks/train_bench.py", "epochs")
    assert set(res) == keys
    assert json.loads(capsys.readouterr().out) == res
    assert res["epochs"] == 2 and res["device_savtpu"] == {"type": "cpu"}
    assert set(res["reference_3450_epochs_projection_s"]) == {
        "savtpu", "torch_cpu"}
    for k in ("savtpu_seconds_incl_compile", "savtpu_steady_sec_per_epoch",
              "torch_cpu_sec_per_epoch"):
        assert math.isfinite(res[k]) and res[k] > 0, k
    assert all(math.isfinite(v) for v in res["final_losses"].values())


@pytest.mark.parametrize("geometry", sorted(partition_quality.GEOMETRIES))
def test_partition_rows_equal_savtpus(geometry):
    jpq = _by_path("savtpu_partition_quality",
                   "benchmarks/partition_quality.py")
    from savtpu.mesh import beam_mesh as j_beam

    from savtpu_torch.mesh import beam_mesh

    assert partition_quality.GEOMETRIES == jpq.GEOMETRIES
    cells_n, extent = partition_quality.GEOMETRIES[geometry]
    mesh, mj = beam_mesh(*cells_n, extent=extent), j_beam(*cells_n,
                                                          extent=extent)
    assert np.array_equal(mesh.tetra, mj.tetra)
    assert np.array_equal(mesh.points, mj.points)
    rows = partition_quality.rows(mesh, geometry)
    assert [(r["n_parts"], r["method"]) for r in rows] == [
        (n, m) for n in (4, 8, 16) for m in ("graph", "rcb", "slab")]
    for r in rows:
        ref = jpq.measure(mj.tetra, mj.points, r["n_parts"], r["method"])
        ref.update(geometry=geometry, elements=len(mj.tetra))
        assert set(r) == set(ref)
        r, ref = dict(r), dict(ref)
        r.pop("partition_seconds")
        ref.pop("partition_seconds")
        assert r == ref
