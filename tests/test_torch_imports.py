"""savtpu_torch and chip_smoke.py import, and the port's pipeline (with
the expfit surrogate, on the Neo-Hookean box path, with the default
LSTM, the hybrid, per-rank LSTMs with mixed teacher forcing and
dropout, a seed ensemble and the linear surrogate; on meshes read from
gmsh ``.msh`` and ``.vtu`` files: an irregular beam in graph parts,
banded and with the windowed Neo-Hookean layout, and the periodic tube
on its box stencil with the seam-wrapped grid exchange) and its
``--quick`` sweep and its measurement entry points (``benchmarks/bench``,
``train_bench``, ``partition_quality`` at small sizes) run on the CPU,
with every package the card's machine lacks
blocked: JAX, flax, optax, h5py, meshio, matplotlib, and
savtpu itself; then the solver-options slice (ell and ebe forces, the
permute exchange, an unramped load, resync blocks, checkpoints) and a
stage's command line; then the serial-solver and steady slice (stage 1
at ``deg = 2``, stage 3's grid, the serial runner with linear and
Neo-Hookean forces, eigen modes). Runs in a subprocess whose import system refuses those
names. The device-mesh path (the five stages over a one-rank gloo mesh,
then the linear fit under that mesh, ``globalize`` and the native
partitioner) runs the same way, in a subprocess of its own."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "h5py", "meshio", "matplotlib",
           "savtpu")

SCRIPT = textwrap.dedent(
    """
    import importlib
    import pkgutil
    import sys

    BLOCKED = {blocked!r}


    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {{name}}")
            return None


    sys.meta_path.insert(0, Blocker())
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    sys.path.insert(0, {root!r})

    import torch

    torch.set_num_threads(1)
    import savtpu_torch

    names = ["savtpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            savtpu_torch.__path__, "savtpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    for name in ("models.data", "models.lstm", "models.predictor",
                 "models.training", "mesh.msh_io", "mesh.vtu_io",
                 "native", "benchmarks.bench", "benchmarks.train_bench",
                 "benchmarks.partition_quality"):
        assert "savtpu_torch." + name in names, name
    import chip_smoke  # noqa: F401  (imported, not run)

    # the measurement entry points, at small sizes
    from savtpu_torch.benchmarks import bench, partition_quality, train_bench

    assert bench.main(["--device", "cpu", "--steps", "100",
                       "--scale-steps", "10",
                       "--scale-cells", "24", "4", "4",
                       "--scale-parts", "4"]) == 0
    assert train_bench.main(["--epochs", "1", "--device", "cpu"]) == 0
    assert partition_quality.main([]) == 0

    from savtpu_torch.config import Config
    from savtpu_torch.pipeline import run_all

    cfg = Config()
    cfg.workdir = {workdir!r} + "/Results"
    cfg.model_dir = {workdir!r} + "/Distributed_save"
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.solver.num_steps = 60
    cfg.solver.dtype = "float32"
    cfg.solver.fint_mode = "banded"
    s = cfg.surrogate
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.arch = "expfit"
    s.modal_dim = 3
    s.expfit_order = 8
    metrics = run_all.run(cfg, verbose=False, device="cpu")
    assert metrics["global_rel_l2_nonshared"] == metrics[
        "global_rel_l2_nonshared"]

    # the Neo-Hookean box pipeline: stencil forces, grid exchange
    cfg = Config()
    cfg.workdir = {workdir!r} + "/nh/Results"
    cfg.model_dir = {workdir!r} + "/nh/Distributed_save"
    cfg.beam_cells = (8, 2, 2)
    cfg.beam_extent = (4.0, 1.0, 1.0)
    cfg.material.model = "neo_hookean"
    cfg.partition.n_parts = 4
    cfg.partition.method = "box"
    cfg.solver.exchange_mode = "grid"
    cfg.solver.num_steps = 60
    cfg.solver.dtype = "float32"
    s = cfg.surrogate
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.arch = "expfit"
    s.modal_dim = 3
    s.expfit_order = 8
    s.pred_consensus = False
    metrics = run_all.run(cfg, verbose=False, device="cpu")
    assert metrics["global_rel_l2_nonshared"] == metrics[
        "global_rel_l2_nonshared"]
    import json
    setup = [json.loads(ln) for ln in open(
        cfg.workdir + "/metrics.jsonl")]
    setup = [r for r in setup if r["event"] == "setup_breakdown"][0]
    assert setup["fint_mode"] == "nh", setup
    assert setup["nh_stencil_dims"] == [3, 3, 3], setup

    # the default surrogate (arch="lstm", stacked) through all five stages
    cfg = Config()
    cfg.workdir = {workdir!r} + "/lstm/Results"
    cfg.model_dir = {workdir!r} + "/lstm/Distributed_save"
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.solver.num_steps = 90
    s = cfg.surrogate
    assert s.arch == "lstm"
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.batch_size, s.num_epochs, s.hidden_size = 2, 3, 8
    metrics = run_all.run(cfg, verbose=False, device="cpu")
    assert metrics["global_rel_l2_nonshared"] == metrics[
        "global_rel_l2_nonshared"]

    # the surrogates of the surrogate slice, each through all five stages
    for tag, kw, steps in (
            ("hybrid", dict(arch="hybrid", modal_dim=2, expfit_order=6,
                            cut_off=0.5), 200),
            ("per_rank", dict(stacked=False, training_method="mtf",
                              dropout_encoder=0.1, dropout_decoder=0.1), 90),
            ("ensemble", dict(ensemble=2), 90),
            ("linear", dict(arch="linear", cut_off=0.5), 90)):
        cfg = Config()
        cfg.workdir = {workdir!r} + f"/{{tag}}/Results"
        cfg.model_dir = {workdir!r} + f"/{{tag}}/Distributed_save"
        cfg.beam_cells = (6, 1, 1)
        cfg.beam_extent = (6.0, 1.0, 1.0)
        cfg.partition.n_parts = 2
        cfg.solver.num_steps = steps
        s = cfg.surrogate
        s.n_past, s.n_future, s.filter_size = 4, 4, 5
        s.batch_size, s.num_epochs, s.hidden_size = 2, 2, 8
        for k, v in kw.items():
            setattr(s, k, v)
        metrics = run_all.run(cfg, verbose=False, device="cpu")
        assert metrics["global_rel_l2_nonshared"] == metrics[
            "global_rel_l2_nonshared"], tag

    # the unstructured road: meshes from gmsh and VTK XML files
    from savtpu_torch.mesh import (
        irregular_beam_mesh, tube_mesh, write_msh, write_vtu)

    irr = {workdir!r} + "/irregular.msh"
    write_msh(irr, irregular_beam_mesh(8, 2, 2, extent=(8.0, 1.0, 1.0)),
              binary=True)
    tube = {workdir!r} + "/tube.vtu"
    write_vtu(tube, tube_mesh(1, 8, 4, length=2.0))
    for tag, path, kw in (
            ("irregular_banded", irr, dict(fint_mode="banded")),
            ("irregular_window", irr, dict(model="neo_hookean")),
            ("tube_grid", tube, dict(model="neo_hookean", method="box",
                                     exchange_mode="grid", axis=2))):
        cfg = Config()
        cfg.workdir = {workdir!r} + f"/{{tag}}/Results"
        cfg.model_dir = {workdir!r} + f"/{{tag}}/Distributed_save"
        cfg.mesh_path = path
        cfg.partition.n_parts = 4
        cfg.partition.method = kw.get("method", "graph")
        cfg.partition.dirichlet_axis = kw.get("axis", 0)
        cfg.material.model = kw.get("model", "linear")
        cfg.solver.fint_mode = kw.get("fint_mode", "auto")
        cfg.solver.exchange_mode = kw.get("exchange_mode", "psum")
        cfg.solver.num_steps = 60
        cfg.solver.dtype = "float32"
        s = cfg.surrogate
        s.n_past, s.n_future, s.filter_size = 4, 4, 5
        s.arch = "expfit"
        s.modal_dim = 3
        s.expfit_order = 8
        s.pred_consensus = False
        metrics = run_all.run(cfg, verbose=False, device="cpu")
        assert metrics["global_rel_l2_nonshared"] == metrics[
            "global_rel_l2_nonshared"], tag
        setup = [json.loads(ln) for ln in open(
            cfg.workdir + "/metrics.jsonl")]
        setup = [r for r in setup if r["event"] == "setup_breakdown"][0]
        if tag.startswith("irregular"):
            assert setup["partition_route"] == "native", setup
        assert setup["nh_window"] == (tag == "irregular_window"), setup
        if tag == "tube_grid":
            assert setup["nh_stencil_dims"] == [2, 5, 3], setup

    from savtpu_torch.benchmarks import sweep

    out = {workdir!r} + "/sweep.json"
    assert sweep.main(["--quick", "--device", "cpu", "--out", out]) == 0
    res = json.load(open(out))
    assert [r["mesh"] for r in res["results"]] == ["25x1x1", "48x4x4"], res
    assert [r["fint_mode"] for r in res["results"]] == ["dense", "ell"], res
    assert all(r["sync_avoiding_steps_per_sec"] > 0
               for r in res["results"]), res
    assert res["skipped"] == [], res
    # the solver-options slice: ell forces, the permute exchange, an
    # unramped load, resync blocks and checkpoints in stages 1 and 4;
    # then stage 1's command line in ebe mode, resuming nothing
    cfg = Config()
    cfg.workdir = {workdir!r} + "/options/Results"
    cfg.model_dir = {workdir!r} + "/options/Distributed_save"
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.material.ramped = False
    cfg.solver.num_steps = 150
    cfg.solver.fint_mode = "ell"
    cfg.solver.exchange_mode = "permute"
    cfg.solver.ckpt_every = 40
    s = cfg.surrogate
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.arch = "expfit"
    s.modal_dim = 3
    s.expfit_order = 8
    s.resync_blocks = 2
    metrics = run_all.run(cfg, verbose=False, device="cpu")
    assert metrics["global_rel_l2_nonshared"] == metrics[
        "global_rel_l2_nonshared"]
    ev = [json.loads(ln) for ln in open(cfg.workdir + "/metrics.jsonl")]
    assert [r for r in ev if r["event"] == "stage4_online"][-1][
        "n_resync_steps"] == 40
    from savtpu_torch.pipeline import data_prepare

    cfg.solver.fint_mode = "ebe"
    cfg.to_json({workdir!r} + "/options/cfg.json")
    data_prepare.main(["--config", {workdir!r} + "/options/cfg.json",
                       "--device", "cpu", "--no-resume"])

    # the serial-solver and steady slice: stage 1 at deg = 2 (the
    # steady-only P2 path), stage 3's grid on the LSTM run's artifacts,
    # the serial runner (linear and Neo-Hookean) and eigen modes
    cfg = Config()
    cfg.workdir = {workdir!r} + "/p2/Results"
    cfg.model_dir = {workdir!r} + "/p2/Distributed_save"
    cfg.beam_cells = (5, 1, 1)
    cfg.beam_extent = (5.0, 1.0, 1.0)
    cfg.solver.deg = 2
    prob = data_prepare.run(cfg, verbose=False, device="cpu")
    assert prob.edofs.shape[1] == 30
    from savtpu_torch.mesh import read_vtk
    assert read_vtk(cfg.workdir + "/Static/steady_distributed.vtk"
                    ).num_points == prob.mesh.num_points

    from savtpu_torch.pipeline import model_training
    cfg = Config()
    cfg.workdir = {workdir!r} + "/lstm/Results"
    cfg.model_dir = {workdir!r} + "/lstm/Distributed_save"
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.solver.num_steps = 90
    s = cfg.surrogate
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.batch_size, s.num_epochs, s.hidden_size = 2, 1, 8
    res = model_training.run_grid(cfg, [2], [1e-3, 2e-3], [8],
                                  verbose=False, device="cpu")
    assert len(res) == 2

    from savtpu_torch.ops.assembly import FIntOperator
    from savtpu_torch.ops.element import batch_element_mkf
    from savtpu_torch.ops.material import NeoHookean
    from savtpu_torch.solvers import (
        NeoHookeanFIntOperator, eigen_modes, make_step_fn, run_explicit,
        setup_problem)
    prob = setup_problem(cfg)
    for op in (FIntOperator(prob.Ke, prob.edofs, prob.ndof, mode="ebe"),
               NeoHookeanFIntOperator(
                   NeoHookean.from_engineering(E=1e6, nu=0.3, rho=1.0,
                                               fz=0.5),
                   prob.coords, prob.edofs, prob.ndof)):
        step = make_step_fn(op, prob.F_pre, prob.lumped_M, prob.mask,
                            prob.alpha, prob.dt)
        traj, _ = run_explicit(step, prob.d0, prob.dn, 0.0, prob.dt, 40,
                               save_every=4)
        assert traj.shape == (10, prob.ndof)
        assert bool(torch.isfinite(traj).all())
    Me, Ke, _ = batch_element_mkf(1, 2, prob.material, 0.0, prob.coords)
    assert eigen_modes(Me, Ke, prob.edofs, prob.ndof,
                       prob.dirichlet_dofs, num=20).shape == (20,)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("IMPORTED", len(names))
    """
)


def test_port_imports_and_runs_without_jax(tmp_path):
    code = SCRIPT.format(blocked=BLOCKED, root=str(ROOT),
                         workdir=str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=tmp_path,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "IMPORTED" in res.stdout


MESH_SCRIPT = textwrap.dedent(
    """
    import sys

    BLOCKED = {blocked!r}


    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {{name}}")
            return None


    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, {root!r})

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from savtpu_torch import api
    from savtpu_torch.config import Config
    from savtpu_torch.parallel import make_device_mesh

    dist.init_process_group("gloo", init_method="file://{workdir}/pg",
                            rank=0, world_size=1)
    mesh = make_device_mesh(device_type="cpu")
    cfg = Config()
    cfg.workdir = {workdir!r} + "/Results"
    cfg.model_dir = {workdir!r} + "/Distributed_save"
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.solver.num_steps = 60
    cfg.solver.fint_mode = "banded"
    cfg.solver.compensated = True
    s = cfg.surrogate
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.arch = "expfit"
    s.modal_dim = 3
    s.expfit_order = 8
    sim = api.Simulation(cfg, device="cpu", verbose=False, device_mesh=mesh)
    metrics = sim.run_all()
    assert sim.ctx.solver.mesh is mesh and sim.ctx.comm.world == 1
    assert metrics and all(v == v for v in metrics.values()
                           if isinstance(v, float))

    # the linear fit under the mesh, globalize, the native partitioner
    import numpy as np
    sys.path.insert(0, {root!r} + "/tests")
    import torch_mesh_cases as cases
    from savtpu_torch.native import native_partition
    from savtpu_torch.parallel.partition import dual_graph

    got, ref = cases.fit_case(mesh, "linear"), cases.fit_case(None, "linear")
    assert set(got) == set(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    prob, sp = cases.build_problem(cases.SOLVER_CASES["one_rank_dense"][1])
    v = np.arange(prob.ndof, dtype=np.float64)
    g = sp.globalize(sp.localize(v), prob.ndof)
    assert g.dtype == np.float64 and (g[g != 0] == v[g != 0]).all()
    xadj, adjncy = dual_graph(prob.mesh.tetra)
    ep = native_partition(xadj, adjncy, 3)
    assert ep is not None and sorted(set(ep.tolist())) == [0, 1, 2]
    dist.destroy_process_group()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("MESH_RAN")
    """
)


def test_mesh_path_runs_one_gloo_rank_without_jax(tmp_path):
    """make_device_mesh and the five stages of api.Simulation over a
    one-rank gloo mesh (stages 1 and 4 over the mesh, banded compensated:
    K3's plain version per rank), then ``fit_stacked(mesh=,
    arch="linear")`` against the unsharded fit, ``globalize`` and
    ``native_partition``, with JAX and savtpu blocked."""
    code = MESH_SCRIPT.format(blocked=BLOCKED, root=str(ROOT),
                              workdir=str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=tmp_path,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "MESH_RAN" in res.stdout


def test_no_cuda_and_no_cpu_request_raises():
    """Without a CUDA device, an entry point that was not asked for the
    CPU raises instead of falling back."""
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        if torch.cuda.is_available():
            print("HAS_CUDA")
            raise SystemExit(0)
        from savtpu_torch.api import Simulation
        try:
            Simulation().ctx
        except RuntimeError as e:
            assert "CUDA" in str(e)
            print("RAISED")
        """
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "RAISED" in res.stdout or "HAS_CUDA" in res.stdout


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there
    is no CUDA device, and when it stands alone without the package."""
    import shutil

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=cwd)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
