"""savtpu_torch and chip_smoke.py import, and the port's pipeline (with
the expfit surrogate and with the default LSTM) and its ``--quick`` sweep
run on the CPU, with every package the card's
machine lacks blocked: JAX, flax, optax, h5py, meshio, matplotlib, and
savtpu itself. Runs in a subprocess whose import system refuses those
names."""

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
                 "models.training"):
        assert "savtpu_torch." + name in names, name
    import chip_smoke  # noqa: F401  (imported, not run)

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

    import json
    from savtpu_torch.benchmarks import sweep

    out = {workdir!r} + "/sweep.json"
    assert sweep.main(["--quick", "--device", "cpu", "--out", out]) == 0
    res = json.load(open(out))
    assert [r["mesh"] for r in res["results"]] == ["25x1x1"], res
    assert res["results"][0]["sync_avoiding_steps_per_sec"] > 0
    assert [r["fint_mode"] for r in res["skipped"]] == ["ell"], res
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
