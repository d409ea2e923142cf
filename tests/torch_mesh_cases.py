"""The cases of tests/test_torch_mesh.py and test_torch_mesh_pipeline.py,
on the port's side: each builds its problem with savtpu_torch alone and
runs it either emulated (``mesh=None``, in the pytest process) or over a
gloo device mesh (one process per rank, tests/torch_mesh_worker.py), and
returns its outputs in the global stacked layout. The savtpu side of each
case (``shard_map`` on the 8 virtual CPU devices) is built from the same
spec in the test files. This module imports torch, numpy and savtpu_torch
only: the ranks never import JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from savtpu_torch import api
from savtpu_torch.config import Config
from savtpu_torch.mesh import dirichlet_nodes, tube_mesh
from savtpu_torch.models.training import fit_stacked
from savtpu_torch.parallel import (
    ShardedProblem,
    ShardedSolver,
    build_partition_maps,
    partition_elements,
)
from savtpu_torch.pipeline import data_prepare, online_predictor
from savtpu_torch.pipeline.common import build_context
from savtpu_torch.solvers import setup_problem

SIN = "sin"            # runs' preds: seeded sinusoids on the shared slots
PREV = "prev_shared"   # runs' preds: the previous run's shared rows


def _beam(cells, extent, parts, method="rcb", dtype="float64", **build):
    return dict(mesh=("beam", cells, extent), parts=parts, method=method,
                dtype=dtype, build=build)


def _tube(dims, parts, dirichlet_axis=0, **build):
    return dict(mesh=("tube",) + tuple(dims), parts=parts, method="box",
                dirichlet_axis=dirichlet_axis, dtype="float64", build=build)


def _run(steps, sync=True, preds=None, record="all", save_every=1,
         resume=False):
    """One ``solver.run`` of a case, from the problem's initial state or,
    with ``resume``, from the previous run's carry (as stage 4's blocks
    follow its exchanged warm-up)."""
    return dict(steps=steps, sync=sync, preds=preds, record=record,
                save_every=save_every, resume=resume)


# the float32 case's exchanged warm-up and comm-free block, in steps
F32_WARM, F32_BLOCK = 300, 300

# name -> (world size, problem spec, runs): each mirrors one of savtpu's
# shard_map tests (named in tests/test_torch_mesh.py)
SOLVER_CASES = {
    "shard_map_matches_emulation": (
        4, _beam((8, 1, 1), (8.0, 1.0, 1.0), 4, fint_mode="dense"),
        [_run(60)]),
    "multiple_parts_per_device": (
        4, _beam((16, 1, 1), (16.0, 1.0, 1.0), 8, fint_mode="dense"),
        [_run(50)]),
    "save_every_in_scan": (
        2, _beam((8, 1, 1), (8.0, 1.0, 1.0), 2, fint_mode="dense"),
        [_run(60, save_every=5)]),
    "permute": (
        8, _beam((16, 1, 1), (16.0, 1.0, 1.0), 8, fint_mode="dense",
                 exchange_mode="permute"),
        [_run(50)]),
    "compensated": (
        4, _beam((8, 1, 1), (8.0, 1.0, 1.0), 4, fint_mode="dense",
                 compensated=True),
        [_run(60)]),
    "grid_dense": (
        8, _beam((8, 4, 4), (8.0, 4.0, 4.0), 8, "box", fint_mode="dense",
                 exchange_mode="grid"),
        [_run(40)]),
    "grid_stencil_compensated": (
        8, _beam((8, 4, 4), (8.0, 4.0, 4.0), 8, "box", fint_mode="stencil",
                 exchange_mode="grid", compensated=True),
        [_run(40)]),
    "grid_tube": (
        8, _tube((1, 8, 4), 8, dirichlet_axis=2, exchange_mode="grid"),
        [_run(40)]),
    "stencil_faces": (
        8, _beam((16, 2, 2), (16.0, 2.0, 2.0), 8, "box", fint_mode="stencil",
                 compensated=True),
        [_run(60, sync=False, preds=SIN, save_every=5)]),
    "tube_stencil": (
        8, _tube((2, 8, 8), 8, fint_mode="stencil", compensated=True),
        [_run(40, save_every=5),
         _run(40, sync=False, preds=PREV, record="traj", save_every=5)]),
    "online_kernel": (
        8, _beam((16, 2, 2), (8.0, 1.0, 1.0), 8, fint_mode="banded",
                 compensated=True),
        [_run(60, sync=False, preds=SIN, save_every=5)]),
    # the slice's kind in float32 (ROADMAP C1): an exchanged warm-up, then
    # a comm-free block of K3 (its plain version here) from its end state;
    # held to the float32 envelope, not to TOL (tests/test_torch_mesh.py)
    "float32_online_kernel": (
        4, _beam((8, 4, 4), (4.0, 2.0, 2.0), 8, dtype="float32",
                 fint_mode="banded", compensated=True),
        [_run(F32_WARM, save_every=5),
         _run(F32_BLOCK, sync=False, preds=SIN, save_every=5,
              resume=True)]),
    # one rank: the mesh path must give the emulated run's bits
    "one_rank_dense": (
        1, _beam((8, 1, 1), (8.0, 1.0, 1.0), 4, fint_mode="dense"),
        [_run(40, save_every=5), _run(40, sync=False, preds=PREV)]),
    "one_rank_banded_compensated": (
        1, _beam((12, 2, 2), (6.0, 1.0, 1.0), 4, fint_mode="banded",
                 compensated=True),
        [_run(40, save_every=5),
         _run(40, sync=False, preds=SIN, save_every=5)]),
    "one_rank_pallas": (
        1, _beam((8, 1, 1), (8.0, 1.0, 1.0), 2, fint_mode="pallas"),
        [_run(40), _run(40, sync=False, preds=PREV)]),
    "one_rank_permute": (
        1, _beam((8, 1, 1), (8.0, 1.0, 1.0), 1, fint_mode="dense",
                 exchange_mode="permute"),
        [_run(30)]),
}

# name -> (world size, problem spec, the ValueError's match): savtpu's
# "one part per device" refusals
REFUSED_CASES = {
    "permute_refused": (
        4, _beam((16, 1, 1), (16.0, 1.0, 1.0), 8, fint_mode="dense",
                 exchange_mode="permute"), "one part per device"),
    "grid_refused": (
        4, _beam((8, 4, 4), (8.0, 4.0, 4.0), 8, "box", fint_mode="dense",
                 exchange_mode="grid"), "one part per device"),
    "parts_not_multiple": (
        4, _beam((8, 1, 1), (8.0, 1.0, 1.0), 2, fint_mode="dense"),
        "must be a multiple"),
}


def build_problem(spec, device="cpu", dtype=None):
    """(prob, ShardedProblem) of a spec on ``device``, assembled and
    stepped in ``dtype`` (a name; default the spec's), as the pipeline
    does for its state dtype."""
    cfg = Config()
    dt = getattr(torch, dtype or spec["dtype"])
    kind = spec["mesh"][0]
    if kind == "beam":
        cfg.beam_cells, cfg.beam_extent = spec["mesh"][1:]
        prob = setup_problem(cfg, dtype=dt)
    else:
        n_r, n_theta, n_z = spec["mesh"][1:]
        mesh = tube_mesh(n_r=n_r, n_theta=n_theta, n_z=n_z)
        prob = setup_problem(cfg, mesh=mesh, dtype=dt)
    m = prob.mesh
    ep = partition_elements(m.tetra, m.points, spec["parts"],
                            method=spec["method"])
    dn = dirichlet_nodes(m.triangles, m.points,
                         axis=spec.get("dirichlet_axis", 0))
    maps = build_partition_maps(m.tetra, ep, m.num_points, dn)
    sp = ShardedProblem.build(prob, maps, dtype=dt, device=device,
                              **spec["build"])
    return prob, sp


def sin_preds(smask: np.ndarray, steps: int, seed: int = 0) -> np.ndarray:
    """Smooth seeded shared-DOF rows (a sinusoid per slot), (P, T, S3)."""
    rng = np.random.default_rng(seed)
    P, S3 = smask.shape
    t = np.arange(steps)[None, :, None]
    amp = rng.uniform(0.01, 0.05, (P, 1, S3))
    w = rng.uniform(0.001, 0.01, (P, 1, S3))
    return amp * np.sin(w * t) * smask[:, None, :]


def _np(x):
    return None if x is None else np.asarray(
        x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def solver_case(name: str, mesh=None, dtype=None) -> dict:
    """Run solver case ``name`` emulated (``mesh`` None) or over ``mesh``,
    in ``dtype`` (default the spec's); returns {"<run>_traj" | "_shared" |
    "_d" | "_dn" | "_t", "<run>_preds": numpy, the global layout} (every
    rank gets the whole)."""
    _, spec, runs = SOLVER_CASES[name]
    prob, sp = build_problem(spec, dtype=dtype)
    solver = ShardedSolver(sp, mesh)
    d0 = solver.sp.localize(prob.d0)
    dn = solver.sp.localize(prob.dn)
    smask = sp.smask.numpy()
    out, prev, carry = {}, None, (d0, dn, 0.0)
    for i, run in enumerate(runs):
        preds = None
        if run["preds"] == SIN:
            preds = torch.as_tensor(sin_preds(smask, run["steps"]))
            out[f"{i}_preds"] = preds.numpy()
            preds = solver.block(preds)
        elif run["preds"] == PREV:
            preds = prev
            out[f"{i}_preds"] = _np(solver.gather(prev))
        start = carry if run.get("resume") else (d0, dn, 0.0)
        (traj, shared), carry = solver.run(
            *start, run["steps"], sync=run["sync"], preds=preds,
            record=run["record"], save_every=run["save_every"])
        prev = shared
        for k, v in (("traj", traj), ("shared", shared), ("d", carry[0]),
                     ("dn", carry[1])):
            if v is not None:
                out[f"{i}_{k}"] = _np(solver.gather(v))
        out[f"{i}_t"] = _np(carry[2])
    return out


def max_rel(a, b) -> float:
    """chip_smoke.py's ``artifact_diff`` measure of two stacked arrays
    (parts on the leading axis): the largest |a - b| of a part over b's
    largest, the largest over the parts, in float64."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    assert a.shape == b.shape and np.isfinite(a).all(), (a.shape, b.shape)
    return max(float(np.abs(a[p] - b[p]).max())
               / max(float(np.abs(b[p]).max()), 1e-300)
               for p in range(a.shape[0]))


def refused_case(name: str, mesh) -> str:
    """The ValueError's message of a refused case."""
    _, spec, _ = REFUSED_CASES[name]
    _, sp = build_problem(spec)
    try:
        ShardedSolver(sp, mesh)
    except ValueError as e:
        return str(e)
    return ""


# ---------------------------------------------------------------- training

FIT_MODELS, FIT_WINDOWS = 4, 12


def fit_inputs(seed: int = 0):
    """Seeded (X, Y, feat_mask) of FIT_MODELS stacked surrogates."""
    rng = np.random.default_rng(seed)
    D, n_p, n_f = 5, 4, 3
    X = rng.uniform(0.0, 1.0, (FIT_MODELS, FIT_WINDOWS, n_p, D))
    Y = rng.uniform(0.0, 1.0, (FIT_MODELS, FIT_WINDOWS, n_f, D))
    fm = np.ones((FIT_MODELS, D))
    fm[1, 3:] = 0.0
    X[1, :, :, 3:] = Y[1, :, :, 3:] = 0.0
    return X, Y, fm


def fit_cfg(arch="lstm"):
    s = Config().surrogate
    s.arch = arch
    s.n_past, s.n_future = 4, 3
    s.hidden_size, s.num_layers_encoder = 6, 2
    s.batch_size, s.num_epochs = 3, 6
    s.input_noise = 1e-3
    s.dtype = "float64"
    return s


def fit_case(mesh=None, arch="lstm") -> dict:
    """fit_stacked on fit_inputs() with surrogate ``arch`` ("lstm" or
    "linear"): the trained arrays of all models and the history (every
    rank gets the whole; the blocks joined in rank order)."""
    X, Y, fm = fit_inputs()
    model, hist = fit_stacked(fit_cfg(arch), X, Y, fm, device="cpu",
                              log_every=0, log_fn=lambda *a: None, mesh=mesh)
    out = {f"hist.{k}": np.asarray(v) for k, v in hist.items()}
    for k, v in model.state_dict().items():
        if mesh is not None:
            parts = [torch.empty_like(v) for _ in range(mesh.size())]
            torch.distributed.all_gather(parts, v.detach().contiguous(),
                                         group=mesh.get_group())
            v = torch.cat(parts)
        out[f"param.{k}"] = _np(v)
    return out


# ---------------------------------------------------------------- pipeline

class Killed(RuntimeError):
    """An injected stop of a checkpointed run."""


def kill_after(solver, n_calls: int):
    """Make ``solver.run`` raise Killed at its (n_calls + 1)-th call."""
    run = solver.run
    calls = [0]

    def wrapped(*a, **k):
        if calls[0] == n_calls:
            raise Killed(f"stopped after {n_calls} chunks")
        calls[0] += 1
        return run(*a, **k)

    solver.run = wrapped


def pipeline_case(kind: str, cfg_path: str, mesh=None) -> dict:
    """Run one stage of the config at ``cfg_path`` (its workdir prepared by
    the test) emulated or over ``mesh``:

    - "stage1": stage 1 through ``api.Simulation``;
    - "stage4": stage 4 on the store's stage 1-3 artifacts;
    - "ckpt_kill": stage 1 with checkpoints, stopped after two chunks
      (the checkpoint stays);
    - "ckpt_resume": stage 1 resumed from the store's checkpoint.

    Returns {"step": the checkpoint's step} for "ckpt_kill", else {}."""
    cfg = Config.from_json(cfg_path)
    if kind == "stage1":
        api.Simulation(cfg, device="cpu", verbose=False,
                       device_mesh=mesh).generate_data()
        return {}
    ctx = build_context(cfg, device="cpu", device_mesh=mesh)
    if kind == "stage4":
        online_predictor.run(cfg, ctx=ctx, verbose=False)
        return {}
    if kind == "ckpt_kill":
        kill_after(ctx.solver, 2)
        try:
            data_prepare.run(cfg, ctx=ctx, verbose=False)
        except Killed:
            pass
        ctx.barrier()
        with np.load(ctx.store.ckpt_dir("stage1") / "state.npz") as z:
            return {"step": np.asarray(z["step"])}
    if kind == "ckpt_resume":
        data_prepare.run(cfg, ctx=ctx, verbose=False, resume=True)
        return {}
    raise ValueError(f"unknown pipeline case {kind!r}")


def fit_name(arch: str, world: int) -> str:
    """The worker's output name of the fit case of ``arch`` over
    ``world`` ranks."""
    return "fit_stacked" if arch == "lstm" else f"fit_{arch}_{world}ranks"


def write_spec(path: Path, solver=(), refused=(), fit=(), gates=False,
               pipeline=()) -> None:
    """The worker's case list: solver and refused case names, the archs
    of the fit cases, whether to run the gates case, and pipeline cases
    as [name, kind, cfg_path]."""
    path.write_text(json.dumps(dict(solver=list(solver),
                                    refused=list(refused), fit=list(fit),
                                    gates=gates,
                                    pipeline=[list(p) for p in pipeline])))


def launch_worlds(specs: dict, out: Path, timeout: float = 240.0) -> dict:
    """Start tests/torch_mesh_worker.py for every rank of every world in
    ``specs`` ({world size: spec path}) at once, each world joining its
    own ``file://`` store under ``out``, and wait for all. Returns {world:
    [exit codes]}; a world still running at ``timeout`` is killed (its
    codes are then None)."""
    worker = Path(__file__).with_name("torch_mesh_worker.py")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {}
    for world, spec in specs.items():
        init = f"file://{out}/pg_{world}_{time.time_ns()}"
        procs[world] = [subprocess.Popen(
            [sys.executable, str(worker), str(spec), str(out), str(r),
             str(world), init], env=env) for r in range(world)]
    end = time.monotonic() + timeout
    codes = {}
    for world, ps in procs.items():
        codes[world] = []
        for p in ps:
            try:
                codes[world].append(
                    p.wait(timeout=max(1.0, end - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                codes[world].append(None)
    return codes


def gates_case(mesh) -> dict:
    """K2's and K4's gates under ``mesh`` and emulated, on problems and
    runs they take when emulated ({"<kernel>_<mesh|emulated>": bool}),
    and ``make_device_mesh``'s refusal of a device count other than the
    world size, with the mesh's size, rank and axis name."""
    out = {}
    spec = _beam((8, 1, 1), (8.0, 1.0, 1.0), 2, fint_mode="pallas")
    _, sp = build_problem(spec)
    for key, m in (("mesh", mesh), ("emulated", None)):
        out[f"k2_{key}"] = np.asarray(
            ShardedSolver(sp, m)._pallas_scan_ok(False, "shared", 1))
    spec = _beam((12, 2, 2), (6.0, 1.0, 1.0), 2, fint_mode="banded")
    _, sp = build_problem(spec)
    for key, m in (("mesh", mesh), ("emulated", None)):
        out[f"k4_{key}"] = np.asarray(
            ShardedSolver(sp, m)._banded_scan_ok(False, "none", None))
    # the mesh spans every rank: another device count raises
    from savtpu_torch.parallel import make_device_mesh

    try:
        make_device_mesh(mesh.size() + 1, device_type="cpu")
        out["n_devices_error"] = np.asarray("")
    except ValueError as e:
        out["n_devices_error"] = np.asarray(str(e))
    out["mesh"] = np.asarray([mesh.size(), mesh.ndim])
    out["axis"] = np.asarray(mesh.mesh_dim_names[0])
    return out
