"""Stages 1 and 4 of the port's pipeline over a device mesh of 4 gloo
ranks (tests/torch_mesh_worker.py) against the port's emulated stages and
savtpu's stages under ``shard_map`` (4 of the conftest's virtual CPU
devices), and the stage-1 checkpoint carried across the two.

Mirrors tests/test_pipeline.py:122 (stage 1 under the mesh, through
``api.Simulation``), :159 (stage 4's stacked LSTM with the consensus's
cross-rank psum) and tests/test_expfit.py:167 (the expfit feed), on their
configuration: 8x1x1 beam, 4 parts, n_p = n_f = 4, n_s = 5; stage 4 runs
from savtpu's stage 1-3 artifacts (its models converted), the LSTM in
float64.

Tolerances (float64 state):
- the mesh against the port's emulation: the norm of the difference
  within 1e-12 of the reference's (the ranks only add in another order),
  except the expfit case's, 1e-6: its feed is float32 by design (in both
  packages), and a rank's one-part batch of the modal reconstruction
  (a float32 product) rounds otherwise than the emulated four-part batch
  (measured 1.7e-8);
- the port against savtpu, as tests/test_torch_lstm_pipeline.py and
  test_torch_pipeline.py hold the two packages (max |a - b| over the
  trajectory's max): 1e-10 for stage 1, 1e-9 for the float64 LSTM's
  comm-free rows, 5e-6 for the expfit feed, which both packages evaluate
  in float32 with transcendentals that differ in the last bits.
"""

import json

import numpy as np
import pytest
import torch

import jax

from savtpu.config import Config as JConfig
from savtpu.io.artifacts import ArtifactStore as JStore
from savtpu.io.artifacts import load_displacement as j_load
from savtpu.parallel import make_device_mesh as j_mesh
from savtpu.pipeline import data_prepare as j_data_prepare
from savtpu.pipeline import online_predictor as j_online
from savtpu.pipeline import run_all as j_run_all
from savtpu.pipeline.common import build_context as j_build_context

from savtpu_torch.config import Config as TConfig
from savtpu_torch.convert import import_savtpu_run
from savtpu_torch.io.artifacts import ArtifactStore as TStore
from savtpu_torch.io.artifacts import load_displacement as t_load
from savtpu_torch.pipeline import data_prepare, online_predictor

import torch_mesh_cases as cases

torch.set_num_threads(1)

WORLD = 4
MESH_TOL = {"stage4_expfit": 1e-6}
LIMITS = {"stage1": 1e-10, "stage4_lstm": 1e-9, "stage4_expfit": 5e-6}


def _cfg(C, root, steps=100, **sur):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (8, 1, 1)
    cfg.beam_extent = (8.0, 1.0, 1.0)
    cfg.partition.n_parts = WORLD
    cfg.solver.num_steps = steps
    s = cfg.surrogate
    s.n_past = s.n_future = 4
    s.filter_size = 5
    s.cut_off = 0.5
    s.batch_size = 2
    s.num_epochs = 4
    s.hidden_size = 8
    s.learning_rate = 2e-3
    for k, v in sur.items():
        setattr(s, k, v)
    return cfg


SURROGATES = {
    "stage4_lstm": dict(stacked=True, pred_consensus=True, dtype="float64"),
    "stage4_expfit": dict(arch="expfit", modal_dim=3, expfit_order=8,
                          pred_consensus=True),
}


def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return np.array(f["Displacement"])


def _read_msgpack(path, meta):
    from flax import serialization

    return serialization.msgpack_restore(path.read_bytes())


def _tstore(cfg):
    return TStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """savtpu's runs (emulated stages 1-5, then stage 1 or 4 again under
    its mesh), the port's emulated runs, and the ranks' runs over the
    port's mesh; returns {case: (port mesh cfg, port emulated cfg, savtpu
    mesh cfg)} and the ranks' outputs directory."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the conftest's virtual devices")
    root = tmp_path_factory.mktemp("mesh_pipeline")
    out = root / "out"
    out.mkdir()
    jobs, cfgs = [], {}

    # stage 1: savtpu under its mesh; the port emulated here, over its
    # mesh in the ranks
    jc = _cfg(JConfig, root / "s1_savtpu", steps=60)
    j_data_prepare.run(jc, ctx=j_build_context(
        jc, device_mesh=j_mesh(WORLD)), verbose=False)
    te, tm = (_cfg(TConfig, root / f"s1_{k}", steps=60)
              for k in ("emu", "mesh"))
    data_prepare.run(te, verbose=False, device="cpu")
    tm.to_json(root / "s1_mesh.json")
    jobs.append(("stage1", "stage1", str(root / "s1_mesh.json")))
    cfgs["stage1"] = (tm, te, jc)

    # stage 4: savtpu's stages 1-5 emulated, its stage 4 again under its
    # mesh; the port's stage 4 from savtpu's stage 1-3 artifacts
    for name, sur in SURROGATES.items():
        jc = _cfg(JConfig, root / f"{name}_savtpu", **sur)
        j_run_all.run(jc, verbose=False)
        j_online.run(jc, ctx=j_build_context(jc, device_mesh=j_mesh(WORLD)),
                     verbose=False)
        te, tm = (_cfg(TConfig, root / f"{name}_{k}", **sur)
                  for k in ("emu", "mesh"))
        for c in (te, tm):
            import_savtpu_run(jc.workdir, jc.model_dir, WORLD, _tstore(c),
                              read_h5=_read_h5, read_params=_read_msgpack)
        online_predictor.run(te, verbose=False, device="cpu")
        tm.to_json(root / f"{name}_mesh.json")
        jobs.append((name, "stage4", str(root / f"{name}_mesh.json")))
        cfgs[name] = (tm, te, jc)

    # checkpoints: one written over the mesh (resumed emulated by the
    # test), one written emulated here (resumed by the ranks)
    ref = _cfg(TConfig, root / "ck_ref", steps=60)
    data_prepare.run(ref, verbose=False, device="cpu")
    ck = {k: _cfg(TConfig, root / k, steps=60)
          for k in ("ck_mesh_first", "ck_emu_first")}
    for c in ck.values():
        c.solver.ckpt_every = 20
    ck["ck_mesh_first"].to_json(root / "ck_mesh_first.json")
    jobs.append(("ckpt_kill", "ckpt_kill", str(root / "ck_mesh_first.json")))
    c = ck["ck_emu_first"]
    c.to_json(root / "ck_emu_first.json")
    cases.pipeline_case("ckpt_kill", str(root / "ck_emu_first.json"))
    jobs.append(("ckpt_resume", "ckpt_resume",
                 str(root / "ck_emu_first.json")))
    cfgs["ckpt"] = (ck["ck_mesh_first"], ck["ck_emu_first"], ref)

    spec = root / "spec.json"
    cases.write_spec(spec, pipeline=jobs)
    codes = cases.launch_worlds({WORLD: spec}, out)
    errs = "\n".join(f.read_text() for f in sorted(out.glob("*.err")))
    assert codes[WORLD] == [0] * WORLD, (codes, errs)
    return cfgs, out


def _close(a, b, what, tol=1e-12):
    nb = np.linalg.norm(b)
    assert a.shape == b.shape and np.isfinite(a).all(), what
    assert np.linalg.norm(a - b) <= tol * max(nb, 1e-300), (
        what, np.linalg.norm(a - b) / max(nb, 1e-300))


def _within(a, b, limit, what):
    scale = max(np.abs(b).max(), 1e-300)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= limit * scale, (
        what, np.abs(a - b).max() / scale)


@pytest.mark.parametrize("name", ["stage1", "stage4_lstm", "stage4_expfit"])
def test_stage_under_mesh_matches_emulation_and_savtpu(runs, name):
    cfgs, _ = runs
    tm, te, jc = cfgs[name]
    art = "dynamics_h5" if name == "stage1" else "modeled_h5"
    js = JStore(jc.workdir, jc.model_dir, jc.surrogate.run_tag())
    n_sync = jc.surrogate.i_cri + 1
    for r in range(WORLD):
        a = t_load(getattr(_tstore(tm), art)(r))
        b = t_load(getattr(_tstore(te), art)(r))
        c = j_load(getattr(js, art)(r))
        _close(a, b, (name, r, "vs emulation"),
               MESH_TOL.get(name, 1e-12))
        _within(a, c, LIMITS[name], (name, r, "vs savtpu shard_map"))
        if name != "stage1":
            # the warm-up rows are the exchanged run's
            _within(a[:, :n_sync], c[:, :n_sync], LIMITS["stage1"],
                    (name, r, "warm-up"))


def test_stage_logs_are_rank_zeros(runs):
    """Rank 0 alone writes the run log, with every rank's seconds."""
    cfgs, _ = runs
    tm = cfgs["stage1"][0]
    recs = [json.loads(line) for line in
            open(_tstore(tm).workdir / "metrics.jsonl")]
    s1 = [r for r in recs if r["event"] == "stage1_solve"]
    setup = [r for r in recs if r["event"] == "setup_breakdown"]
    assert len(s1) == 1 and len(setup) == 1
    assert s1[0]["world"] == WORLD and len(s1[0]["rank_seconds"]) == WORLD
    assert setup[0]["backend"] == "gloo"


def test_checkpoint_written_under_mesh_resumes_emulated(runs):
    cfgs, out = runs
    tm, _, ref = cfgs["ckpt"]
    with np.load(out / "ckpt_kill.npz") as z:
        assert int(z["step"]) == 40
    data_prepare.run(tm, verbose=False, device="cpu", resume=True)
    assert not _tstore(tm).ckpt_dir("stage1").exists()
    for r in range(WORLD):
        _close(t_load(_tstore(tm).dynamics_h5(r)),
               t_load(_tstore(ref).dynamics_h5(r)), r)


def test_emulated_checkpoint_resumes_under_mesh(runs):
    cfgs, _ = runs
    _, te, ref = cfgs["ckpt"]
    assert not _tstore(te).ckpt_dir("stage1").exists()
    for r in range(WORLD):
        _close(t_load(_tstore(te).dynamics_h5(r)),
               t_load(_tstore(ref).dynamics_h5(r)), r)
