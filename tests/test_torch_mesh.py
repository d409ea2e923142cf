"""The port's device mesh (``torch.distributed``, gloo ranks on the CPU)
against savtpu's ``shard_map`` on the 8 virtual CPU devices of
tests/conftest.py and against the port's emulation, with the same inputs.

Each case of tests/torch_mesh_cases.py mirrors one of savtpu's shard_map
tests:
- ``shard_map_matches_emulation``, ``multiple_parts_per_device``,
  ``save_every_in_scan`` (its shard_map leg), ``permute`` (with the
  ``permute_refused`` ValueError): tests/test_sharded.py:126, :184, :286,
  :389;
- ``compensated``: tests/test_compensated.py:119;
- ``grid_dense``, ``grid_stencil_compensated`` (with ``grid_refused``)
  and ``grid_tube``: tests/test_grid_exchange.py:147 and :181;
- ``stencil_faces``: tests/test_stencil_faces.py:146 (the port has no
  face-plane layout: its stencil runs the same comm-free block through
  the generic gather);
- ``tube_stencil``: tests/test_tube_stencil.py:247;
- ``online_kernel``: tests/test_online_kernel.py:149 (K3, whose plain
  version the port runs on the CPU);
and the ``one_rank_*`` cases hold a one-rank mesh to the emulation bit for
bit. Every world (1, 2, 4 and 8 ranks) runs once per module, all its cases
in one set of rank processes (tests/torch_mesh_worker.py), one torch
thread each.

Tolerance: float64, the norm of the difference within 1e-12 of the norm
of the reference, as savtpu's own mesh tests; the ranks differ from the
emulation only in the order of the sums (a rank's batched products and
the all-reduce) and from savtpu in that and the matvec's order.

The float32 case (``float32_online_kernel``, ROADMAP C1) is held to
float32's own envelope instead: with chip_smoke.py's measure
(``max_rel``: the largest |a - b| of a part over b's largest, the largest
over the parts), its departure from the float32 emulation (a) and from a
float64 run of the same problem (c) are each at most ENVELOPE times the
float32 emulation's own departure from that float64 run (b). On its 8x4x4
beam in 8 parts some shared DOFs have 4 owners, so the all-reduce adds
ranks' partial sums in another order than the emulation; where no DOF has
more than 2 owners the float32 ranks give the emulation's bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from savtpu.config import Config as JConfig
from savtpu.mesh import tube_mesh as j_tube
from savtpu.parallel import (
    ShardedProblem as JShardedProblem,
    build_partition_maps as j_maps,
    make_device_mesh as j_mesh,
)
from savtpu.parallel.sharded import ShardedSolver as JSolver
from savtpu.solvers import setup_problem as j_setup

import torch_mesh_cases as cases

torch.set_num_threads(1)

TOL = 1e-12
# (a) and (c) of the float32 case against (b): up to 1.8 measured at 300
# to 1,200 steps (the two float32 runs round independently)
ENVELOPE = 3.0
F32 = [n for n, c in cases.SOLVER_CASES.items()
       if c[1]["dtype"] == "float32"]
MULTI = [n for n, c in cases.SOLVER_CASES.items()
         if c[0] > 1 and n not in F32]
ONE = [n for n, c in cases.SOLVER_CASES.items() if c[0] == 1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's cases run over gloo ranks; returns the output
    directory (one <case>.npz each)."""
    out = tmp_path_factory.mktemp("mesh")
    by_world = {}
    for name, (world, _, _) in cases.SOLVER_CASES.items():
        by_world.setdefault(world, dict(solver=[]))["solver"].append(name)
    for name, (world, _, _) in cases.REFUSED_CASES.items():
        by_world.setdefault(world, dict(solver=[])).setdefault(
            "refused", []).append(name)
    by_world.setdefault(2, dict(solver=[]))["fit"] = ["lstm", "linear"]
    by_world.setdefault(4, dict(solver=[]))["fit"] = ["linear"]
    by_world.setdefault(1, dict(solver=[]))["gates"] = True
    specs = {}
    for world, spec in by_world.items():
        specs[world] = out / f"spec{world}.json"
        cases.write_spec(specs[world], **spec)
    codes = cases.launch_worlds(specs, out)
    errs = "\n".join(f.read_text() for f in sorted(out.glob("*.err")))
    assert all(c == 0 for cs in codes.values() for c in cs), (codes, errs)
    return out


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    nb = np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= TOL * max(nb, 1e-300), (
        what, np.linalg.norm(a - b) / max(nb, 1e-300))


def _savtpu_problem(spec):
    """savtpu's problem of a spec, on the port's partition (the same
    mesh; the port's partitioner gives savtpu's parts, as
    tests/test_torch_stencil.py holds)."""
    from savtpu_torch.mesh import dirichlet_nodes
    from savtpu_torch.parallel import partition_elements

    cfg = JConfig()
    if spec["mesh"][0] == "beam":
        cfg.beam_cells, cfg.beam_extent = spec["mesh"][1:]
        prob = j_setup(cfg, dtype=jnp.float64)
    else:
        n_r, n_theta, n_z = spec["mesh"][1:]
        prob = j_setup(cfg, mesh=j_tube(n_r=n_r, n_theta=n_theta, n_z=n_z),
                       dtype=jnp.float64)
    m = prob.mesh
    ep = partition_elements(m.tetra, m.points, spec["parts"],
                            method=spec["method"])
    dn = dirichlet_nodes(m.triangles, m.points,
                         axis=spec.get("dirichlet_axis", 0))
    sp = JShardedProblem.build(prob, j_maps(m.tetra, ep, m.num_points, dn),
                               dtype=jnp.float64, **spec["build"])
    return prob, sp


def _savtpu_case(name, mesh_out):
    """savtpu's shard_map run of the case over ``world`` virtual devices,
    fed the predictions the ranks used."""
    world, spec, runs = cases.SOLVER_CASES[name]
    prob, sp = _savtpu_problem(spec)
    solver = JSolver(sp, mesh=j_mesh(world))
    d0, dn = sp.localize(prob.d0), sp.localize(prob.dn)
    out = {}
    for i, run in enumerate(runs):
        preds = mesh_out.get(f"{i}_preds")
        (traj, shared), carry = solver.run(
            d0, dn, 0.0, run["steps"], sync=run["sync"],
            preds=None if preds is None else jnp.asarray(preds),
            record=run["record"], save_every=run["save_every"])
        for k, v in (("traj", traj), ("shared", shared), ("d", carry[0]),
                     ("dn", carry[1])):
            if v is not None:
                out[f"{i}_{k}"] = np.asarray(v)
    return out


def _load(worlds, name):
    with np.load(worlds / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", MULTI)
def test_mesh_matches_emulation_and_savtpu_shard_map(worlds, name):
    if len(jax.devices()) < cases.SOLVER_CASES[name][0]:
        pytest.skip("needs the conftest's 8 virtual devices")
    got = _load(worlds, name)
    emu = cases.solver_case(name)
    assert set(got) == set(emu)
    for k in emu:
        if not k.endswith("_t"):
            _close(got[k], emu[k], f"{k} vs emulation")
    ref = _savtpu_case(name, got)
    for k in ref:
        _close(got[k], ref[k], f"{k} vs savtpu shard_map")


@pytest.mark.parametrize("name", F32)
def test_float32_mesh_lies_inside_the_float32_envelope(worlds, name):
    got = _load(worlds, name)
    e32 = cases.solver_case(name)
    e64 = cases.solver_case(name, dtype="float64")
    assert set(got) == set(e32) == set(e64)
    for k in e32:
        if k.endswith(("_t", "_preds")):
            continue
        assert got[k].dtype == e32[k].dtype == np.float32, k
        a = cases.max_rel(got[k], e32[k])
        b = cases.max_rel(e32[k], e64[k])
        c = cases.max_rel(got[k], e64[k])
        if k == "1_shared":
            # the comm-free block's shared rows are the predictions,
            # overwritten on every rank alike
            assert a == 0.0 and 0.0 < b < 1e-6, (a, b)
            continue
        assert 0.0 < b < 1e-5, (k, b)
        assert a <= ENVELOPE * b and c <= ENVELOPE * b, (k, a, b, c)


@pytest.mark.parametrize("name", ONE)
def test_one_rank_mesh_is_emulation_bit_for_bit(worlds, name):
    got = _load(worlds, name)
    emu = cases.solver_case(name)
    assert set(got) == set(emu)
    for k in emu:
        np.testing.assert_array_equal(got[k], emu[k], err_msg=k)


@pytest.mark.parametrize("name", list(cases.REFUSED_CASES))
def test_refusals_are_savtpus_word_for_word(worlds, name):
    world, spec, match = cases.REFUSED_CASES[name]
    msg = str(_load(worlds, name)["message"])
    assert match in msg
    _, sp = _savtpu_problem(spec)
    with pytest.raises(ValueError) as e:
        JSolver(sp, mesh=j_mesh(world))
    assert msg == str(e.value)


def test_k2_and_k4_are_refused_under_a_mesh(worlds):
    g = _load(worlds, "gates")
    assert bool(g["k2_emulated"]) and bool(g["k4_emulated"])
    assert not bool(g["k2_mesh"]) and not bool(g["k4_mesh"])


def test_make_device_mesh_spans_every_rank(worlds):
    g = _load(worlds, "gates")
    assert list(g["mesh"]) == [1, 1] and str(g["axis"]) == "parts"
    assert "the mesh spans every rank" in str(g["n_devices_error"])


def test_fit_stacked_under_mesh_equals_unsharded(worlds):
    """Two ranks of two models each train what the unsharded fit trains
    (the draws are made for all models on every rank), and the gathered
    history is the unsharded one."""
    got = _load(worlds, "fit_stacked")
    ref = cases.fit_case()
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], k)


def test_linear_fit_under_mesh_is_the_unsharded_fit(worlds):
    """arch="linear" under a mesh: every rank fits all P maps on the host
    and keeps its block, so over 2 and 4 ranks the blocks joined in rank
    order are the unsharded fit's maps bit for bit, and each rank's
    history covers all P (rank 0's is kept)."""
    ref = cases.fit_case(arch="linear")
    assert ref["param.lin.W"].shape[0] == cases.FIT_MODELS
    assert ref["hist.train_loss"].shape == (1, cases.FIT_MODELS)
    for world in (2, 4):
        got = _load(worlds, cases.fit_name("linear", world))
        assert set(got) == set(ref), world
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg=f"{k}, {world} ranks")
