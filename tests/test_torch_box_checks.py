"""chip_smoke.py's structured-box checks at test size, and the
graph-replayed stepper in the matrix-free modes.

Each check of phase 2 (the Neo-Hookean stencil force against the
incident-list force, the grid exchange against psum over 200 steps, the
linear stencil against the dense K d, float64 within 1e-12, each with a
control that must be rejected) runs here on the CPU and, in its ``gpu``
leg, with the card's side on the card; at 8x4x4/16, whose boxes split
all three axes. The chunked stepper equals the eager loop bit for bit in
the Neo-Hookean and linear stencil modes with the grid exchange: on the
CPU a chunk's body runs directly, on the card (``gpu``) it replays a
captured CUDA graph. The module imports neither JAX nor savtpu, so on the
card it runs as ``python -m pytest --noconftest -m gpu
tests/test_torch_box_checks.py``; the ``gpu`` legs skip where no CUDA
device is present.
"""

import itertools
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

from savtpu_torch.ops.material import NeoHookean  # noqa: E402
from savtpu_torch.parallel import ShardedProblem  # noqa: E402

torch.set_num_threads(1)

SIZE = (8, 4, 4)
DEVICES = [pytest.param("cpu", id="cpu"),
           pytest.param("cuda", id="cuda", marks=pytest.mark.gpu)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA device: this leg runs on the card")
    return torch.device(name)


@pytest.mark.parametrize("dev", DEVICES)
def test_nh_stencil_vs_incident(dev):
    res = chip_smoke.check_nh_stencil_vs_cpu(_device(dev), sizes=(SIZE,))
    assert not res["failures"], res


@pytest.mark.parametrize("dev", DEVICES)
def test_grid_vs_psum(dev):
    res = chip_smoke.check_grid_vs_psum(_device(dev), cells=SIZE)
    assert res["grid_pdims"] == (4, 2, 2)
    assert not res["failures"], res


@pytest.mark.parametrize("dev", DEVICES)
def test_lin_stencil_vs_dense(dev):
    res = chip_smoke.check_lin_stencil_vs_dense(_device(dev), sizes=(SIZE,))
    assert not res["failures"], res


def _flat(out):
    (traj, shared), carry = out
    return [x for x in (traj, shared, *carry) if x is not None]


@pytest.mark.parametrize("dev", DEVICES)
@pytest.mark.parametrize("fint_mode,compensated", [
    ("nh", False), ("nh", True), ("stencil", True)])
def test_chunked_stepper_equals_eager(dev, fint_mode, compensated):
    """The chunked stepper (graph replays on the card) against the eager
    loop, bit for bit, with the grid exchange: sync on and off,
    predictions on and off, every recording, save_every 1 and 5, over two
    full chunks and a remainder, in float32."""
    dev = _device(dev)
    prob, maps, cell = chip_smoke.box_setup(SIZE)
    prob = prob.with_dtype(torch.float32)
    mat = NeoHookean.from_engineering(**chip_smoke.NH_MAT)
    sp = ShardedProblem.build(
        prob, maps, fint_mode=fint_mode, exchange_mode="grid",
        compensated=compensated,
        material=mat if fint_mode == "nh" else None, device=dev)
    steps = 25
    d0 = sp.localize(chip_smoke.strained(prob, cell))
    preds = torch.zeros((sp.n_parts, steps, sp.sld.shape[1]),
                        dtype=sp.dtype, device=dev) + 1e-4 * sp.smask[:, None]
    t0 = torch.tensor(0.05, dtype=sp.dtype, device=dev)
    for sync, use_preds, record, se in itertools.product(
            (True, False), (False, True), ("all", "shared", "none"), (1, 5)):
        kw = dict(sync=sync, preds=preds if use_preds else None,
                  record=record, save_every=se)
        a = _flat(sp._stacked_run_eager(d0, d0, t0, steps, **kw))
        b = _flat(sp._stacked_run_chunked(d0, d0, t0, steps, graph_steps=10,
                                          **kw))
        for x, y in zip(a, b):
            assert torch.equal(x, y), (sync, use_preds, record, se)


def test_chunk_cache_keys_by_modes():
    """A cached chunk is never replayed for another fint or exchange mode:
    after a problem's mode changes in place, the stepper makes a new
    chunk, and its result is the new mode's."""
    prob, maps, cell = chip_smoke.box_setup(SIZE)
    sp = ShardedProblem.build(prob, maps, fint_mode="stencil",
                              exchange_mode="grid", device="cpu")
    d0 = sp.localize(chip_smoke.strained(prob, cell))
    t0 = torch.tensor(0.0, dtype=sp.dtype)
    kw = dict(sync=True, preds=None, record="traj", save_every=1)
    sp._stacked_run_chunked(d0, d0, t0, 10, **kw)
    n = len(sp._graphs)
    sp.exchange_mode = "psum"
    psum = _flat(sp._stacked_run_chunked(d0, d0, t0, 10, **kw))
    assert len(sp._graphs) == n + 1
    for x, y in zip(psum, _flat(sp._stacked_run_eager(d0, d0, t0, 10,
                                                      **kw))):
        assert torch.equal(x, y)
