"""The port's graph-replayed stepper (``ShardedProblem._stacked_run_chunked``,
``parallel/sharded.py``) against its eager loop.

On the card ``stacked_run`` replays its step loop from captured CUDA
graphs, in chunks of G steps planned by ``graph_chunks``. The chunk logic
(static state copied in and back, each chunk's rows of the predictions,
its trajectory and shared rows copied out, a remainder chunk, the cache
by length) is the same on the CPU, where a chunk's body runs directly
instead of replaying: there it must give the eager loop's bits exactly.

The ``gpu`` legs run the graph path on the card against the eager loop,
bit for bit, and check that the kernel counts add the captured launches
at every replay; they skip where no CUDA device is present. The module
imports neither JAX nor savtpu, so on the card it runs as ``python -m
pytest --noconftest -m gpu tests/test_torch_graphs.py``.
"""

import itertools

import numpy as np
import pytest
import torch

from savtpu_torch.ops.dense_step import batched_fint_matvec
from savtpu_torch.parallel.sharded import GRAPH_STEPS, graph_chunks

torch.set_num_threads(1)


@pytest.mark.parametrize("num_steps,save_every,max_steps,expect", [
    (1000, 50, 100, (100, 10, 0)),   # run_streamed's probe chunk, stage 1
    (3000, 50, 100, (100, 30, 0)),   # a stage-4 block
    (250, 5, 100, (100, 2, 50)),     # a remainder chunk
    (25, 5, 10, (10, 2, 5)),
    (30, 1, 100, (30, 1, 0)),        # shorter than one chunk
    (2000, 1, 100, (100, 20, 0)),    # the sweep's runs
    (300, 150, 100, (150, 2, 0)),    # save_every above the chunk cap
    (7, 7, 3, (7, 1, 0)),
])
def test_graph_chunk_plan(num_steps, save_every, max_steps, expect):
    """G is a multiple of save_every of at most max_steps (at least
    save_every), never longer than the run; full chunks and a remainder
    chunk, itself a multiple of save_every, cover the run."""
    G, n_full, rem = graph_chunks(num_steps, save_every, max_steps)
    assert (G, n_full, rem) == expect
    assert G % save_every == 0 and rem % save_every == 0
    assert G * n_full + rem == num_steps and 0 <= rem < G


@pytest.mark.parametrize("num_steps,save_every", [(0, 1), (12, 5), (-5, 5)])
def test_graph_chunk_plan_rejects(num_steps, save_every):
    with pytest.raises(ValueError, match="multiple of save_every"):
        graph_chunks(num_steps, save_every, GRAPH_STEPS)


def _problem(mode, compensated, device="cpu", dtype=torch.float64,
             cells=(8, 1, 1), parts=2):
    from savtpu_torch.benchmarks.sweep import build_case

    return build_case(*cells, parts, mode, compensated=compensated,
                      device=device, dtype=dtype)[1]


def _inputs(sp, steps, seed=0):
    """A seeded state near the ramp's start and seeded predictions."""
    rng = np.random.default_rng(seed)
    P, DL, S3 = sp.n_parts, sp.DL, sp.sld.shape[1]
    T = lambda a: torch.as_tensor(a, dtype=sp.dtype).to(sp.device)  # noqa
    d0 = T(1e-3 * rng.standard_normal((P, DL))) * sp.dof_mask
    dn = d0 - T(1e-6 * rng.standard_normal((P, DL))) * sp.dof_mask
    preds = T(1e-4 * rng.standard_normal((P, steps, S3))) * sp.smask[:, None]
    return d0, dn, T(0.05), preds


def _flat(out):
    (traj, shared), carry = out
    return [x for x in (traj, shared, *carry) if x is not None]


FLAGS = list(itertools.product(
    (False, True), ("all", "shared", "none"), (1, 5)))


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("fint_mode", ["pallas", "dense", "banded"])
def test_chunked_stepper_equals_eager_on_cpu(fint_mode, compensated, sync):
    """25 steps in chunks of 10 (two full chunks and a remainder) give the
    eager loop's outputs bit for bit, with and without predictions, for
    every recording and save_every 1 and 5."""
    sp = _problem(fint_mode, compensated)
    d0, dn, t0, preds = _inputs(sp, 25)
    for use_preds, record, se in FLAGS:
        kw = dict(sync=sync, preds=preds if use_preds else None,
                  record=record, save_every=se)
        a = _flat(sp._stacked_run_eager(d0, dn, t0, 25, **kw))
        b = _flat(sp._stacked_run_chunked(d0, dn, t0, 25, graph_steps=10,
                                          **kw))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y), (
                use_preds, record, se)


def test_chunks_are_cached_by_length():
    """Chunks of the same length and flags are made once: a second run,
    and a run of another length that shares the chunk length, add
    nothing; a new remainder length adds one chunk."""
    sp = _problem("pallas", False)
    d0, dn, t0, _ = _inputs(sp, 1)
    kw = dict(sync=True, preds=None, record="all", save_every=5,
              graph_steps=10)
    sp._stacked_run_chunked(d0, dn, t0, 25, **kw)
    assert len(sp._graphs) == 2            # 10 and the 5-step remainder
    sp._stacked_run_chunked(d0, dn, t0, 25, **kw)
    sp._stacked_run_chunked(d0, dn, t0, 40, **kw)
    assert len(sp._graphs) == 2
    sp._stacked_run_chunked(d0, dn, t0, 35, **kw)
    sp._stacked_run_chunked(d0, dn, t0, 5, **{**kw, "record": "none"})
    assert len(sp._graphs) == 3            # record="none" is its own chunk


def test_run_carry_does_not_alias_the_chunks():
    """A run's carry and recordings are the caller's own: a later run
    through the same chunks leaves them as they were."""
    sp = _problem("pallas", False)
    d0, dn, t0, _ = _inputs(sp, 1)
    kw = dict(sync=True, preds=None, record="all", save_every=1,
              graph_steps=10)
    out = _flat(sp._stacked_run_chunked(d0, dn, t0, 20, **kw))
    kept = [x.clone() for x in out]
    sp._stacked_run_chunked(out[2], out[3], out[4], 20, **kw)
    for x, y in zip(out, kept):
        assert torch.equal(x, y)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph path runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("fint_mode", ["pallas", "banded"])
def test_cuda_graph_stepper_equals_eager(fint_mode, compensated):
    """On the card: stacked_run (graph replays) against the eager loop,
    bit for bit, sync on and off, predictions on and off, every recording,
    save_every 1 and 5, over two full chunks and a remainder."""
    dev = _card()
    sp = _problem(fint_mode, compensated, device=dev, dtype=torch.float32,
                  cells=(12, 2, 2), parts=4)
    d0, dn, t0, preds = _inputs(sp, 25)
    for sync, (use_preds, record, se) in itertools.product(
            (True, False), FLAGS):
        kw = dict(sync=sync, preds=preds if use_preds else None,
                  record=record, save_every=se)
        a = _flat(sp._stacked_run_eager(d0, dn, t0, 25, **kw))
        b = _flat(sp._stacked_run_chunked(d0, dn, t0, 25, graph_steps=10,
                                          **kw))
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y), (sync, use_preds, record, se)


@pytest.mark.gpu
def test_cuda_graph_counts_replayed_launches():
    """K1 launched from graph replays counts one launch per step that ran,
    as the eager loop does; building a chunk counts nothing."""
    dev = _card()
    sp = _problem("pallas", False, device=dev, dtype=torch.float32,
                  cells=(12, 2, 2), parts=4)
    d0, dn, t0, _ = _inputs(sp, 1)
    for steps in (250, 250, 30):
        before = batched_fint_matvec.launches
        sp.stacked_run(d0, dn, t0, steps, sync=True, record="none")
        torch.cuda.synchronize()
        assert batched_fint_matvec.launches - before == steps
    before = batched_fint_matvec.launches
    sp._stacked_run_eager(d0, dn, t0, 7, sync=False, preds=None,
                          record="none", save_every=1)
    assert batched_fint_matvec.launches - before == 7
