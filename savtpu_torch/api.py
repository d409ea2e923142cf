"""High-level facade: the whole pipeline behind one object (port of
``savtpu/api.py``):

    from savtpu_torch import api
    sim = api.Simulation(cfg)          # CUDA; device="cpu" for the CPU
    sim.generate_data()      # stage 1 (+ steady solve artifact)
    sim.extract_shared()     # stage 2
    sim.train()              # stage 3 (LSTM or expfit)
    sim.run_online()         # stage 4 (sync-avoiding run)
    metrics = sim.compare()  # stage 5 (rel-L2 metrics)
    # or: metrics = sim.run_all()
    sim.solver()             # the ShardedSolver (exchanged / comm-free runs)
    sim.steady()             # the steady displacement (P1, or P2 alone)

Under a device mesh (``device_mesh=parallel.make_device_mesh()``, the
same calls on every rank) stages 1 and 4 run on every rank, each over its
block of parts, and stages 2, 3 and 5 on rank 0; every stage ends at a
barrier, and ``compare`` returns rank 0's metrics on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from .config import Config
from .pipeline import (
    data_prepare,
    model_training,
    online_predictor,
    plotter,
    shared_extraction,
)
from .pipeline.common import StageContext, build_context
from .solvers import setup_problem, steady_displacement
from .utils import resolve_device


class Simulation:
    def __init__(self, cfg: Optional[Config] = None, device=None,
                 dtype=None, verbose: bool = True, device_mesh=None):
        self.cfg = cfg or Config()
        self.verbose = verbose
        self._device = device
        self._dtype = dtype
        self._mesh = device_mesh
        self._ctx: Optional[StageContext] = None

    @property
    def ctx(self) -> StageContext:
        if self._ctx is None:
            self._ctx = build_context(self.cfg, dtype=self._dtype,
                                      device=self._device,
                                      device_mesh=self._mesh)
        return self._ctx

    @property
    def is_root(self) -> bool:
        """Whether this process runs stages 2, 3 and 5 (rank 0 under a
        mesh)."""
        return self._mesh is None or self._mesh.get_local_rank() == 0

    def _done(self):
        """The end of a stage: under a mesh, every rank waits for all."""
        if self._mesh is not None:
            dist.barrier(group=self._mesh.get_group())
        return self

    def generate_data(self):
        data_prepare.run(self.cfg, ctx=self.ctx, verbose=self.verbose)
        return self._done()

    def extract_shared(self):
        if self.is_root:
            shared_extraction.run(self.cfg)
        return self._done()

    def train(self):
        if self.is_root:
            model_training.run(self.cfg, verbose=self.verbose,
                               device=self._device)
        return self._done()

    def run_online(self):
        online_predictor.run(self.cfg, ctx=self.ctx, verbose=self.verbose)
        return self._done()

    def compare(self) -> Dict:
        metrics = [plotter.run(self.cfg, verbose=self.verbose)
                   if self.is_root else None]
        if self._mesh is not None:
            group = self._mesh.get_group()
            dist.broadcast_object_list(
                metrics, src=dist.get_global_rank(group, 0), group=group)
        return metrics[0]

    def run_all(self) -> Dict:
        return (
            self.generate_data()
            .extract_shared()
            .train()
            .run_online()
            .compare()
        )

    # ---- direct solver access ----
    def solver(self):
        """The underlying ShardedSolver (exchanged / sync-avoiding runs)."""
        return self.ctx.solver

    def steady(self) -> np.ndarray:
        """Steady displacement vector (K d = F with the clamped face).
        Supports deg=1 and the steady-only deg=2 path (which has no
        sharded context); the dense route solves on the run's device."""
        if self.cfg.solver.deg == 2:
            return steady_displacement(setup_problem(self.cfg),
                                       device=resolve_device(self._device))
        return steady_displacement(self.ctx.prob, device=self.ctx.device)
