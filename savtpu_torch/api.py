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
"""

from __future__ import annotations

from typing import Dict, Optional

from .config import Config
from .pipeline import (
    data_prepare,
    model_training,
    online_predictor,
    plotter,
    shared_extraction,
)
from .pipeline.common import StageContext, build_context


class Simulation:
    def __init__(self, cfg: Optional[Config] = None, device=None,
                 dtype=None, verbose: bool = True):
        self.cfg = cfg or Config()
        self.verbose = verbose
        self._device = device
        self._dtype = dtype
        self._ctx: Optional[StageContext] = None

    @property
    def ctx(self) -> StageContext:
        if self._ctx is None:
            self._ctx = build_context(self.cfg, dtype=self._dtype,
                                      device=self._device)
        return self._ctx

    def generate_data(self):
        data_prepare.run(self.cfg, ctx=self.ctx, verbose=self.verbose)
        return self

    def extract_shared(self):
        shared_extraction.run(self.cfg)
        return self

    def train(self):
        model_training.run(self.cfg, verbose=self.verbose,
                           device=self._device)
        return self

    def run_online(self):
        online_predictor.run(self.cfg, ctx=self.ctx, verbose=self.verbose)
        return self

    def compare(self) -> Dict:
        return plotter.run(self.cfg, verbose=self.verbose)

    def run_all(self) -> Dict:
        return (
            self.generate_data()
            .extract_shared()
            .train()
            .run_online()
            .compare()
        )
