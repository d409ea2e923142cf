"""End-to-end pipeline runner (port of ``savtpu/pipeline/run_all.py``):

    python -m savtpu_torch.pipeline.run_all --config cfg.json [--device cpu]

Stages: data_prepare -> shared_extraction -> model_training ->
online_predictor -> plotter. Runs on CUDA unless ``--device`` says
otherwise; the state dtype is cfg.solver.dtype.
"""

from __future__ import annotations

import argparse

from ..config import Config
from . import (
    data_prepare,
    model_training,
    online_predictor,
    plotter,
    shared_extraction,
)
from .common import build_context


def run(cfg: Config, verbose: bool = True, device=None, dtype=None):
    ctx = build_context(cfg, dtype=dtype, device=device)
    data_prepare.run(cfg, ctx=ctx, verbose=verbose)
    shared_extraction.run(cfg)
    model_training.run(cfg, verbose=verbose, device=ctx.device)
    online_predictor.run(cfg, ctx=ctx, verbose=verbose)
    return plotter.run(cfg, verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser(description="savtpu_torch full pipeline")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--parts", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.steps:
        cfg.solver.num_steps = args.steps
    if args.parts:
        cfg.partition.n_parts = args.parts
    run(cfg, device=args.device)


if __name__ == "__main__":
    main()
