"""Stage 2: extract the shared-DOF displacement traces (port of
``savtpu/pipeline/shared_extraction.py``, serial): per rank, map the
shared global node ids to local DOF rows using only the stage-1 CSV
artifacts, and save those rows of the stored history.

    python -m savtpu_torch.pipeline.shared_extraction [--config cfg.json]
        [--device cpu]

The stage is host work; ``--device`` (CUDA by default) is checked as in
every stage's command line, so a run never takes the CPU unasked."""

from __future__ import annotations

import argparse

import numpy as np

from ..config import Config
from ..io.artifacts import ArtifactStore, load_displacement, save_displacement
from ..utils import resolve_device, stage_log


def shared_dof_indices(local_nodes: np.ndarray, shared: np.ndarray) -> np.ndarray:
    """Interleaved DOF rows of the shared nodes inside the local DOF
    vector."""
    lookup = {int(g): i for i, g in enumerate(local_nodes)}
    loc = np.array([lookup[int(g)] for g in shared], dtype=np.int64)
    return (3 * loc[:, None] + np.arange(3)[None, :]).reshape(-1)


def run(cfg: Config, n_parts: int | None = None):
    store = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    n_parts = n_parts or cfg.partition.n_parts
    sizes = []
    for r in range(n_parts):
        local_nodes = store.load_int_csv(store.local_nodes_csv(r))
        shared = store.load_int_csv(store.shared_csv(r))
        rows = shared_dof_indices(local_nodes, shared)
        data = load_displacement(store.dynamics_h5(r))
        save_displacement(store.shared_dof_h5(r), data[rows, :])
        sizes.append(len(rows))
    stage_log(cfg).log(
        "stage2_extract", ranks=n_parts, shared_dofs_per_rank=sizes
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description="savtpu_torch stage 2: shared "
                                             "extraction")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = Config.from_json(args.config) if args.config else Config()
    run(cfg)


if __name__ == "__main__":
    main()
