"""Stage 5: truth-vs-predicted comparison (port of
``savtpu/pipeline/plotter.py``).

Per rank, the rel-L2 error of the sync-avoiding trajectory against the
exchanged one over all non-shared DOFs, in the window of stored rows from
``start`` on, plus the size-fair global rel-L2 and the most dynamic
non-shared node; written to ``comparison_metrics.json``. The figure
(``Comparison.pdf``) is drawn by :func:`write_comparison_pdf`, which
imports matplotlib when called; ``run`` does not call it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..config import Config
from ..io.artifacts import ArtifactStore, load_displacement
from ..utils import stage_log


def nonshared_dof_mask(local_nodes, shared):
    shared_set = set(int(s) for s in shared)
    keep_nodes = np.array(
        [int(g) not in shared_set for g in local_nodes], dtype=bool
    )
    return np.repeat(keep_nodes, 3)


def _rank_data(store: ArtifactStore, r: int):
    exact = load_displacement(store.dynamics_h5(r)).T     # (T, 3n)
    pred = load_displacement(store.modeled_h5(r)).T
    T = min(len(exact), len(pred))
    local_nodes = store.load_int_csv(store.local_nodes_csv(r))
    shared = store.load_int_csv(store.shared_csv(r))
    return exact[:T], pred[:T], local_nodes, nonshared_dof_mask(
        local_nodes, shared
    )


def run(cfg: Config, n_parts: int | None = None, start: int = 2000,
        verbose: bool = True):
    store = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    n_parts = n_parts or cfg.partition.n_parts
    metrics = {}
    err_tot = ref_tot = 0.0
    for r in range(n_parts):
        exact, pred, _, keep = _rank_data(store, r)
        T = len(exact)
        win = slice(min(start, T - 1), T)
        diff = exact[win][:, keep] - pred[win][:, keep]
        err_sq = float(np.sum(diff * diff))
        ref_sq = float(np.sum(exact[win][:, keep] ** 2))
        metrics[f"rank_{r}_rel_l2_nonshared"] = float(
            np.sqrt(err_sq) / max(np.sqrt(ref_sq), 1e-30)
        )
        # size-fair global metric: every DOF weighted by its amplitude
        err_tot += err_sq
        ref_tot += ref_sq
        metrics["global_rel_l2_nonshared"] = float(
            np.sqrt(err_tot) / max(np.sqrt(ref_tot), 1e-30)
        )
        amp = np.abs(exact[win]).max(axis=0)
        amp[~keep] = -1.0
        metrics[f"rank_{r}_tracked_local_node"] = int(np.argmax(amp)) // 3
    Path(cfg.workdir).mkdir(parents=True, exist_ok=True)
    (Path(cfg.workdir) / "comparison_metrics.json").write_text(
        json.dumps(metrics, indent=2)
    )
    stage_log(cfg).log("stage5_metrics", **metrics)
    if verbose:
        print(f"[plotter] metrics: {metrics}")
    return metrics


def write_comparison_pdf(cfg: Config, metrics: dict,
                         n_parts: int | None = None, start: int = 2000):
    """Overlay exact and modeled (dx, dy, dz) of each rank's tracked node
    into ``Comparison.pdf`` (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    store = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    n_parts = n_parts or cfg.partition.n_parts
    fig, axes = plt.subplots(1, n_parts, figsize=(7 * n_parts, 5),
                             squeeze=False)
    for r in range(n_parts):
        exact, pred, local_nodes, _ = _rank_data(store, r)
        T = len(exact)
        node = metrics[f"rank_{r}_tracked_local_node"]
        ax = axes[0][r]
        t_axis = np.arange(start, T)
        for c, lbl in enumerate("xyz"):
            ax.plot(t_axis, exact[start:T, 3 * node + c], lw=1.4,
                    label=f"exact d{lbl}")
            ax.plot(t_axis, pred[start:T, 3 * node + c], lw=0.9, ls="--",
                    label=f"model d{lbl}")
        ax.set_title(
            f"rank {r} (node {int(local_nodes[node])}, relL2="
            f"{metrics[f'rank_{r}_rel_l2_nonshared']:.2e})"
        )
        ax.set_xlabel("step")
        ax.legend(fontsize=7)
    out = Path(cfg.workdir) / "Comparison.pdf"
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out
