"""Stage 3: per-rank surrogate fitting (port of the ``arch="expfit"``
branch of ``savtpu/pipeline/model_training.py``).

Two-segment matrix-pencil system identification per rank
(models/expfit.py): host float64, milliseconds per rank, no epochs and no
device. The LSTM, linear and hybrid surrogates wait for a later slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..config import Config
from ..io.artifacts import ArtifactStore, load_displacement, save_params
from ..models.expfit import eval_expfit, fit_expfit
from ..models.modal import modal_basis, to_modal
from ..utils import stage_log


def _stage1_dt(cfg: Config) -> float:
    """Timestep of the recorded trace, from the stage-1 metrics.jsonl
    event — stage 3 re-derives everything from stored artifacts."""
    p = Path(cfg.workdir) / "metrics.jsonl"
    dt = None
    if p.exists():
        for line in p.read_text().splitlines():
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ev.get("event") == "stage1_solve" and "dt" in ev:
                dt = float(ev["dt"])
    if dt is None:
        raise FileNotFoundError(
            f"arch='expfit' needs the stage-1 dt from {p} "
            f"(event stage1_solve) — run stage 1 first"
        )
    return dt


def _fit_rank(cfg: Config, store: ArtifactStore, r: int, dt: float):
    sur = cfg.surrogate
    se = max(int(cfg.solver.save_every), 1)
    ramp_s = float(sur.expfit_ramp_s or 0.0)
    trace = load_displacement(store.shared_dof_h5(r)).T  # (T, D)
    T, D = trace.shape
    cut = int(sur.cut_off * T)
    modal_meta = {}
    co = trace
    if sur.modal_dim:
        mu, basis = modal_basis(trace[:cut], sur.modal_dim)
        modal_meta = {
            "modal_dim": int(basis.shape[0]),
            "modal_phys_size": int(D),
            "modal_mean": mu.tolist(),
            "modal_basis": basis.tolist(),
        }
        co = to_modal(trace, mu, basis)
    C = co.shape[1]
    ramp_end_row = (ramp_s / (dt * se)) if ramp_s > 0 else 0.0
    params, info = fit_expfit(co[:cut], ramp_end_row, order=sur.expfit_order)
    # held-out check within the training contract: refit on the first 80%
    # of the cut rows, score on the last 20%
    cut8 = int(0.8 * cut)
    p8, _ = fit_expfit(co[:cut8], ramp_end_row, order=sur.expfit_order)
    val = eval_expfit(p8, np.arange(cut8, cut, dtype=float), ramp_end_row)
    denom = float(np.linalg.norm(co[cut8:cut])) or 1.0
    val_rel = float(np.linalg.norm(val - co[cut8:cut]) / denom)
    fit_full = eval_expfit(params, np.arange(cut, dtype=float), ramp_end_row)
    fit_rel = float(
        np.linalg.norm(fit_full - co[:cut])
        / (float(np.linalg.norm(co[:cut])) or 1.0)
    )
    save_params(
        store.model_file(r),
        params,
        meta={
            **modal_meta,
            "arch": "expfit",
            "input_size": int(C),
            "real_input_size": int(C),
            "padded_input": False,
            "expfit_order": int(sur.expfit_order),
            "expfit_modes": int(info["n_modes"]),
            "expfit_ramp_end_row": float(ramp_end_row),
            "expfit_has_post_segment": bool(info["has_post_segment"]),
            "save_every": int(se),
            "n_past": sur.n_past,
            "n_future": sur.n_future,
            "filter_size": sur.filter_size,
            "cut_off": sur.cut_off,
            "final_train_loss": fit_rel,
            "final_val_r2": 1.0 - val_rel**2,
        },
    )
    return params, fit_rel, val_rel, int(C), int(cut), ramp_end_row, info


def run(cfg: Config, n_parts: int | None = None, verbose: bool = True):
    if cfg.surrogate.arch != "expfit":
        raise NotImplementedError(
            f"surrogate.arch {cfg.surrogate.arch!r} is not ported yet; "
            "the port trains arch='expfit'"
        )
    store = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    n_parts = n_parts or cfg.partition.n_parts
    dt = _stage1_dt(cfg)
    log = stage_log(cfg)
    results = {}
    for r in range(n_parts):
        params, fit_rel, val_rel, C, cut, ramp_end_row, info = _fit_rank(
            cfg, store, r, dt
        )
        if verbose:
            print(
                f"[model_training] rank {r}: expfit {info['n_modes']} "
                f"modes, train rel {fit_rel:.2e}, held-out rel "
                f"{val_rel:.2e}"
            )
        if not info["has_post_segment"] and ramp_end_row < cut and r == 0:
            print(
                "[model_training] WARNING: expfit post-ramp training "
                f"rows ({int(cut - ramp_end_row)}) < 4*order — frozen-"
                "ramp fallback in use; raise surrogate.cut_off or run "
                "more steps for a proper two-segment fit"
            )
        results[r] = (params, {"fit_rel": fit_rel, "val_rel": val_rel})
        log.log(
            "stage3_train_rank", rank=r, arch="expfit", input_size=C,
            n_modes=int(info["n_modes"]), fit_rel=fit_rel, val_rel=val_rel,
        )
    return results
