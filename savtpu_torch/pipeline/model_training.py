"""Stage 3: per-rank surrogate training (port of
``savtpu/pipeline/model_training.py``).

Two surrogates are ported:
- ``arch="lstm"`` (the default), trained stacked: every rank's model in
  one :func:`~savtpu_torch.models.training.fit_stacked` pass on the
  device, on windows padded to the widest rank and scaled per rank;
- ``arch="expfit"``: two-segment matrix-pencil system identification per
  rank (models/expfit.py), host float64, milliseconds per rank.

Each rank's model and a JSON sidecar with the architecture and the
training scaling constants (which stage 4 recomputes and checks) go to
``{model_dir}/Rank-<r>/<tag>/``, beside the training curves. Not ported
yet: the per-rank (unstacked) LSTM fit with mixed teacher forcing and
dropout, ``ensemble > 1``, and the linear and hybrid surrogates.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..config import Config
from ..io.artifacts import ArtifactStore, load_displacement, save_params
from ..models.data import scale_to_zero_one, strided_windows
from ..models.expfit import eval_expfit, fit_expfit
from ..models.modal import modal_basis, to_modal
from ..utils import stage_log


def effective_filter(cfg: Config) -> int:
    """Window stride in stored-trace rows. Stage 1 stores one row every
    ``save_every`` steps, so striding the stored trace by
    ``filter_size // save_every`` reads exactly the rows at step
    multiples of filter_size — the same training windows as a
    save_every=1 run (the reference trains on data[::n_s])."""
    se = cfg.solver.save_every
    n_s = cfg.surrogate.filter_size
    if se > 1 and n_s % se:
        raise ValueError(
            f"surrogate.filter_size ({n_s}) must be a multiple of "
            f"solver.save_every ({se}) so training windows land on stored "
            f"rows"
        )
    return max(n_s // se, 1)


def _phase_windows(trace, sur, eff_filter):
    """Training windows, optionally augmented over coarse-grid phase
    offsets (SurrogateConfig.window_phases). Phase 0 comes first, and the
    scaling constants come from its windows alone (X0, Y0)."""
    X, Y = strided_windows(
        trace, sur.n_past, sur.n_future * sur.rollout_windows,
        eff_filter, sur.cut_off,
    )
    phases = min(max(int(getattr(sur, "window_phases", 1) or 1), 1),
                 eff_filter)
    if phases <= 1:
        return X, Y, X, Y
    Xa, Ya = [X], [Y]
    for p in range(1, phases):
        Xp, Yp = strided_windows(
            trace[p:], sur.n_past, sur.n_future * sur.rollout_windows,
            eff_filter, sur.cut_off,
        )
        Xa.append(Xp)
        Ya.append(Yp)
    return np.concatenate(Xa), np.concatenate(Ya), X, Y


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


def run(cfg: Config, n_parts: int | None = None, verbose: bool = True,
        device=None):
    """Train every rank's surrogate; LSTMs on ``device`` (CUDA unless the
    caller asks for the CPU). Returns {rank: (params, history)}."""
    sur = cfg.surrogate
    store = ArtifactStore(cfg.workdir, cfg.model_dir, sur.run_tag())
    n_parts = n_parts or cfg.partition.n_parts
    if sur.arch == "lstm":
        stacked = sur.stacked if sur.stacked is not None else n_parts > 1
        if not stacked:
            raise NotImplementedError(
                "the per-rank (unstacked) LSTM fit is not ported yet; "
                "train with surrogate.stacked=True and n_parts > 1")
        if int(sur.ensemble or 1) > 1:
            raise NotImplementedError(
                "surrogate.ensemble > 1 is not ported yet")
        return _run_stacked(cfg, store, n_parts, verbose, device)
    if sur.arch != "expfit":
        raise NotImplementedError(
            f"surrogate.arch {sur.arch!r} is not ported yet; the port "
            "trains arch='lstm' and arch='expfit'"
        )
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


def _run_stacked(cfg: Config, store: ArtifactStore, n_parts: int,
                 verbose: bool, device):
    """All ranks' LSTMs in one stacked training pass: raw windows padded
    to the widest rank, each rank's [-1, 0] scaling applied after the
    padding (the convention stage 4 feeds the models with), masked
    recursive decode. Each rank's artifacts keep the per-rank layout; the
    sidecar records the padding."""
    import time

    from ..models.training import fit_stacked

    sur = cfg.surrogate
    eff_filter = effective_filter(cfg)
    traces, dims = [], []
    for r in range(n_parts):
        tr = load_displacement(store.shared_dof_h5(r)).T  # (T, Dr)
        traces.append(tr)
        dims.append(tr.shape[1])

    # modal-subspace representation (SurrogateConfig.modal_dim): each
    # rank's k PCA-mode coefficients, the basis from the training
    # (cut_off) portion only
    modal = int(sur.modal_dim or 0)
    modal_mus, modal_bases = [], []
    phys_dims = dims
    if modal:
        for r in range(n_parts):
            n_train = int(sur.cut_off * len(traces[r]))
            mu, basis = modal_basis(traces[r][:n_train], modal)
            modal_mus.append(mu)
            modal_bases.append(basis)
            traces[r] = to_modal(traces[r], mu, basis)
        dims = [t.shape[1] for t in traces]
    Dmax = max(dims)

    per_feature = sur.scale_mode == "per_feature"
    Xs, Ys, smaxs, smins = [], [], [], []
    for tr in traces:
        X, Y, X0, Y0 = _phase_windows(tr, sur, eff_filter)
        _, _, smax, smin = scale_to_zero_one(X0, Y0, mode=sur.scale_mode)
        if per_feature:
            # pad to (Dmax,) with (0, -1): raw-zero pad dims stay 0 scaled
            fmax = np.zeros(Dmax)
            fmin = np.full(Dmax, -1.0)
            fmax[: X.shape[-1]] = smax
            fmin[: X.shape[-1]] = smin
            smax, smin = fmax, fmin
        Xs.append(X)
        Ys.append(Y)
        smaxs.append(smax)
        smins.append(smin)

    G = min(x.shape[0] for x in Xs)
    Xp = np.zeros((n_parts, G, sur.n_past, Dmax))
    Yp = np.zeros((n_parts, G, sur.n_future * sur.rollout_windows, Dmax))
    fm = np.zeros((n_parts, Dmax))
    for r in range(n_parts):
        # pad raw windows, then scale the whole padded array per rank
        Xp[r, :, :, : dims[r]] = Xs[r][:G]
        Yp[r, :, :, : dims[r]] = Ys[r][:G]
        Xp[r] = (Xp[r] - smaxs[r]) / (smaxs[r] - smins[r])
        Yp[r] = (Yp[r] - smaxs[r]) / (smaxs[r] - smins[r])
        fm[r, : dims[r]] = 1.0

    if verbose:
        print(
            f"[model_training] stacked: {n_parts} shards, Dmax={Dmax}, "
            f"{G} windows each, {sur.epochs} epochs"
        )
    log = (lambda s: print(f"[stacked] {s}")) if verbose else (lambda s: None)
    fit_stats = {}
    t0 = time.perf_counter()
    model, hist = fit_stacked(
        sur, Xp, Yp, fm, device=device, log_every=50 if verbose else 0,
        log_fn=log, stats=fit_stats,
    )
    seconds = time.perf_counter() - t0
    stage_log(cfg).log(
        "stage3_train_stacked",
        shards=n_parts,
        input_size=int(Dmax),
        windows=int(G),
        epochs=sur.epochs,
        seconds=round(seconds, 3),
        final_train_loss=[float(x) for x in hist["train_loss"][-1]],
        final_val_r2=[float(x) for x in hist["val_r2"][-1]],
        adam_steps=fit_stats["adam_steps"],
        capture_s=round(fit_stats["capture_s"], 3),
        train_s=round(fit_stats["train_s"], 3),
        graph_replay=fit_stats["replay"],
        device=str(next(model.parameters()).device),
    )

    arrays = model.arrays()
    results = {}
    for r in range(n_parts):
        params_r = {k: v[r] for k, v in arrays.items()}
        hist_r = {k: hist[k][:, r].tolist() for k in hist}
        store.save_training_curves(r, hist_r)
        modal_meta = {}
        if modal:
            modal_meta = {
                "modal_dim": int(dims[r]),
                "modal_phys_size": int(phys_dims[r]),
                "modal_mean": modal_mus[r].tolist(),
                "modal_basis": modal_bases[r].tolist(),
            }
        save_params(
            store.model_file(r),
            params_r,
            meta={
                **modal_meta,
                "arch": sur.arch,
                "ensemble": 1,
                "window_phases": int(getattr(sur, "window_phases", 1) or 1),
                "input_size": int(Dmax),
                "real_input_size": int(dims[r]),
                "padded_input": True,
                "hidden_size": sur.hidden_size,
                "num_layers_encoder": sur.num_layers_encoder,
                "bidirectional": sur.bidirectional,
                "target_mode": getattr(sur, "target_mode", "absolute"),
                "n_past": sur.n_past,
                "n_future": sur.n_future,
                "rollout_windows": sur.rollout_windows,
                "filter_size": sur.filter_size,
                "cut_off": sur.cut_off,
                "scale_mode": sur.scale_mode,
                "scale_max": (
                    smaxs[r].tolist() if per_feature else smaxs[r]
                ),
                "scale_min": (
                    smins[r].tolist() if per_feature else smins[r]
                ),
                "final_train_loss": hist_r["train_loss"][-1],
                "final_val_r2": hist_r["val_r2"][-1],
            },
        )
        results[r] = (params_r, hist_r)
    return results
