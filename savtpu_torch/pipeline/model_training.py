"""Stage 3: per-rank surrogate training (port of
``savtpu/pipeline/model_training.py``).

Every surrogate the JAX package trains:
- ``arch="lstm"`` (the default), stacked: every rank's model in one
  :func:`~savtpu_torch.models.training.fit_stacked` pass on the device,
  on windows padded to the widest rank and scaled per rank, widened to
  ``ensemble`` members per rank; or per rank (``stacked=False``, or one
  part): :func:`~savtpu_torch.models.training.fit` on the rank's own
  windows, with mixed teacher forcing and dropout where configured;
- ``arch="linear"``: the closed-form ridge map (models/linear.py), its
  lambda chosen by closed-loop replays of the training sequences,
  stacked or per rank;
- ``arch="expfit"``: two-segment matrix-pencil system identification per
  rank (models/expfit.py), host float64, milliseconds per rank;
- ``arch="hybrid"``: an expfit base per rank in its modal subspace, and
  stacked LSTMs trained on the residual mode coefficients.

Each rank's model and a JSON sidecar with the architecture and the
training scaling constants (which stage 4 recomputes and checks) go to
``{model_dir}/Rank-<r>/<tag>/``, beside the training curves.

    python -m savtpu_torch.pipeline.model_training [--config cfg.json]
        [--epochs N] [--grid-batch-sizes B ...] [--grid-lrs LR ...]
        [--grid-hidden H ...] [--device cpu]

Runs on CUDA unless ``--device`` says otherwise. Any ``--grid-*`` flag
runs :func:`run_grid`: every (n_B, eta0, n_H) combination trains into its
own run-tag directory, the flags left out held at the config's values.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path
from typing import Dict

import numpy as np

from ..config import Config
from ..io.artifacts import ArtifactStore, load_displacement, save_params
from ..models.data import scale_to_zero_one, strided_windows, train_val_split
from ..models.expfit import eval_expfit, fit_expfit
from ..models.modal import modal_basis, to_modal
from ..utils import resolve_device, stage_log


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


def _cl_seqs(trace, smax, smin, sur, eff_filter, n_phases=3):
    """Scaled coarse-grid sequences of the training portion (the
    trace[:cut_off][::eff_filter] grid the windows come from), a few phase
    offsets of it, for the linear surrogate's closed-loop ridge selection
    (models/linear.py ``fit_linear``)."""
    cut = np.asarray(trace)[: int(sur.cut_off * len(trace))]
    s = (cut - smax) / (smax - smin)
    return [s[p::eff_filter] for p in range(min(n_phases, eff_filter))]


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


def _lstm_meta(sur) -> Dict:
    """The sidecar keys every LSTM-trained artifact carries."""
    return {
        "hidden_size": sur.hidden_size,
        "num_layers_encoder": sur.num_layers_encoder,
        "bidirectional": sur.bidirectional,
        "target_mode": getattr(sur, "target_mode", "absolute"),
        "n_past": sur.n_past,
        "n_future": sur.n_future,
        "rollout_windows": sur.rollout_windows,
        "filter_size": sur.filter_size,
        "cut_off": sur.cut_off,
    }


def _scale_meta(sur, smax, smin) -> Dict:
    per_feature = sur.scale_mode == "per_feature"
    return {
        "scale_mode": sur.scale_mode,
        "scale_max": np.asarray(smax).tolist() if per_feature
        else float(smax),
        "scale_min": np.asarray(smin).tolist() if per_feature
        else float(smin),
    }


def _modal_meta(D, mu, basis) -> Dict:
    return {
        "modal_dim": int(basis.shape[0]),
        "modal_phys_size": int(D),
        "modal_mean": mu.tolist(),
        "modal_basis": basis.tolist(),
    }


def _fit_stats(stats: Dict, model) -> Dict:
    """The timing fields of a stage-3 log event."""
    if not stats:
        return {"device": str(next(model.parameters()).device)}
    return {
        "adam_steps": stats["adam_steps"],
        "capture_s": round(stats["capture_s"], 3),
        "train_s": round(stats["train_s"], 3),
        "graph_replay": stats["replay"],
        "device": str(next(model.parameters()).device),
    }


def _padded_windows(traces, dims, sur, eff_filter):
    """Each rank's windows padded to the widest rank and scaled per rank
    after the padding (the convention stage 4 feeds the models with):
    (Xp (P, G, n_p, Dmax), Yp, fm (P, Dmax), smaxs, smins, G)."""
    n_parts = len(traces)
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
        Xp[r, :, :, : dims[r]] = Xs[r][:G]
        Yp[r, :, :, : dims[r]] = Ys[r][:G]
        Xp[r] = (Xp[r] - smaxs[r]) / (smaxs[r] - smins[r])
        Yp[r] = (Yp[r] - smaxs[r]) / (smaxs[r] - smins[r])
        fm[r, : dims[r]] = 1.0
    return Xp, Yp, fm, smaxs, smins, G


def run(cfg: Config, n_parts: int | None = None, verbose: bool = True,
        device=None):
    """Train every rank's surrogate; LSTMs on ``device`` (CUDA unless the
    caller asks for the CPU). Returns {rank: (params, history)}."""
    sur = cfg.surrogate
    store = ArtifactStore(cfg.workdir, cfg.model_dir, sur.run_tag())
    n_parts = n_parts or cfg.partition.n_parts
    if sur.arch == "expfit":
        return _run_expfit(cfg, store, n_parts, verbose)
    if sur.arch == "hybrid":
        return _run_hybrid(cfg, store, n_parts, verbose, device)
    if sur.arch not in ("lstm", "linear"):
        raise ValueError(f"unknown surrogate.arch {sur.arch!r}")
    stacked = sur.stacked if sur.stacked is not None else n_parts > 1
    if stacked:
        return _run_stacked(cfg, store, n_parts, verbose, device)
    return _run_per_rank(cfg, store, n_parts, verbose, device)


def _run_expfit(cfg: Config, store: ArtifactStore, n_parts: int,
                verbose: bool):
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


def _run_per_rank(cfg: Config, store: ArtifactStore, n_parts: int,
                  verbose: bool, device):
    """One model per rank on its own unpadded windows (``stacked=False``,
    or one part): an LSTM through ``fit`` (mixed teacher forcing and
    dropout where configured), or a ridge map with its closed-loop
    ladder. Each rank's split is ``default_rng(seed + 17 r)``'s, the JAX
    package's."""
    from ..models.training import fit

    sur = cfg.surrogate
    eff_filter = effective_filter(cfg)
    log = stage_log(cfg)
    results = {}
    for r in range(n_parts):
        trace = load_displacement(store.shared_dof_h5(r)).T  # (T, D)
        modal_meta = {}
        if sur.modal_dim:
            n_train = int(sur.cut_off * len(trace))
            mu, basis = modal_basis(trace[:n_train], sur.modal_dim)
            modal_meta = _modal_meta(trace.shape[1], mu, basis)
            trace = to_modal(trace, mu, basis)
        input_size = trace.shape[1]
        X, Y, X0, Y0 = _phase_windows(trace, sur, eff_filter)
        _, _, smax, smin = scale_to_zero_one(X0, Y0, mode=sur.scale_mode)
        X = np.asarray((X - smax) / (smax - smin))
        Y = np.asarray((Y - smax) / (smax - smin))
        rng = np.random.default_rng(sur.seed + 17 * r)
        tr, va = train_val_split(len(X), sur.train_portion, rng)
        if verbose:
            print(
                f"[model_training] rank {r}: input_size={input_size}, "
                f"{len(tr)} train / {len(va)} val windows, "
                f"{sur.epochs} epochs"
            )
        seqs = (_cl_seqs(trace, smax, smin, sur, eff_filter)
                if sur.arch == "linear" else None)
        fit_stats = {}
        t0 = time.perf_counter()
        model, hist = fit(
            sur, X[tr], Y[tr], X[va], Y[va], device=device,
            log_every=50 if verbose else 0,
            log_fn=lambda m, r=r: print(f"[rank {r}] {m}"), stats=fit_stats,
            seqs=seqs,
        )
        seconds = time.perf_counter() - t0
        params = {k: v[0] for k, v in model.arrays().items()}
        store.save_training_curves(r, hist)
        final_val = hist["val_r2"][-1] if hist["val_r2"] else None
        save_params(
            store.model_file(r),
            params,
            meta={
                **modal_meta,
                "arch": sur.arch,
                "window_phases": int(getattr(sur, "window_phases", 1) or 1),
                "input_size": int(input_size),
                **_lstm_meta(sur),
                **_scale_meta(sur, smax, smin),
                "final_train_loss": hist["train_loss"][-1],
                "final_val_r2": final_val,
            },
        )
        results[r] = (params, hist)
        log.log(
            "stage3_train_rank",
            rank=r,
            arch=sur.arch,
            input_size=int(input_size),
            epochs=sur.epochs if sur.arch == "lstm" else 1,
            seconds=round(seconds, 3),
            final_train_loss=hist["train_loss"][-1],
            final_val_r2=final_val,
            **({"ridge_lambda": hist["ridge_lambda"]}
               if "ridge_lambda" in hist else {}),
            **_fit_stats(fit_stats, model),
        )
    return results


def _run_stacked(cfg: Config, store: ArtifactStore, n_parts: int,
                 verbose: bool, device):
    """All ranks' models in one stacked pass: raw windows padded to the
    widest rank, each rank's [-1, 0] scaling applied after the padding
    (the convention stage 4 feeds the models with), masked recursive
    decode, or P closed-form ridge fits for ``arch="linear"``. A seed
    ensemble widens the model axis E-fold (member e of rank r at e*P +
    r), so each member trains from its own initial draw and split on the
    same windows; its artifacts hold (E, ...) member stacks. Each rank's
    artifacts keep the per-rank layout; the sidecar records the
    padding."""
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
    Xp, Yp, fm, smaxs, smins, G = _padded_windows(traces, dims, sur,
                                                  eff_filter)

    if verbose:
        print(
            f"[model_training] stacked: {n_parts} shards, Dmax={Dmax}, "
            f"{G} windows each, {sur.epochs} epochs"
        )
    log = (lambda s: print(f"[stacked] {s}")) if verbose else (lambda s: None)
    seqs = None
    if sur.arch == "linear":
        # padded, scaled and masked coarse sequences of the training
        # portion, in the windows' convention, for the ridge ladder
        seqs = []
        for r in range(n_parts):
            cut = np.asarray(traces[r])[: int(sur.cut_off * len(traces[r]))]
            pad = np.zeros((len(cut), Dmax))
            pad[:, : dims[r]] = cut
            s = ((pad - smaxs[r]) / (smaxs[r] - smins[r])) * fm[r]
            seqs.append([s[p::eff_filter] for p in range(min(3, eff_filter))])

    E = int(getattr(sur, "ensemble", 1) or 1)
    if E > 1 and sur.arch != "lstm":
        raise ValueError("surrogate.ensemble requires arch='lstm'")
    tile = (lambda a: np.concatenate([a] * E)) if E > 1 else (lambda a: a)
    fit_stats = {}
    t0 = time.perf_counter()
    model, hist = fit_stacked(
        sur, tile(Xp), tile(Yp), tile(fm), device=device,
        log_every=50 if verbose else 0, log_fn=log, stats=fit_stats,
        seqs=seqs,
    )
    seconds = time.perf_counter() - t0
    stage_log(cfg).log(
        "stage3_train_stacked",
        shards=n_parts,
        ensemble=E,
        arch=sur.arch,
        input_size=int(Dmax),
        windows=int(G),
        epochs=sur.epochs if sur.arch == "lstm" else 1,
        seconds=round(seconds, 3),
        final_train_loss=[float(x) for x in hist["train_loss"][-1]],
        final_val_r2=[float(x) for x in hist["val_r2"][-1]],
        **({"ridge_lambda": hist["ridge_lambda"][0].tolist()}
           if "ridge_lambda" in hist else {}),
        **_fit_stats(fit_stats, model),
    )

    arrays = model.arrays()
    results = {}
    for r in range(n_parts):
        if E > 1:
            idx = [e * n_parts + r for e in range(E)]
            params_r = {k: v[idx] for k, v in arrays.items()}
        else:
            params_r = {k: v[r] for k, v in arrays.items()}
        hist_r = {k: hist[k][:, r].tolist() for k in hist}
        store.save_training_curves(r, hist_r)
        modal_meta = {}
        if modal:
            modal_meta = _modal_meta(phys_dims[r], modal_mus[r],
                                     modal_bases[r])
        save_params(
            store.model_file(r),
            params_r,
            meta={
                **modal_meta,
                "arch": sur.arch,
                "ensemble": E,
                "window_phases": int(getattr(sur, "window_phases", 1) or 1),
                "input_size": int(Dmax),
                "real_input_size": int(dims[r]),
                "padded_input": True,
                **_lstm_meta(sur),
                **_scale_meta(sur, smaxs[r], smins[r]),
                "final_train_loss": hist_r["train_loss"][-1],
                "final_val_r2": hist_r["val_r2"][-1],
            },
        )
        results[r] = (params_r, hist_r)
    return results


def _run_hybrid(cfg: Config, store: ArtifactStore, n_parts: int,
                verbose: bool, device):
    """arch="hybrid": expfit base + LSTM residual.

    Per rank, the modal basis of the training portion and the
    matrix-pencil fit of its mode coefficients carry the bulk of the
    interface motion open-loop in time; the residual ``co - base`` over
    the whole trace is what the stacked LSTMs train on (padded to the
    widest rank and scaled per rank, as ``_run_stacked``). Online, the
    block is base(t) + LSTM(residual history), so the LSTM's drift acts on
    the residual amplitude only. Requires modal_dim > 0."""
    from ..models.training import fit_stacked

    sur = cfg.surrogate
    if not sur.modal_dim:
        raise ValueError("arch='hybrid' requires surrogate.modal_dim > 0")
    dt = _stage1_dt(cfg)
    se = max(int(cfg.solver.save_every), 1)
    ramp_s = float(getattr(sur, "expfit_ramp_s", 1.0) or 0.0)
    ramp_end_row = (ramp_s / (dt * se)) if ramp_s > 0 else 0.0
    eff_filter = effective_filter(cfg)

    res_traces, modal_metas, exp_params, exp_metas, dims = [], [], [], [], []
    for r in range(n_parts):
        trace = load_displacement(store.shared_dof_h5(r)).T  # (T, D)
        T, D = trace.shape
        cut = int(sur.cut_off * T)
        mu, basis = modal_basis(trace[:cut], sur.modal_dim)
        co = to_modal(trace, mu, basis)
        params_e, info = fit_expfit(co[:cut], ramp_end_row,
                                    order=sur.expfit_order)
        base = eval_expfit(params_e, np.arange(T, dtype=float), ramp_end_row)
        res = co - base
        fit_rel = float(np.linalg.norm(res[:cut])
                        / (float(np.linalg.norm(co[:cut])) or 1.0))
        if verbose:
            print(
                f"[model_training] rank {r}: hybrid expfit "
                f"{info['n_modes']} modes, residual/signal {fit_rel:.2e}"
            )
        res_traces.append(res)
        dims.append(res.shape[1])
        modal_metas.append(_modal_meta(D, mu, basis))
        exp_params.append(params_e)
        exp_metas.append({
            "expfit_order": int(sur.expfit_order),
            "expfit_modes": int(info["n_modes"]),
            "expfit_ramp_end_row": float(ramp_end_row),
            "expfit_has_post_segment": bool(info["has_post_segment"]),
            "expfit_residual_rel": fit_rel,
        })

    Kmax = max(dims)
    Xp, Yp, fm, smaxs, smins, G = _padded_windows(res_traces, dims, sur,
                                                  eff_filter)
    if verbose:
        print(
            f"[model_training] hybrid stacked residual LSTM: {n_parts} "
            f"shards, K={Kmax}, {G} windows each, {sur.epochs} epochs"
        )
    log = (lambda s: print(f"[hybrid] {s}")) if verbose else (lambda s: None)
    fit_stats = {}
    t0 = time.perf_counter()
    model, hist = fit_stacked(
        sur, Xp, Yp, fm, device=device, log_every=50 if verbose else 0,
        log_fn=log, stats=fit_stats,
    )
    seconds = time.perf_counter() - t0
    stage_log(cfg).log(
        "stage3_train_hybrid",
        shards=n_parts,
        input_size=int(Kmax),
        windows=int(G),
        epochs=sur.epochs,
        seconds=round(seconds, 3),
        residual_rel=[m["expfit_residual_rel"] for m in exp_metas],
        expfit_has_post_segment=[m["expfit_has_post_segment"]
                                 for m in exp_metas],
        final_train_loss=[float(x) for x in hist["train_loss"][-1]],
        final_val_r2=[float(x) for x in hist["val_r2"][-1]],
        **_fit_stats(fit_stats, model),
    )

    arrays = model.arrays()
    results = {}
    for r in range(n_parts):
        lstm_r = {k: v[r] for k, v in arrays.items()}
        hist_r = {k: hist[k][:, r].tolist() for k in hist}
        store.save_training_curves(r, hist_r)
        params_r = {"expfit": exp_params[r], "lstm": lstm_r}
        save_params(
            store.model_file(r),
            params_r,
            meta={
                **modal_metas[r],
                **exp_metas[r],
                "arch": "hybrid",
                "window_phases": int(getattr(sur, "window_phases", 1) or 1),
                "input_size": int(Kmax),
                "real_input_size": int(dims[r]),
                "padded_input": True,
                **_lstm_meta(sur),
                "save_every": int(se),
                **_scale_meta(sur, smaxs[r], smins[r]),
                "final_train_loss": hist_r["train_loss"][-1],
                "final_val_r2": hist_r["val_r2"][-1],
            },
        )
        results[r] = (params_r, hist_r)
    return results


def run_grid(cfg: Config, batch_sizes, learning_rates, hidden_sizes,
             verbose: bool = True, device=None):
    """Hyper-parameter grid over (n_B, eta0, n_H), the reference's triple
    loop: each combination trains into its own run-tag directory
    (``config.run_tag``, e.g. 'nB-10-nH-50-Lr-0.0005-filter=150'), so
    stage 4 picks any combination by setting the same surrogate fields.
    Returns {(n_B, eta0, n_H): run's result}."""
    results = {}
    for nB in batch_sizes:
        for lr in learning_rates:
            for nH in hidden_sizes:
                c = copy.deepcopy(cfg)
                c.surrogate.batch_size = int(nB)
                c.surrogate.learning_rate = float(lr)
                c.surrogate.hidden_size = int(nH)
                if verbose:
                    print(f"[model_training] grid: {c.surrogate.run_tag()}")
                results[(nB, lr, nH)] = run(c, verbose=verbose,
                                            device=device)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="savtpu_torch stage 3: model "
                                             "training")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--grid-batch-sizes", type=int, nargs="+", default=None,
                    help="n_B grid (reference Model_training.py:19)")
    ap.add_argument("--grid-lrs", type=float, nargs="+", default=None,
                    help="eta0 grid (Model_training.py:20)")
    ap.add_argument("--grid-hidden", type=int, nargs="+", default=None,
                    help="n_H grid (Model_training.py:21)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.epochs:
        cfg.surrogate.num_epochs = args.epochs
    device = resolve_device(args.device)
    if args.grid_batch_sizes or args.grid_lrs or args.grid_hidden:
        run_grid(
            cfg,
            args.grid_batch_sizes or [cfg.surrogate.batch_size],
            args.grid_lrs or [cfg.surrogate.learning_rate],
            args.grid_hidden or [cfg.surrogate.hidden_size],
            device=device,
        )
        return
    run(cfg, device=device)


if __name__ == "__main__":
    main()
