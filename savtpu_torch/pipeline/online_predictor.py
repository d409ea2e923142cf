"""Stage 4: the synchronization-avoiding run (port of
``savtpu/pipeline/online_predictor.py``).

Schedule: i_cri+1 = n_p*n_s synchronized steps (the exchanged stepper),
then blocks of n_f*n_s steps with NO exchange. Each block's shared DOFs
come from the ranks' surrogates, all ranks at once:
- ``arch="lstm"``: one phase-interleaved prediction of the stacked
  encoder-decoders (models/predictor.py) from the device-resident window
  of the last n_p*n_s shared rows, which every block then rolls forward
  by its own recorded shared rows;
- ``arch="expfit"``: the closed-form fit evaluated on the device from a
  small per-block pack of advanced amplitudes (models/expfit.py).
Then, as in the JAX package: owner consensus, smoothing
(``pred_smooth``), the exchanged anchor (``pred_anchor``), and the block
through ``ShardedProblem.stacked_run`` with full recording, which the
card replays from CUDA graphs (in banded compensated mode one launch of
the online kernel, ops/online_banded.py). A ragged last block takes the
first rows of a full block's LSTM prediction, or host float64 expfit
rows. Not ported yet: resync blocks, stage-4 checkpoints, seed
ensembles, and the per-rank fallback loop for ranks whose models do not
stack (unequal modal_dim, or unpadded models).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.artifacts import (
    load_displacement,
    load_params,
    load_params_meta,
    save_displacement,
)
from ..models.data import scale_to_zero_one, strided_windows
from ..models.expfit import advance_expfit, eval_expfit, eval_expfit_device
from ..models.lstm import StackedSeq2Seq
from ..models.modal import to_modal
from ..models.predictor import phase_interleaved_predict_stacked
from ..utils import stage_log, synchronize
from .common import (
    StageContext,
    build_context,
    rank_trajectory,
    save_partition_labels,
)
from .model_training import effective_filter

_SUR_DTYPES = {"float32": torch.float32, "float64": torch.float64,
               "bfloat16": torch.bfloat16}


@dataclass
class RankModel:
    params: Dict[str, np.ndarray]
    input_size: int
    modal: Optional[Tuple[np.ndarray, np.ndarray]]  # (mu (D,), basis (K, D))
    meta: Dict
    # the LSTM's scaling constants: floats ("joint") or (input_size,)
    smax: object = None
    smin: object = None


def _check_scaling(cfg: Config, store, r: int, meta: Dict, modal):
    """Recompute rank r's scaling constants from its stored stage-2 trace,
    as the reference's online stage does, and check them against the
    sidecar's (rtol 1e-10). Returns the sidecar's (smax, smin)."""
    sur = cfg.surrogate
    trace = load_displacement(store.shared_dof_h5(r)).T
    if modal is not None:
        trace = to_modal(trace, *modal)
    X, Y = strided_windows(
        trace, sur.n_past,
        sur.n_future * int(meta.get("rollout_windows", 1) or 1),
        effective_filter(cfg), sur.cut_off,
    )
    scale_mode = meta.get("scale_mode", "joint")
    _, _, smax, smin = scale_to_zero_one(X, Y, mode=scale_mode)
    meta_max = np.asarray(meta["scale_max"], dtype=np.float64)
    meta_min = np.asarray(meta["scale_min"], dtype=np.float64)
    D_real = X.shape[-1]
    if not np.allclose(np.asarray(smax).reshape(-1),
                       meta_max.reshape(-1)[:D_real], rtol=1e-10) or \
            not np.allclose(np.asarray(smin).reshape(-1),
                            meta_min.reshape(-1)[:D_real], rtol=1e-10):
        raise ValueError(
            f"rank {r}: scaling constants drifted between training and "
            f"online (mode={scale_mode})")
    return (meta_max if meta_max.ndim else float(meta_max),
            meta_min if meta_min.ndim else float(meta_min))


def load_rank_models(ctx: StageContext):
    """Per-rank surrogates from the stage-3 artifacts (params + JSON
    sidecar). An LSTM's scaling constants are recomputed from the stored
    trace and checked against the sidecar."""
    models = []
    for r in range(ctx.sp.n_parts):
        mf = ctx.store.model_file(r)
        if not mf.exists():
            raise FileNotFoundError(
                f"rank {r}: no trained surrogate at {mf} — run stage 3 "
                f"(savtpu_torch.pipeline.model_training) first"
            )
        meta = load_params_meta(mf)
        arch = meta.get("arch", "lstm")
        if arch not in ("expfit", "lstm"):
            raise NotImplementedError(
                f"rank {r}: surrogate arch {arch!r} is not ported yet; the "
                "port runs arch='lstm' and arch='expfit'"
            )
        if int(meta.get("ensemble", 1) or 1) > 1:
            raise NotImplementedError(
                f"rank {r}: seed ensembles are not ported yet")
        modal = None
        if meta.get("modal_dim"):
            modal = (
                np.asarray(meta["modal_mean"], dtype=np.float64),
                np.asarray(meta["modal_basis"], dtype=np.float64),
            )
        m = RankModel(load_params(mf), int(meta["input_size"]), modal, meta)
        if arch == "lstm":
            m.smax, m.smin = _check_scaling(ctx.cfg, ctx.store, r, meta,
                                            modal)
        models.append(m)
    return models


def prediction_consensus(preds: torch.Tensor, sp) -> torch.Tensor:
    """Average every owner rank's prediction of each duplicated shared DOF
    (SurrogateConfig.pred_consensus). preds (P, T, 3*S_max) -> same shape
    with all owners of a global shared DOF holding the same mean value.
    Owner contributions are added in (part, slot) order."""
    P, T, S3 = preds.shape
    pr = (preds * sp.smask[:, None, :]).permute(1, 0, 2).reshape(T, P * S3)
    pr = torch.cat([pr, pr.new_zeros((T, 1))], dim=1)
    g = pr[:, sp.owners]  # (T, SD, K)
    num = pr.new_zeros((T, sp.SD))
    for k in range(g.shape[2]):
        num = num + g[:, :, k]
    cnt = torch.clamp((sp.owners < P * S3).sum(dim=1), min=1).to(preds.dtype)
    avg = num / cnt
    out = avg[:, sp.sgi.reshape(-1)].reshape(T, P, S3)
    return out.permute(1, 0, 2)


def smooth_preds(preds, hist_tail, win):
    """Centered moving average (window ``win``) of the predicted block
    along time, continued from the recorded history at the block's front
    edge and reflect-padded at the back (SurrogateConfig.pred_smooth).
    preds (P, T, S3), hist_tail (P, >= win//2, S3). The block's rows come
    from filter_size independent phase models, so row-to-row jitter above
    the coarse-grid Nyquist is interleave noise the models cannot
    represent."""
    if int(win) <= 1:          # win=1 is the identity, not a 3-wide MA
        return preds
    h = max(1, int(win) // 2)
    w = 2 * h + 1
    front = hist_tail[:, -h:, :].to(preds.dtype)
    back = preds.flip(1)[:, :h, :]
    cs = torch.cumsum(torch.cat([front, preds, back], dim=1), dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    return (cs[:, w:] - cs[:, :-w]) / w


def anchor_block(sp, carry, preds):
    """``pred_anchor``: one exchanged step from the current carry gives
    the true interface response; the whole predicted block is de-biased
    by its step-0 discrepancy on the shared rows."""
    d0b, dnb, tb = carry
    F = sp._exchange(sp._fint_stacked(d0b))
    d1 = sp._update(d0b, dnb, tb, F)
    delta = (sp._gather_shared(d1) - preds[:, 0, :]) * sp.smask
    return preds + delta[:, None, :]


def modal_predict_stacked(model, hist, smaxv, sminv, sur, modal, fmaskv):
    """Stacked phase-interleaved block prediction with optional modal
    projection: physical history (P, W, S3) -> physical block (P, T, S3).
    ``modal`` is None or (mu (P, S3), basis (P, K, S3), coef_mask (P, K));
    the projection runs in the history's dtype, the models in theirs."""
    mdt = smaxv.dtype
    with torch.no_grad():
        if modal is None:
            return phase_interleaved_predict_stacked(
                model, hist.to(mdt), smaxv, sminv, sur.n_past, sur.n_future,
                sur.filter_size, feat_mask=fmaskv)
        mu, basis, fmc = modal
        histc = torch.einsum("pwd,pkd->pwk", hist - mu[:, None, :].to(
            hist.dtype), basis.to(hist.dtype))
        coefs = phase_interleaved_predict_stacked(
            model, histc.to(mdt), smaxv, sminv, sur.n_past, sur.n_future,
            sur.filter_size, feat_mask=fmc)
        return modal_reconstruct(coefs, (mu, basis), fmaskv)


def modal_reconstruct(coefs, modal, fmask):
    """(P, T, K) mode coefficients -> (P, T, S3) physical shared rows
    (``modal`` = (mu (P, S3), basis (P, K, S3)[, coef_mask]) or None when
    the coefficients are already physical, padded to S3)."""
    if modal is None:
        out = coefs
    else:
        mu, basis = modal[:2]
        out = (torch.einsum("ptk,pkd->ptd", coefs, basis.to(coefs.dtype))
               + mu[:, None, :].to(coefs.dtype))
    return out * fmask[:, None, :].to(out.dtype)


def _check_supported(cfg: Config) -> None:
    sur = cfg.surrogate
    for name, val in (
        ("surrogate.resync_blocks", sur.resync_blocks),
        ("solver.ckpt_every", cfg.solver.ckpt_every),
    ):
        if val:
            raise NotImplementedError(f"{name} is not ported yet")
    if sur.ensemble > 1:
        raise NotImplementedError("surrogate.ensemble > 1 is not ported yet")


class _ExpfitFeed:
    """arch="expfit": block predictions evaluated on the device from the
    advanced-amplitude packs (float32 leaves (P, ...), folded on the host
    in float64), and host float64 rows for a ragged tail."""

    def __init__(self, models, P, S3, Kfeed, modal_on, n_sync, block, dev):
        self.models, self.P, self.S3, self.Kfeed = models, P, S3, Kfeed
        self.modal_on, self.n_sync, self.block, self.dev = (
            modal_on, n_sync, block, dev)
        # per-rank (params, save_every, ramp_end_row) and the static pole
        # pack (padded with a decayed dummy pole z=0.5 of zero amplitude)
        self.ef = [
            (m.params, float(m.meta.get("save_every", 1) or 1),
             float(m.meta["expfit_ramp_end_row"]))
            for m in models
        ]
        M = max((len(p["z_re"]) for p, _, _ in self.ef), default=1) or 1
        z_re, z_im, se = np.full((P, M), 0.5), np.zeros((P, M)), np.ones(P)
        for r, (p, se_r, _) in enumerate(self.ef):
            z_re[r, : len(p["z_re"])] = p["z_re"]
            z_im[r, : len(p["z_im"])] = p["z_im"]
            se[r] = se_r
        self.M = M
        self.z_re, self.z_im, self.se = (self.to_dev(a)
                                         for a in (z_re, z_im, se))

    def to_dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.dev)

    def coefs(self, b: int):
        """Block b's (P, block, Kfeed) float32 coefficients."""
        P, K, M = self.P, self.Kfeed, self.M
        pk = {k: np.zeros((P, K) + ((M,) if k.startswith("a") else ()),
                          np.float32)
              for k in ("constA", "linA", "aA_re", "aA_im", "constB",
                        "aB_re", "aB_im")}
        pk["gap"] = np.zeros((P,), np.float32)
        step0 = self.n_sync + b * self.block
        for r, (p, se_r, ramp_r) in enumerate(self.ef):
            adv = advance_expfit(p, step0 / se_r, ramp_r)
            C_r, mr = adv["aA_re"].shape
            for k in ("constA", "linA", "constB"):
                pk[k][r, :C_r] = adv[k]
            for k in ("aA_re", "aA_im", "aB_re", "aB_im"):
                pk[k][r, :C_r, :mr] = adv[k]
            pk["gap"][r] = adv["gap"]
        pack = {k: self.to_dev(v) for k, v in pk.items()}
        return eval_expfit_device(pack, self.z_re, self.z_im, self.se,
                                  self.block)

    def host_rows(self, b: int, n: int) -> np.ndarray:
        """Physical (P, n, S3) float64 rows for n steps from block b."""
        steps = np.arange(self.n_sync + b * self.block,
                          self.n_sync + b * self.block + n, dtype=np.float64)
        out = np.zeros((self.P, n, self.S3))
        for r, m in enumerate(self.models):
            pr, se_r, ramp_r = self.ef[r]
            co = eval_expfit(pr, steps / se_r, ramp_r)
            if self.modal_on:
                mu, basis = m.modal
                out[r, :, : mu.shape[0]] = co[:, : basis.shape[0]] @ basis + mu
            else:
                out[r, :, : co.shape[1]] = co
        return out


def run(cfg: Config, ctx: StageContext | None = None, verbose: bool = True,
        device=None):
    _check_supported(cfg)
    if ctx is None:
        ctx = build_context(cfg, device=device)
    prob, sp, solver, store, maps = (
        ctx.prob, ctx.sp, ctx.solver, ctx.store, ctx.maps,
    )
    dev = ctx.device
    sur = cfg.surrogate
    save_partition_labels(ctx)
    models = load_rank_models(ctx)

    num_steps = cfg.solver.num_steps
    # runs shorter than the warm-up are all synchronized
    n_sync = min(sur.i_cri + 1, num_steps)
    block = sur.block_size
    P = sp.n_parts
    S3 = sp.sld.shape[1]
    sdt = sp.dtype
    fdt = _SUR_DTYPES[sur.dtype]
    hdt = _SUR_DTYPES[sur.hist_dtype or sur.dtype]
    W = sur.n_past * sur.filter_size
    archs = {m.meta.get("arch", "lstm") for m in models}
    if len(archs) > 1:
        raise ValueError(f"mixed surrogate arches across ranks: {archs}")
    lstm_on = archs == {"lstm"}
    if verbose:
        print(
            f"[online] {n_sync} synced + {num_steps - n_sync} comm-free "
            f"steps in blocks of {block} ({P} parts, device={dev})"
        )

    modal_on = P > 0 and all(m.modal is not None for m in models)
    if any(m.modal is not None for m in models) and not modal_on:
        raise ValueError("mixed modal and raw-channel surrogates across ranks")
    if modal_on and len({m.input_size for m in models}) != 1:
        raise NotImplementedError(
            "ranks with different modal_dim need the per-rank fallback "
            "path, which is not ported yet"
        )
    if lstm_on and not all(
            m.meta.get("padded_input", False)
            and (modal_on or m.input_size == S3) for m in models):
        raise NotImplementedError(
            "LSTM models that do not stack (unpadded, or narrower than "
            "the shared rows) need the per-rank fallback path, which is "
            "not ported yet")
    fmask_np = np.zeros((P, S3), dtype=np.float32)
    for r in range(P):
        fmask_np[r, : 3 * len(maps.shared_nodes[r])] = 1.0
    fmask = torch.as_tensor(fmask_np, dtype=fdt).to(dev)
    modal_pack = None
    Kfeed = S3
    if modal_on:
        Kfeed = models[0].input_size
        mu_np = np.zeros((P, S3))
        basis_np = np.zeros((P, Kfeed, S3))
        fmc = np.zeros((P, Kfeed))
        for r, m in enumerate(models):
            mu, basis = m.modal
            mu_np[r, : mu.shape[0]] = mu
            basis_np[r, : basis.shape[0], : mu.shape[0]] = basis
            fmc[r, : basis.shape[0]] = 1.0
        modal_pack = tuple(torch.as_tensor(a, dtype=fdt).to(dev)
                           for a in (mu_np, basis_np, fmc))

    if lstm_on:
        model = StackedSeq2Seq.from_arrays(
            {k: np.stack([m.params[k] for m in models])
             for k in models[0].params}, dtype=fdt, device=dev)
        smax_v = torch.as_tensor(np.array([m.smax for m in models]),
                                 dtype=fdt).to(dev)
        smin_v = torch.as_tensor(np.array([m.smin for m in models]),
                                 dtype=fdt).to(dev)

        def block_preds(b, hist):
            return modal_predict_stacked(model, hist, smax_v, smin_v, sur,
                                         modal_pack, fmask)
    else:
        feed = _ExpfitFeed(models, P, S3, Kfeed, modal_on, n_sync, block,
                           dev)

        def block_preds(b, hist):
            return modal_reconstruct(feed.coefs(b), modal_pack, fmask)

    def refine(preds, hist, carry):
        """Consensus, smoothing and the anchor, in the JAX package's
        order."""
        if sur.pred_consensus:
            preds = prediction_consensus(preds, sp)
        if sur.pred_smooth:
            preds = smooth_preds(preds, hist.to(sdt), sur.pred_smooth)
        if sur.pred_anchor:
            preds = anchor_block(sp, carry, preds)
        return preds

    # in-loop save_every stride when every segment length divides evenly
    se = cfg.solver.save_every
    se_run = (
        se if (num_steps % se == 0 and n_sync % se == 0 and block % se == 0)
        else 1
    )
    np_dtype = torch.empty((), dtype=sdt).numpy().dtype
    traj_full = np.empty((P, num_steps // se_run, sp.DL), dtype=np_dtype)
    rec_off = 0
    tprof = {"warmup_s": 0.0, "blocks_s": 0.0}

    def write_seg(arr):
        nonlocal rec_off
        a = arr.cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
        traj_full[:, rec_off : rec_off + a.shape[1]] = a
        rec_off += a.shape[1]

    synchronize(dev)
    t_start = time.perf_counter()
    d0 = sp.localize(prob.d0)
    dn = sp.localize(prob.dn)
    (traj0, shared0), carry = solver.run_streamed(
        d0, dn, 0.0, n_sync, sync=True, record="all", save_every=se_run,
    )
    synchronize(dev)
    tprof["warmup_s"] = time.perf_counter() - t_start
    write_seg(traj0)
    # the device-resident trailing window of shared rows: the LSTM's
    # encoder input, and the smoothing's front edge
    hist = torch.as_tensor(np.asarray(shared0[:, -W:], np.float64),
                           dtype=hdt).to(dev)

    t_blocks = time.perf_counter()
    full_blocks = (num_steps - n_sync) // block
    for b in range(full_blocks):
        preds = refine(block_preds(b, hist).to(sdt), hist, carry)
        (traj_b, shared_b), carry = sp.stacked_run(
            *carry, block, sync=False, preds=preds, record="all",
            save_every=se_run,
        )
        hist = torch.cat([hist, shared_b.to(hdt)], dim=1)[:, -W:]
        write_seg(traj_b)
        if verbose:
            print(f"[online] step {n_sync + (b + 1) * block}/{num_steps}")
    i = n_sync + full_blocks * block
    if i < num_steps:
        # ragged tail (< one block): the first rows of a full block's
        # LSTM prediction, or host float64 expfit rows
        n = num_steps - i
        if lstm_on:
            preds = block_preds(full_blocks, hist)[:, :n].to(sdt)
        else:
            preds = torch.as_tensor(feed.host_rows(full_blocks, n),
                                    dtype=sdt).to(dev)
        preds = refine(preds, hist, carry)
        (traj_b, _), carry = solver.run(
            *carry, n, sync=False, preds=preds, save_every=se_run,
        )
        write_seg(traj_b)
    synchronize(dev)
    tprof["blocks_s"] = time.perf_counter() - t_blocks
    elapsed = time.perf_counter() - t_start
    if verbose:
        print(f"[online] {num_steps} steps in {elapsed:.2f}s "
              f"({num_steps / elapsed:.0f} steps/s)")
    stage_log(cfg).log(
        "stage4_online",
        steps=num_steps,
        n_sync=n_sync,
        block=block,
        blocks=-(-(num_steps - n_sync) // block),
        seconds=round(elapsed, 3),
        steps_per_sec=round(num_steps / elapsed, 1),
        comm_free_fraction=round((num_steps - n_sync) / num_steps, 4),
        stacked_predictor=True,
        n_parts=P,
        warmup_s=round(tprof["warmup_s"], 3),
        blocks_s=round(tprof["blocks_s"], 3),
        device=str(dev),
    )

    if rec_off != traj_full.shape[1]:
        raise RuntimeError(
            f"stage 4 recorded {rec_off} rows, expected {traj_full.shape[1]}"
        )
    traj = traj_full
    if se_run == 1 and se > 1:
        traj = traj[:, ::se, :]
    for r in range(P):
        save_displacement(store.modeled_h5(r), rank_trajectory(ctx, traj, r))
    return ctx
