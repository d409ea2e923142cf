"""Stage 4: the synchronization-avoiding run (port of
``savtpu/pipeline/online_predictor.py``).

Schedule: i_cri+1 = n_p*n_s synchronized steps (the exchanged stepper),
then blocks of n_f*n_s steps with NO exchange. Each block's shared DOFs
come from the ranks' surrogates, all ranks at once where their models
stack:
- ``arch="lstm"`` and ``"linear"``: one phase-interleaved prediction of
  the stacked models (models/predictor.py) from the device-resident
  window of the last n_p*n_s shared rows, which every block then rolls
  forward by its own recorded shared rows; a seed ensemble's members run
  on the same stacked axis and their predictions are averaged;
- ``arch="expfit"``: the closed-form fit evaluated on the device from a
  small per-block pack of advanced amplitudes (models/expfit.py);
- ``arch="hybrid"``: that expfit base plus the stacked LSTMs' prediction
  of the residual, from a window of residual rows (the recorded rows
  minus the base; the base's rows of the warm-up are evaluated on the
  host in float64).
Then, as in the JAX package: owner consensus, smoothing
(``pred_smooth``), the exchanged anchor (``pred_anchor``), and the block
through ``ShardedProblem.stacked_run`` with full recording, which the
card replays from CUDA graphs (in banded compensated mode one launch of
the online kernel, ops/online_banded.py). A ragged last block takes the
first rows of a full block's prediction, with host float64 expfit rows.
Models that do not stack (per-rank models of unpadded widths, or an
unequal modal_dim) run the per-rank fallback loop: each rank's model
predicts its own block from its own window, block by block.

On the stacked path the blocks run in groups (the JAX package's, sized by
the bytes of their recorded trajectory), and with
``surrogate.resync_blocks`` = k every k predicted blocks are followed by
one exchanged block that blends the shared DOFs from the prediction to
the computed dynamics along a smoothstep ramp (``stacked_run``'s
``blend``) and re-anchors the history to real dynamics. With
``solver.ckpt_every`` the carry, the history window, the resync counters
and the recorded rows are checkpointed under the store's
``Checkpoints/stage4`` after the warm-up and at group boundaries on the
ckpt_every cadence; a killed run resumes there with the same bits, and a
checkpoint of another run (its fingerprint: steps, stride, parts, layout,
warm-up, block, surrogate arch and history dtype) is ignored. The
checkpoint goes once the artifacts are written.

Under a device mesh (a context from ``build_context(..., device_mesh=)``
on every rank; the JAX package's fused block group under ``shard_map``)
each rank holds its parts' surrogates, history window and expfit feed,
predicts and steps its block (K3 on its parts), and writes its parts'
``modeled_h5`` files; the consensus is a local owner sum, an
``all_reduce`` and a division by the global owner count (the once-per-block
psum), the anchor's step exchanges across ranks, and the checks that
decide the path read every rank's model sidecar, so all ranks take the
same one.

    python -m savtpu_torch.pipeline.online_predictor [--config cfg.json]
        [--steps N] [--ckpt-every N] [--[no-]resume] [--device cpu]
"""

from __future__ import annotations

import argparse
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
    subtree,
)
from ..models.data import scale_to_zero_one, strided_windows
from ..models.expfit import advance_expfit, eval_expfit, eval_expfit_device
from ..models.linear import StackedLinear
from ..models.lstm import StackedSeq2Seq
from ..models.modal import from_modal, to_modal
from ..models.predictor import phase_interleaved_predict_stacked
from ..utils import synchronize
from ..utils.checkpoint import TrajStore, restore_carry
from ..utils.offload import fetch_into
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
    # the LSTM's or the ridge map's scaling constants: floats ("joint") or
    # (input_size,)
    smax: object = None
    smin: object = None
    # a hybrid's expfit base (its LSTM is ``params``)
    expfit: Optional[Dict[str, np.ndarray]] = None
    # seed-ensemble members: every array of ``params`` is (ens, ...)
    ens: int = 1

    @property
    def arch(self) -> str:
        return self.meta.get("arch", "lstm")


def _check_scaling(cfg: Config, store, r: int, meta: Dict, modal,
                   expfit=None):
    """Recompute rank r's scaling constants from its stored stage-2 trace,
    as the reference's online stage does, and check them against the
    sidecar's (rtol 1e-10). A hybrid's (``expfit`` given) are those of the
    residual: the mode coefficients minus the sidecar's expfit base.
    Returns the sidecar's (smax, smin)."""
    sur = cfg.surrogate
    trace = load_displacement(store.shared_dof_h5(r)).T
    if modal is not None:
        trace = to_modal(trace, *modal)
    if expfit is not None:
        trace = trace - eval_expfit(
            expfit, np.arange(len(trace), dtype=float),
            float(meta["expfit_ramp_end_row"]))
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
        what = "hybrid residual scaling" if expfit is not None else (
            "scaling constants")
        raise ValueError(
            f"rank {r}: {what} drifted between training and online "
            f"(mode={scale_mode})")
    return (meta_max if meta_max.ndim else float(meta_max),
            meta_min if meta_min.ndim else float(meta_min))


def load_rank_models(ctx: StageContext, parts=None, params: bool = True):
    """Per-rank surrogates from the stage-3 artifacts (params + JSON
    sidecar) of ``parts`` (default: the context's). The scaling constants
    of an LSTM, a ridge map or a hybrid's residual LSTM are recomputed
    from the stored trace and checked against the sidecar. Where the
    config asks for ``arch="expfit"`` and the artifacts are hybrid, only
    the hybrid's expfit base is kept (the JAX package's arch downgrade).
    ``params=False`` reads the sidecars alone: the models' metadata, with
    empty params and no scaling check."""
    sur = ctx.cfg.surrogate
    models = []
    for r in (ctx.parts if parts is None else parts):
        mf = ctx.store.model_file(r)
        if not mf.exists():
            raise FileNotFoundError(
                f"rank {r}: no trained surrogate at {mf} — run stage 3 "
                f"(savtpu_torch.pipeline.model_training) first"
            )
        meta = load_params_meta(mf)
        arch = meta.get("arch", "lstm")
        if arch not in ("expfit", "lstm", "linear", "hybrid"):
            raise ValueError(f"rank {r}: unknown surrogate arch {arch!r}")
        modal = None
        if meta.get("modal_dim"):
            modal = (
                np.asarray(meta["modal_mean"], dtype=np.float64),
                np.asarray(meta["modal_basis"], dtype=np.float64),
            )
        size = int(meta["input_size"])
        if not params:
            if arch == "hybrid" and sur.arch == "expfit":
                meta = {**meta, "arch": "expfit"}
            ens = int(meta.get("ensemble", 1) or 1) if arch in (
                "lstm", "linear") else 1
            models.append(RankModel({}, size, modal, meta, ens=ens))
            continue
        params = load_params(mf)
        if arch == "expfit":
            m = RankModel(params, size, modal, meta)
        elif arch == "hybrid" and sur.arch == "expfit":
            m = RankModel(subtree(params, "expfit"), size, modal,
                          {**meta, "arch": "expfit"})
        elif arch == "hybrid":
            ef = subtree(params, "expfit")
            m = RankModel(subtree(params, "lstm"), size, modal, meta,
                          *_check_scaling(ctx.cfg, ctx.store, r, meta, modal,
                                          ef), expfit=ef)
        else:
            m = RankModel(params, size, modal, meta,
                          *_check_scaling(ctx.cfg, ctx.store, r, meta,
                                          modal),
                          ens=int(meta.get("ensemble", 1) or 1))
        models.append(m)
    return models


def stacked_net(arrays: Dict[str, np.ndarray], arch: str, n_past: int,
                dtype, device):
    """The stacked module (StackedSeq2Seq, or StackedLinear for
    ``arch="linear"``) holding the given (N, ...) arrays."""
    if arch == "linear":
        return StackedLinear.from_arrays(arrays, n_past, dtype=dtype,
                                         device=device)
    return StackedSeq2Seq.from_arrays(arrays, dtype=dtype, device=device)


def _stack_members(models, ens: int) -> Dict[str, np.ndarray]:
    """Every rank's arrays on one model axis: (P, ...) for single models,
    member e of rank r at e*P + r for seed ensembles ((E, ...) each)."""
    keys = models[0].params
    if ens <= 1:
        return {k: np.stack([m.params[k] for m in models]) for k in keys}
    return {k: np.stack([m.params[k] for m in models], axis=1).reshape(
        (-1,) + np.shape(models[0].params[k])[1:]) for k in keys}


def owner_counts(sgi, smask, SD) -> np.ndarray:
    """(SD,) float number of owner ranks of each global shared DOF, at
    least 1 (host); ``sgi`` and ``smask`` (P, 3*S_max) arrays or tensors.
    :func:`prediction_consensus` counts the same from ``sp.owners``."""
    cnt = np.zeros(SD)
    np.add.at(cnt, np.asarray(sgi).reshape(-1), np.asarray(smask).reshape(-1))
    return np.maximum(cnt, 1.0)


def prediction_consensus(preds: torch.Tensor, sp) -> torch.Tensor:
    """Average every owner rank's prediction of each duplicated shared DOF
    (SurrogateConfig.pred_consensus). preds (P, T, 3*S_max) -> same shape
    with all owners of a global shared DOF holding the same mean value.
    Owner contributions are added in (part, slot) order; under a mesh each
    rank sums its block's, the sums are all-reduced and divided by the
    global owner count."""
    P, T, S3 = preds.shape
    pr = (preds * sp.smask[:, None, :]).permute(1, 0, 2).reshape(T, P * S3)
    pr = torch.cat([pr, pr.new_zeros((T, 1))], dim=1)
    g = pr[:, sp.owners]  # (T, SD, K)
    num = pr.new_zeros((T, sp.SD))
    for k in range(g.shape[2]):
        num = num + g[:, :, k]
    if sp.comm is None:
        cnt = (sp.owners < P * S3).sum(dim=1)
    else:
        num = sp.comm.all_reduce(num)
        cnt = sp.comm.owner_count
    cnt = torch.clamp(cnt, min=1).to(preds.dtype)
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


def modal_predict_stacked(model, hist, smaxv, sminv, sur, modal, fmaskv,
                          ens: int = 1):
    """Stacked phase-interleaved block prediction with optional modal
    projection: physical history (P, W, S3) -> physical block (P, T, S3).
    ``modal`` is None or (mu (P, S3), basis (P, K, S3), coef_mask (P, K));
    the projection runs in the history's dtype, the models in theirs.
    ``ens > 1``: ``model`` holds ens*P models (member e of rank r at e*P
    + r), and the members' predictions are averaged (the scaling is
    affine per rank, so averaging scaled outputs equals averaging raw
    ones)."""
    mdt = smaxv.dtype

    def pred(h, fm):
        if ens <= 1:
            return phase_interleaved_predict_stacked(
                model, h, smaxv, sminv, sur.n_past, sur.n_future,
                sur.filter_size, feat_mask=fm)
        rep = lambda t: t.repeat((ens,) + (1,) * (t.dim() - 1))  # noqa
        out = phase_interleaved_predict_stacked(
            model, rep(h), rep(smaxv), rep(sminv), sur.n_past, sur.n_future,
            sur.filter_size, feat_mask=rep(fm))
        return out.view((ens, h.shape[0]) + out.shape[1:]).mean(0)

    with torch.no_grad():
        if modal is None:
            return pred(hist.to(mdt), fmaskv)
        mu, basis, fmc = modal
        histc = torch.einsum("pwd,pkd->pwk", hist - mu[:, None, :].to(
            hist.dtype), basis.to(hist.dtype))
        coefs = pred(histc.to(mdt), fmc)
        return modal_reconstruct(coefs, (mu, basis), fmaskv)


def hybrid_block(model, hist, smaxv, sminv, sur, modal, fmaskv, base,
                 ens: int = 1):
    """arch="hybrid": the block prediction base + residual. ``hist`` is
    the window of residual rows (the recorded shared rows minus the
    base), ``base`` (P, n, S3) the expfit base of the block's rows (n <=
    the block; the first n rows of the residual prediction are used), and
    ``modal`` the ranks' (mu, basis, coef_mask). The residual models
    project with a zero mean: mu lives in the base. Returns the
    prediction in the base's dtype."""
    mu, basis, fmc = modal
    resid = modal_predict_stacked(model, hist, smaxv, sminv, sur,
                                  (torch.zeros_like(mu), basis, fmc),
                                  fmaskv, ens)
    return base + resid[:, : base.shape[1]].to(base.dtype)


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
    """Refuse the stage-4 settings no run can honour: a negative resync
    period or checkpoint cadence (0 turns either off)."""
    for name, val in (
        ("surrogate.resync_blocks", cfg.surrogate.resync_blocks),
        ("solver.ckpt_every", cfg.solver.ckpt_every),
    ):
        if int(val or 0) < 0:
            raise ValueError(f"{name} must be >= 0, got {val}")


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
            (m.expfit if m.expfit is not None else m.params,
             float(m.meta.get("save_every", 1) or 1),
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
        return self.rows_at(np.arange(self.n_sync + b * self.block,
                                      self.n_sync + b * self.block + n,
                                      dtype=np.float64))

    def rows_at(self, steps: np.ndarray) -> np.ndarray:
        """Physical (P, len(steps), S3) float64 rows at the given steps."""
        n = len(steps)
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


def _stacked_ok(models, arch: str, modal_on: bool, S3: int) -> bool:
    """Whether every rank's model runs on one stacked axis: expfit always
    (with a uniform modal_dim in modal mode); otherwise padded models of a
    uniform modal_dim, or padded models as wide as the shared rows."""
    P = len(models)
    if arch == "expfit":
        return (not modal_on) or len({m.input_size for m in models}) == 1
    if modal_on:
        return (all(m.meta.get("padded_input", False) for m in models)
                and len({m.input_size for m in models}) == 1)
    return P > 0 and all(m.meta.get("padded_input", False)
                         and m.input_size == S3 for m in models)


def run(cfg: Config, ctx: StageContext | None = None, verbose: bool = True,
        device=None, resume: bool = True):
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
    # the path's checks see every part's model (under a mesh, from the
    # sidecars), so all ranks decide alike
    every = models if ctx.comm is None else load_rank_models(
        ctx, range(ctx.comm.n_parts), params=False)
    verbose = verbose and ctx.is_root

    num_steps = cfg.solver.num_steps
    # runs shorter than the warm-up are all synchronized
    n_sync = min(sur.i_cri + 1, num_steps)
    block = sur.block_size
    P = sp.n_parts
    P_all = P if ctx.comm is None else ctx.comm.n_parts
    S3 = sp.sld.shape[1]
    sdt = sp.dtype
    fdt = _SUR_DTYPES[sur.dtype]
    hdt = _SUR_DTYPES[sur.hist_dtype or sur.dtype]
    W = sur.n_past * sur.filter_size
    archs = {m.arch for m in every}
    if len(archs) > 1:
        raise ValueError(f"mixed surrogate arches across ranks: {archs}")
    arch = archs.pop() if archs else "lstm"
    hybrid_on = arch == "hybrid"
    ens_set = {m.ens for m in every}
    if len(ens_set) > 1:
        raise ValueError(f"mixed ensemble sizes across ranks: {ens_set}")
    ens = ens_set.pop() if ens_set else 1
    if hybrid_on and sur.pred_smooth:
        raise ValueError(
            "pred_smooth is not supported with arch='hybrid' (the history "
            "window holds residual rows; the modal basis is already a "
            "spatial band-limit)")
    if verbose:
        print(
            f"[online] {n_sync} synced + {num_steps - n_sync} comm-free "
            f"steps in blocks of {block} ({P} parts, device={dev})"
        )

    modal_on = P > 0 and all(m.modal is not None for m in every)
    if any(m.modal is not None for m in every) and not modal_on:
        raise ValueError("mixed modal and raw-channel surrogates across ranks")
    stacked_ok = _stacked_ok(every, arch, modal_on, S3)
    if arch in ("expfit", "hybrid") and not stacked_ok:
        raise ValueError(
            f"arch={arch!r} requires the stacked online path (uniform "
            "modal_dim across ranks)")
    fmask_np = np.zeros((P, S3), dtype=np.float32)
    for r in range(P):
        fmask_np[r, : 3 * len(maps.shared_nodes[sp.part0 + r])] = 1.0
    fmask = torch.as_tensor(fmask_np, dtype=fdt).to(dev)
    modal_pack = None
    Kfeed = S3
    if modal_on and stacked_ok:
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

    feed = None
    if arch in ("expfit", "hybrid"):
        feed = _ExpfitFeed(models, P, S3, Kfeed, modal_on, n_sync, block,
                           dev)
    net = smax_v = smin_v = None
    if stacked_ok and arch != "expfit":
        net = stacked_net(_stack_members(models, ens), arch, sur.n_past,
                          fdt, dev)
        smax_v = torch.as_tensor(np.array([m.smax for m in models]),
                                 dtype=fdt).to(dev)
        smin_v = torch.as_tensor(np.array([m.smin for m in models]),
                                 dtype=fdt).to(dev)

    def block_preds(b, hist, n=None):
        """The physical (P, block, S3) prediction of block b from the
        history window, and the hybrid's base (else None). ``n`` rows of a
        ragged tail take host float64 expfit rows."""
        if arch == "expfit":
            if n is not None:
                return torch.as_tensor(feed.host_rows(b, n)).to(dev), None
            return modal_reconstruct(feed.coefs(b), modal_pack, fmask), None
        if not hybrid_on:
            return modal_predict_stacked(net, hist, smax_v, smin_v, sur,
                                         modal_pack, fmask, ens), None
        if n is not None:
            base = torch.as_tensor(feed.host_rows(b, n)).to(dev)
        else:
            base = modal_reconstruct(feed.coefs(b), modal_pack, fmask)
        return hybrid_block(net, hist, smax_v, smin_v, sur, modal_pack,
                            fmask, base, ens), base

    def refine(preds, hist, carry, anchor=True):
        """Consensus, smoothing and the anchor (a resync block takes none),
        in the JAX package's order."""
        if sur.pred_consensus:
            preds = prediction_consensus(preds, sp)
        if sur.pred_smooth and hist is not None:
            preds = smooth_preds(preds, hist.to(sdt), sur.pred_smooth)
        if anchor and sur.pred_anchor:
            preds = anchor_block(sp, carry, preds)
        return preds

    # in-loop save_every stride when every segment length divides evenly
    se = cfg.solver.save_every
    se_run = (
        se if (num_steps % se == 0 and n_sync % se == 0 and block % se == 0)
        else 1
    )
    np_dtype = torch.empty((), dtype=sdt).numpy().dtype
    n_rec_total = num_steps // se_run
    # every segment (warm-up, block groups, resync blocks, ragged tail,
    # fallback blocks) writes in order at rec_off; with ckpt_every the
    # buffer is a disk-backed memmap beside a state file (stacked path)
    use_ckpt = bool(cfg.solver.ckpt_every) and stacked_ok
    tstore = None
    ck_extras = {}
    start_steps = 0
    if use_ckpt:
        # its "shared" slot holds the history window in a dtype that
        # keeps it exactly (NumPy has no bfloat16; float32 holds it)
        wdt = torch.float32 if hdt == torch.bfloat16 else hdt
        tstore = TrajStore(
            store.ckpt_dir("stage4"), P_all, sp.DL, S3, n_rec_total, W, sdt,
            True, True, shared_dtype=wdt, comm=ctx.comm,
        )
        ck_expect = {
            "num_steps": num_steps, "save_every": se_run, "P": P_all,
            "DL": sp.DL, "n_sync": n_sync, "block": block,
            "arch": arch, "hist_dtype": sur.hist_dtype or sur.dtype,
        }
        start_steps, ck_extras = tstore.resume_step(ck_expect, resume)
        tstore.open(fresh=start_steps == 0)
    else:
        traj_full = np.empty((P, n_rec_total, sp.DL), dtype=np_dtype)
    rec_off = 0
    tprof = {"warmup_s": 0.0, "blocks_s": 0.0}

    def write_seg(arr):
        # threaded leading-axis chunks straight into the destination (a
        # memmap under checkpoints)
        nonlocal rec_off
        if not torch.is_tensor(arr):
            arr = np.asarray(arr)
        if tstore is not None:
            tstore.write("traj", rec_off, arr)
        else:
            fetch_into(traj_full[:, rec_off : rec_off + arr.shape[1]], arr)
        rec_off += arr.shape[1]

    # one group's recorded blocks wait on the device until the next
    # ordered writer (the next group, a resync block, a checkpoint, the
    # tail) flushes them, so segments land in step order
    pending = []

    def flush_pending():
        for a in pending:
            write_seg(a)
        pending.clear()

    synchronize(dev)
    t_start = time.perf_counter()
    if start_steps:
        if verbose:
            print(f"[online] resuming at step {start_steps}/{num_steps}")
        rec_off = start_steps // se_run
        carry = restore_carry(sp, ck_extras["d0"], ck_extras["dn"],
                              ck_extras["tn"])
        # the stored window (the hybrid's already holds residual rows)
        h0 = np.asarray(tstore.result("shared"), np.float64)
    else:
        d0 = sp.localize(prob.d0)
        dn = sp.localize(prob.dn)
        (traj0, shared0), carry = solver.run_streamed(
            d0, dn, 0.0, n_sync, sync=True, record="all",
            save_every=se_run,
        )
        synchronize(dev)
        tprof["warmup_s"] = time.perf_counter() - t_start
        write_seg(traj0)
        h0 = np.asarray(shared0[:, -W:], np.float64)
        if stacked_ok and hybrid_on:
            # the residual history: the warm-up's rows minus the base at
            # the same steps, evaluated on the host in float64
            h0 = h0 - feed.rows_at(np.arange(n_sync - h0.shape[1], n_sync,
                                             dtype=np.float64))

    t_blocks = time.perf_counter()
    full_blocks = (num_steps - n_sync) // block
    resync = int(sur.resync_blocks or 0)
    n_resync_steps = int(ck_extras.get("n_resync_steps", 0))
    if stacked_ok:
        # the device-resident trailing window: the models' encoder input
        # and the smoothing's front edge
        hist = torch.as_tensor(h0, dtype=hdt).to(dev)
        # groups bounded by the bytes of their recorded trajectory (the
        # JAX package's 500 MB), and by the resync period
        per_block_bytes = 4 * P_all * (block // max(se_run, 1)) * sp.DL
        GROUP = max(1, min(8, int(500_000_000 // max(per_block_bytes, 1))))
        if resync:
            GROUP = min(GROUP, resync)
        done_blocks = int(ck_extras.get("done_blocks", 0))
        since_resync = int(ck_extras.get("since_resync", 0))

        def save_ckpt():
            if tstore is None:
                return
            flush_pending()  # a resume replays from written rows only
            tstore.write("shared", 0, hist.to(wdt))
            tstore.save_state(
                carry, n_sync + done_blocks * block, ck_expect,
                extras={"done_blocks": done_blocks,
                        "n_resync_steps": n_resync_steps,
                        "since_resync": since_resync})

        if use_ckpt and not start_steps:
            save_ckpt()  # the warm-up is complete
        # checkpoints on the ckpt_every step cadence, rounded up to whole
        # groups (group boundaries are the only save points)
        ckpt_blocks = done_blocks
        ckpt_stride = max(1, -(-int(cfg.solver.ckpt_every or block)
                               // block))
        while done_blocks < full_blocks:
            nb = min(GROUP, full_blocks - done_blocks)
            if resync:
                nb = min(nb, resync - since_resync)
            group = []
            for b in range(done_blocks, done_blocks + nb):
                blockpred, base = block_preds(b, hist)
                preds = refine(blockpred.to(sdt), hist, carry)
                (traj_b, shared_b), carry = sp.stacked_run(
                    *carry, block, sync=False, preds=preds, record="all",
                    save_every=se_run,
                )
                roll = shared_b - base.to(shared_b.dtype) if hybrid_on \
                    else shared_b
                hist = torch.cat([hist, roll.to(hdt)], dim=1)[:, -W:]
                group.append(traj_b)
            flush_pending()
            pending.extend(group)
            done_blocks += nb
            since_resync += nb
            if resync and since_resync >= resync \
                    and done_blocks < full_blocks:
                # periodic re-synchronization: one exchanged block that
                # blends the shared DOFs from the prediction (w = 0) to the
                # computed dynamics (w = 1) along a smoothstep, releasing
                # the interface layer's stored energy quasi-statically
                # (a hard release rings), and re-anchors the history; its
                # expfit rows (and the hybrid's base) are the host's
                blockpred, base_s = block_preds(done_blocks, hist, n=block)
                preds_s = refine(blockpred.to(sdt), hist, carry,
                                 anchor=False)
                tt = torch.linspace(0.0, 1.0, block, dtype=sdt, device=dev)
                wramp = tt * tt * (3.0 - 2.0 * tt)
                (traj_s, shared_s), carry = solver.run(
                    *carry, block, sync=True, preds=preds_s, blend=wramp,
                    record="all", save_every=se_run,
                )
                roll_s = shared_s
                if hybrid_on:
                    roll_s = roll_s - base_s.to(roll_s.dtype)
                hist = torch.cat([hist, roll_s.to(hdt)], dim=1)[:, -W:]
                flush_pending()
                write_seg(traj_s)
                done_blocks += 1
                n_resync_steps += block
                since_resync = 0
            if done_blocks - ckpt_blocks >= ckpt_stride:
                save_ckpt()
                ckpt_blocks = done_blocks
            if verbose:
                print(f"[online] step {n_sync + done_blocks * block}"
                      f"/{num_steps}")
        flush_pending()
        i = n_sync + full_blocks * block
        if i < num_steps:
            # ragged tail (< one block): the first rows of a full block's
            # model prediction, host float64 expfit rows
            n = num_steps - i
            blockpred, _ = block_preds(full_blocks, hist, n)
            preds = refine(blockpred[:, :n].to(sdt), hist, carry)
            (traj_b, _), carry = solver.run(
                *carry, n, sync=False, preds=preds, save_every=se_run,
            )
            write_seg(traj_b)
    else:
        carry = _per_rank_blocks(cfg, ctx, models, carry, h0, n_sync,
                                 se_run, write_seg, refine, verbose)
    synchronize(dev)
    tprof["blocks_s"] = time.perf_counter() - t_blocks
    elapsed = time.perf_counter() - t_start
    if verbose:
        print(f"[online] {num_steps} steps in {elapsed:.2f}s "
              f"({num_steps / elapsed:.0f} steps/s)")
    mesh_info = {}
    if ctx.comm is not None:
        mesh_info = dict(world=ctx.comm.world,
                         rank_seconds=ctx.rank_values(round(elapsed, 3)))
    ctx.log(
        "stage4_online",
        steps=num_steps,
        n_sync=n_sync,
        block=block,
        blocks=-(-(num_steps - n_sync) // block),
        seconds=round(elapsed, 3),
        steps_per_sec=round(num_steps / elapsed, 1),
        comm_free_fraction=round(
            (num_steps - n_sync - n_resync_steps) / num_steps, 4),
        resync_blocks=resync,
        n_resync_steps=n_resync_steps,
        stacked_predictor=bool(stacked_ok),
        arch=arch,
        ensemble=ens,
        n_parts=P_all,
        warmup_s=round(tprof["warmup_s"], 3),
        blocks_s=round(tprof["blocks_s"], 3),
        device=str(dev),
        **mesh_info,
    )

    if rec_off != n_rec_total:
        raise RuntimeError(
            f"stage 4 recorded {rec_off} rows, expected {n_rec_total}"
        )
    traj = traj_full if tstore is None else tstore.result("traj")
    if se_run == 1 and se > 1:
        traj = traj[:, ::se, :]
    for r in ctx.parts:
        save_displacement(store.modeled_h5(r), rank_trajectory(ctx, traj, r))
    if tstore is not None:
        # the artifacts are complete: drop the mid-run checkpoint, so a
        # later (perhaps reconfigured) run of the stage starts fresh
        del traj
        tstore.cleanup()
    return ctx


def _per_rank_blocks(cfg, ctx, models, carry, h0, n_sync, se_run,
                     write_seg, refine, verbose):
    """The per-rank fallback loop, for models that do not stack (per-rank
    models of unpadded widths, or an unequal modal_dim): block by block,
    each rank's model (its members averaged) predicts its own rows from
    its own trailing window of the recorded shared rows (projected onto
    its modes and back, in float64, for a modal model); consensus and the
    anchor follow, smoothing does not (as in the JAX package). Returns
    the carry."""
    sp, solver, maps = ctx.sp, ctx.solver, ctx.maps
    sur = cfg.surrogate
    dev = ctx.device
    fdt = _SUR_DTYPES[sur.dtype]
    P, S3 = sp.n_parts, sp.sld.shape[1]
    W = sur.n_past * sur.filter_size
    num_steps, block = cfg.solver.num_steps, sur.block_size
    ignored = [k for k in ("pred_smooth", "resync_blocks")
               if getattr(sur, k)]
    if ignored and verbose:
        print("[online] WARNING: per-rank fallback path ignores "
              + ", ".join(ignored) + " (only honored on the stacked fast "
              "path)")
    as_dev = lambda a: torch.as_tensor(  # noqa: E731
        np.array(a, np.float64), dtype=fdt).to(dev)
    nets = []
    for m in models:
        arrays = m.params if m.ens > 1 else {k: v[None]
                                             for k, v in m.params.items()}
        nets.append((stacked_net(arrays, m.arch, sur.n_past, fdt, dev),
                     as_dev(np.broadcast_to(m.smax, (m.ens,) + np.shape(
                         m.smax))), as_dev(np.broadcast_to(
                             m.smin, (m.ens,) + np.shape(m.smin)))))

    def predict(r, window, fm):
        """Rank r's (n_f*n_s, D_in) block from its (W, D_in) window, the
        mean over its members."""
        net, mx, mn = nets[r]
        E = models[r].ens
        h = as_dev(window)[None].expand(E, -1, -1)
        fmv = None if fm is None else as_dev(fm)[None].expand(E, -1)
        with torch.no_grad():
            out = phase_interleaved_predict_stacked(
                net, h, mx, mn, sur.n_past, sur.n_future, sur.filter_size,
                feat_mask=fmv)
        return out.mean(0).cpu().numpy().astype(np.float64)

    hist = h0
    i = n_sync
    while i < num_steps:
        n = min(block, num_steps - i)
        preds = np.zeros((P, n, S3))
        for r, m in enumerate(models):
            Dr = 3 * len(maps.shared_nodes[sp.part0 + r])
            if Dr == 0:
                continue
            D_in = m.input_size
            if m.modal is not None:
                mu, basis = m.modal
                K = basis.shape[0]
                histc = np.zeros((hist.shape[1], D_in))
                histc[:, :K] = to_modal(hist[r, :, : mu.shape[0]], mu, basis)
                fm = np.zeros(D_in)
                fm[:K] = 1.0
                rec = from_modal(predict(r, histc, fm)[:n, :K], mu, basis)
                preds[r, :, :Dr] = rec[:, :Dr]
                continue
            if m.meta.get("padded_input", False):
                # a stacked-trained model: the padded window (zeros on the
                # pad dims before scaling) with the feature mask
                fm = np.zeros(D_in)
                fm[:Dr] = 1.0
                out = predict(r, hist[r, :, :D_in], fm)
            else:
                out = predict(r, hist[r, :, :Dr], None)
            preds[r, :, :Dr] = out[:n, :Dr]
        preds = refine(torch.as_tensor(preds, dtype=sp.dtype).to(dev), None,
                       carry)
        (traj_b, shared_b), carry = solver.run(
            *carry, n, sync=False, preds=preds, save_every=se_run,
        )
        hist = np.concatenate(
            [hist, shared_b.cpu().numpy().astype(np.float64)], axis=1)[:, -W:]
        write_seg(traj_b)
        i += n
        if verbose:
            print(f"[online] step {i}/{num_steps}")
    return carry


def main(argv=None):
    ap = argparse.ArgumentParser(description="savtpu_torch stage 4: online "
                                             "predictor")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint carry + trajectory at block-group "
                         "boundaries (any nonzero value enables)")
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="resume from an existing stage-4 checkpoint "
                         "(--no-resume starts fresh)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.steps:
        cfg.solver.num_steps = args.steps
    if args.ckpt_every is not None:
        cfg.solver.ckpt_every = args.ckpt_every
    run(cfg, device=args.device, resume=args.resume)


if __name__ == "__main__":
    main()
