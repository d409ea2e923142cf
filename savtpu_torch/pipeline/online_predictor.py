"""Stage 4: the synchronization-avoiding run (port of
``savtpu/pipeline/online_predictor.py`` for the expfit surrogate).

Schedule: i_cri+1 = n_p*n_s synchronized steps (the exchanged stepper),
then blocks of n_f*n_s steps with NO exchange: each block's shared DOFs
come from the closed-form expfit surrogate, evaluated on the device from a
small per-block pack of advanced amplitudes (models/expfit.py), and the
block runs through ``ShardedProblem.stacked_run`` — in banded compensated
mode one launch of the online kernel (ops/online_banded.py) per block.
A ragged last block takes host float64 predictions, as in the JAX
package. The LSTM/linear/hybrid surrogates, prediction smoothing,
anchoring, resync blocks, checkpoints and the per-rank fallback loop wait
for later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.artifacts import (
    load_params,
    load_params_meta,
    save_displacement,
)
from ..models.expfit import advance_expfit, eval_expfit, eval_expfit_device
from ..utils import stage_log, synchronize
from .common import (
    StageContext,
    build_context,
    rank_trajectory,
    save_partition_labels,
)

_SUR_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class RankModel:
    params: Dict[str, np.ndarray]
    input_size: int
    modal: Optional[Tuple[np.ndarray, np.ndarray]]  # (mu (D,), basis (K, D))
    meta: Dict


def load_rank_models(ctx: StageContext):
    """Per-rank expfit surrogates from the stage-3 artifacts (params +
    JSON sidecar)."""
    models = []
    for r in range(ctx.sp.n_parts):
        mf = ctx.store.model_file(r)
        if not mf.exists():
            raise FileNotFoundError(
                f"rank {r}: no trained surrogate at {mf} — run stage 3 "
                f"(savtpu_torch.pipeline.model_training) first"
            )
        meta = load_params_meta(mf)
        if meta.get("arch", "lstm") != "expfit":
            raise NotImplementedError(
                f"rank {r}: surrogate arch {meta.get('arch', 'lstm')!r} is "
                "not ported yet; the port runs arch='expfit'"
            )
        modal = None
        if meta.get("modal_dim"):
            modal = (
                np.asarray(meta["modal_mean"], dtype=np.float64),
                np.asarray(meta["modal_basis"], dtype=np.float64),
            )
        models.append(
            RankModel(load_params(mf), int(meta["input_size"]), modal, meta)
        )
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


def modal_reconstruct(coefs, modal, fmask):
    """(P, T, K) mode coefficients -> (P, T, S3) physical shared rows
    (``modal`` = (mu (P, S3), basis (P, K, S3)) or None when the
    coefficients are already physical, padded to S3)."""
    if modal is None:
        out = coefs
    else:
        mu, basis = modal
        out = (torch.einsum("ptk,pkd->ptd", coefs, basis.to(coefs.dtype))
               + mu[:, None, :].to(coefs.dtype))
    return out * fmask[:, None, :].to(out.dtype)


def _check_supported(cfg: Config) -> None:
    sur = cfg.surrogate
    for name, val in (
        ("surrogate.pred_smooth", sur.pred_smooth),
        ("surrogate.pred_anchor", sur.pred_anchor),
        ("surrogate.resync_blocks", sur.resync_blocks),
        ("solver.ckpt_every", cfg.solver.ckpt_every),
    ):
        if val:
            raise NotImplementedError(f"{name} is not ported yet")
    if sur.ensemble > 1:
        raise NotImplementedError("surrogate.ensemble > 1 is not ported yet")


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
        for r, m in enumerate(models):
            mu, basis = m.modal
            mu_np[r, : mu.shape[0]] = mu
            basis_np[r, : basis.shape[0], : mu.shape[0]] = basis
        modal_pack = (torch.as_tensor(mu_np, dtype=fdt).to(dev),
                      torch.as_tensor(basis_np, dtype=fdt).to(dev))

    # per-rank (params, save_every, ramp_end_row) and the static pole pack
    # (padded with a decayed dummy pole z=0.5 whose amplitudes are zero)
    ef_models = [
        (m.params, float(m.meta.get("save_every", 1) or 1),
         float(m.meta["expfit_ramp_end_row"]))
        for m in models
    ]
    M_max = max((len(p["z_re"]) for p, _, _ in ef_models), default=1) or 1
    z_re_np = np.full((P, M_max), 0.5)
    z_im_np = np.zeros((P, M_max))
    se_np = np.ones((P,))
    for r, (p, se_r, _) in enumerate(ef_models):
        mr = len(p["z_re"])
        z_re_np[r, :mr] = p["z_re"]
        z_im_np[r, :mr] = p["z_im"]
        se_np[r] = se_r
    to_dev32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32)).to(dev)
    z_re, z_im, se_v = to_dev32(z_re_np), to_dev32(z_im_np), to_dev32(se_np)

    def block_pack(b: int):
        """Advanced-amplitude pack of block b (float32 leaves (P, ...)),
        folded on the host in float64."""
        pk = {
            "constA": np.zeros((P, Kfeed), np.float32),
            "linA": np.zeros((P, Kfeed), np.float32),
            "aA_re": np.zeros((P, Kfeed, M_max), np.float32),
            "aA_im": np.zeros((P, Kfeed, M_max), np.float32),
            "constB": np.zeros((P, Kfeed), np.float32),
            "aB_re": np.zeros((P, Kfeed, M_max), np.float32),
            "aB_im": np.zeros((P, Kfeed, M_max), np.float32),
            "gap": np.zeros((P,), np.float32),
        }
        step0 = n_sync + b * block
        for r, (p, se_r, ramp_r) in enumerate(ef_models):
            adv = advance_expfit(p, step0 / se_r, ramp_r)
            C_r = adv["constA"].shape[0]
            mr = adv["aA_re"].shape[1]
            pk["constA"][r, :C_r] = adv["constA"]
            pk["linA"][r, :C_r] = adv["linA"]
            pk["aA_re"][r, :C_r, :mr] = adv["aA_re"]
            pk["aA_im"][r, :C_r, :mr] = adv["aA_im"]
            pk["constB"][r, :C_r] = adv["constB"]
            pk["aB_re"][r, :C_r, :mr] = adv["aB_re"]
            pk["aB_im"][r, :C_r, :mr] = adv["aB_im"]
            pk["gap"][r] = adv["gap"]
        return {k: to_dev32(v) for k, v in pk.items()}

    def host_block_preds(b: int, n: int) -> np.ndarray:
        """Physical (P, n, S3) host float64 predictions for n steps from
        the start of block b (the ragged-tail path)."""
        steps = np.arange(n_sync + b * block, n_sync + b * block + n,
                          dtype=np.float64)
        out = np.zeros((P, n, S3))
        for r, m in enumerate(models):
            pr, se_r, ramp_r = ef_models[r]
            co = eval_expfit(pr, steps / se_r, ramp_r)
            if modal_on:
                mu, basis = m.modal
                out[r, :, : mu.shape[0]] = co[:, : basis.shape[0]] @ basis + mu
            else:
                out[r, :, : co.shape[1]] = co
        return out

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
    (traj0, _), carry = solver.run_streamed(
        d0, dn, 0.0, n_sync, sync=True, record="all", save_every=se_run,
    )
    synchronize(dev)
    tprof["warmup_s"] = time.perf_counter() - t_start
    write_seg(traj0)

    t_blocks = time.perf_counter()
    full_blocks = (num_steps - n_sync) // block
    for b in range(full_blocks):
        co = eval_expfit_device(block_pack(b), z_re, z_im, se_v, block)
        preds = modal_reconstruct(co, modal_pack, fmask).to(sdt)
        if sur.pred_consensus:
            preds = prediction_consensus(preds, sp)
        (traj_b, _), carry = sp.stacked_run(
            *carry, block, sync=False, preds=preds, record="all",
            save_every=se_run,
        )
        write_seg(traj_b)
        if verbose:
            print(f"[online] step {n_sync + (b + 1) * block}/{num_steps}")
    i = n_sync + full_blocks * block
    if i < num_steps:
        # ragged tail (< one block): host float64 predictions
        n = num_steps - i
        preds = torch.as_tensor(host_block_preds(full_blocks, n),
                                dtype=sdt).to(dev)
        if sur.pred_consensus:
            preds = prediction_consensus(preds, sp)
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
