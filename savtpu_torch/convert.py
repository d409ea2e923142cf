"""Carry state from the JAX package (savtpu) over to this port.

- :func:`from_savtpu_arrays` takes a savtpu ``ShardedProblem``'s arrays
  and stage-3 expfit params with their sidecars, as numpy arrays and
  dicts, and returns the port's ``ShardedProblem`` and ``RankModel``s.
- :func:`lstm_arrays_from_savtpu` flattens savtpu's LSTM parameter
  pytree (one model, or P stacked on a leading axis) into the port's
  parameter names (``models/lstm.py``), and :func:`lstm_tree_from_arrays`
  is the reverse. :func:`params_from_savtpu` does the same for any of
  savtpu's stage-3 models by its sidecar's arch: expfit arrays as they
  are, the LSTM (per rank, stacked-trained or an (E, ...) seed ensemble),
  the linear map's ``{"lin": {"W", "b"}}`` and the hybrid's
  ``{"expfit", "lstm"}`` under the port's names (``io/artifacts.py``).
- :func:`import_savtpu_run` copies a savtpu run directory's artifacts
  (label CSVs, stage-1/2 trajectories, stage-3 models, the run log) into
  a port ``ArtifactStore``, so any later stage of the port can start from
  them. savtpu writes trajectories as HDF5 (or ``.npz`` without h5py) and
  params as flax msgpack; this package reads neither format's library,
  so the caller passes the readers for those files.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .io.artifacts import (
    ArtifactStore,
    flatten_params,
    load_params_meta,
    save_displacement,
    save_params,
    subtree,
)
from .models.lstm import CELL_KEYS
from .ops.material import NeoHookean
from .ops.assembly import incident_lists
from .parallel.sharded import ShardedProblem, _owner_table
from .pipeline.online_predictor import RankModel
from .utils import resolve_device

# ShardedProblem fields that are tensors on the device
_FLOAT_FIELDS = ("dof_mask", "bc_mask", "lM", "F_pre", "smask", "denseK",
                 "band_Kd", "band_Kl", "nh_G", "nh_detJw", "nhs_G",
                 "nhs_dJw", "ell_blocks", "Ke", "nx_mask")
_INT_FIELDS = ("sld", "sgi")
_OPT_INT_FIELDS = ("edofs", "nh_gather", "grid_perm", "grid_inv",
                   "ell_cols", "nx_pack", "nx_unpack", "nx_src")
_SCALARS = ("n_parts", "DL", "SD", "dt", "alpha", "ramped", "fint_mode",
            "compensated")
# optional scalars and shape tuples of the matrix-free and grid modes
_OPT_SCALARS = ("exchange_mode", "stn_lmd", "stn_mu")
_OPT_DIMS = ("nhs_dims", "grid_pdims", "grid_ndims")


def from_savtpu_arrays(
    sp_arrays: Dict,
    models: Iterable[Tuple[Dict, Dict]] = (),
    device=None,
    dtype=None,
):
    """Build the port's objects from savtpu state given as numpy.

    ``sp_arrays`` maps field names of savtpu's ``ShardedProblem`` to
    values: the scalars n_parts, DL, SD, dt, alpha, ramped, fint_mode,
    compensated, the arrays local_dofs_global, dof_mask, bc_mask, lM,
    F_pre, sld, sgi, smask, and denseK (dense and pallas modes),
    band_Kd/band_Kl (banded mode), ell_blocks/ell_cols (ell mode) or
    Ke/edofs (ebe mode, whose incident lists are built here); pallas
    arrays are moved from savtpu's 128-padded layout to the port's
    (:func:`_unpad_pallas`). Fint mode
    "nh" takes ``nh_material`` (the NeoHookean's fields as a mapping, e.g.
    ``dataclasses.asdict(sp.nh_material)``) with nh_G, nh_detJw, nh_gather
    and edofs (the incident-list layout) or nhs_dims, nhs_G, nhs_dJw (the
    box stencil); "stencil" takes stn_lmd, stn_mu and the nhs_* fields;
    ``exchange_mode`` "grid" takes grid_pdims, grid_ndims, grid_perm and
    grid_inv, "permute" nx_pack, nx_unpack, nx_mask and nx_src (its
    default is "psum"). ``models``
    holds one (params, sidecar) pair per rank: any of savtpu's stage-3
    parameter trees (or their flat arrays, :func:`params_from_savtpu`)
    with its sidecar, which gives the arch, the ensemble size and the
    scaling constants. The tensors go to ``device``, CUDA unless the
    caller asks for another (``utils.resolve_device``: raises without
    CUDA). Returns (ShardedProblem, [RankModel])."""
    missing = [k for k in _SCALARS + ("local_dofs_global",) + _INT_FIELDS
               if k not in sp_arrays]
    if missing:
        raise KeyError(f"savtpu ShardedProblem arrays lack {missing}")
    dev = resolve_device(device)
    if sp_arrays["fint_mode"] == "pallas":
        sp_arrays = _unpad_pallas(sp_arrays)
    if sp_arrays["fint_mode"] == "ebe":
        sp_arrays = {**sp_arrays, "nh_gather": incident_lists(
            np.asarray(sp_arrays["edofs"], dtype=np.int64),
            int(sp_arrays["DL"]))}
    dtype = dtype or torch.as_tensor(np.array(sp_arrays["lM"])).dtype
    kw = {k: sp_arrays[k] for k in _SCALARS}
    for k in _FLOAT_FIELDS:
        if sp_arrays.get(k) is not None:
            kw[k] = torch.as_tensor(np.array(sp_arrays[k]),
                                    dtype=dtype).to(dev)
    for k in _INT_FIELDS:
        kw[k] = torch.as_tensor(
            np.array(sp_arrays[k], dtype=np.int64)).to(dev)
    for k in _OPT_INT_FIELDS:
        if sp_arrays.get(k) is not None:
            kw[k] = torch.as_tensor(
                np.array(sp_arrays[k], dtype=np.int64)).to(dev)
    for k in _OPT_SCALARS:
        if sp_arrays.get(k) is not None:
            kw[k] = sp_arrays[k]
    for k in _OPT_DIMS:
        if sp_arrays.get(k) is not None:
            kw[k] = tuple(int(v) for v in sp_arrays[k])
    if sp_arrays.get("nh_material") is not None:
        kw["nh_material"] = NeoHookean(**dict(sp_arrays["nh_material"]))
    sgi = np.asarray(sp_arrays["sgi"], dtype=np.int64)
    smask = np.asarray(sp_arrays["smask"])
    sp = ShardedProblem(
        local_dofs_global=np.asarray(sp_arrays["local_dofs_global"]),
        owners=torch.as_tensor(
            _owner_table(sgi, smask, int(sp_arrays["SD"]))).to(dev),
        **kw,
    )
    rank_models = []
    for params, meta in models:
        modal = None
        if meta.get("modal_dim"):
            modal = (np.asarray(meta["modal_mean"], dtype=np.float64),
                     np.asarray(meta["modal_basis"], dtype=np.float64))
        arch = meta.get("arch", "lstm")
        flat = {k: np.asarray(v, dtype=np.float64)
                for k, v in params_from_savtpu(params, meta).items()}
        scale = (None, None)
        if arch != "expfit":
            scale = tuple(
                float(v) if np.ndim(v) == 0 else np.asarray(v, np.float64)
                for v in (meta["scale_max"], meta["scale_min"]))
        expfit = None
        if arch == "hybrid":
            expfit, flat = subtree(flat, "expfit"), subtree(flat, "lstm")
        rank_models.append(RankModel(
            flat, int(meta["input_size"]), modal, dict(meta), *scale,
            expfit=expfit, ens=int(meta.get("ensemble", 1) or 1),
        ))
    return sp, rank_models


def params_from_savtpu(tree, meta: Dict) -> Dict[str, np.ndarray]:
    """One rank's savtpu stage-3 parameters (its pytree, as flax's msgpack
    restores it, or already flat) under the port's names, by the
    sidecar's arch: expfit's arrays unchanged; an LSTM's (any leading
    axes kept, e.g. a seed ensemble's (E, ...)) by
    :func:`lstm_arrays_from_savtpu`; ``lin.W``, ``lin.b``; a hybrid's
    ``expfit.<name>`` and ``lstm.<name>``."""
    arch = meta.get("arch", "lstm")
    if arch == "expfit" or any("." in k for k in tree):
        return {k: np.asarray(v) for k, v in tree.items()}
    if arch == "linear":
        return flatten_params({"lin": tree["lin"]})
    if arch == "hybrid":
        return {**flatten_params({"expfit": tree["expfit"]}),
                **flatten_params({"lstm": lstm_arrays_from_savtpu(
                    tree["lstm"])})}
    return lstm_arrays_from_savtpu(tree)


def _items(node):
    """A pytree list, or flax's msgpack form of one (a dict keyed "0",
    "1", ...), as an ordered list."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def lstm_arrays_from_savtpu(tree) -> Dict[str, np.ndarray]:
    """savtpu's LSTM parameter pytree (``init_seq2seq``; per shard, or
    stacked with a leading model axis) -> {port name: array}, the names
    of ``savtpu_torch/models/lstm.py``. Already-flat input passes through
    unchanged. The leading axes are kept as they are."""
    if "decoder.Wi" in tree:
        return {k: np.asarray(v) for k, v in tree.items()}
    out = {}
    for l, layer in enumerate(_items(tree["encoder"])):
        for d in ("fwd", "bwd"):
            if d in layer:
                for k in CELL_KEYS:
                    out[f"encoder.{l}.{d}.{k}"] = np.asarray(layer[d][k])
    for k in CELL_KEYS:
        out[f"decoder.{k}"] = np.asarray(tree["decoder"][k])
    out["fc.W"] = np.asarray(tree["fc"]["W"])
    out["fc.b"] = np.asarray(tree["fc"]["b"])
    if "ginc" in tree:
        out["ginc"] = np.asarray(tree["ginc"])
    return out


def lstm_tree_from_arrays(arrays: Dict[str, np.ndarray]) -> Dict:
    """The reverse of :func:`lstm_arrays_from_savtpu`: the port's named
    arrays -> savtpu's pytree (``{"encoder": [{"fwd": {...}, "bwd":
    {...}}, ...], "decoder": {...}, "fc": {...}[, "ginc"]}``)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in arrays
                       if k.startswith("encoder."))
    enc = []
    for l in range(n_layers):
        enc.append({d: {k: np.asarray(arrays[f"encoder.{l}.{d}.{k}"])
                        for k in CELL_KEYS}
                    for d in ("fwd", "bwd")
                    if f"encoder.{l}.{d}.Wi" in arrays})
    tree = {"encoder": enc,
            "decoder": {k: np.asarray(arrays[f"decoder.{k}"])
                        for k in CELL_KEYS},
            "fc": {"W": np.asarray(arrays["fc.W"]),
                   "b": np.asarray(arrays["fc.b"])}}
    if "ginc" in arrays:
        tree["ginc"] = np.asarray(arrays["ginc"])
    return tree


def _unpad_pallas(sp_arrays: Dict) -> Dict:
    """savtpu's pallas arrays in the port's pallas layout.

    savtpu pads the local DOF axis of ``fint_mode="pallas"`` to a multiple
    of 128 (``pad_dl``) and puts the dummy slot at the padded DL-1; the
    slots from 3 L_max up to it are inert (mask 0, lM 1, K 0). The port
    keeps the dense layout, DL = 3 L_max + 1 with the dummy at DL-1, so
    the real slots are kept, the padded dummy becomes the new one and the
    inert slots are dropped (after checking that they are inert)."""
    DLp = int(sp_arrays["DL"])
    n = np.asarray(sp_arrays["local_dofs_global"]).shape[1]
    keep = np.concatenate([np.arange(n), [DLp - 1]])
    out = dict(sp_arrays, DL=n + 1)
    for k in ("dof_mask", "bc_mask", "lM", "F_pre"):
        a = np.asarray(sp_arrays[k])
        if a.shape[1] != DLp:
            raise ValueError(f"{k} has {a.shape[1]} slots, DL is {DLp}")
        pad = a[:, n : DLp - 1]
        inert = 1.0 if k == "lM" else 0.0
        if pad.size and not (pad == inert).all():
            raise ValueError(f"savtpu's pallas pad slots of {k} are not "
                             f"inert ({inert})")
        out[k] = a[:, keep]
    K = np.asarray(sp_arrays["denseK"])
    if K[:, n:, :].any() or K[:, :, n:].any():
        raise ValueError("savtpu's pallas K is not zero on its pad slots")
    out["denseK"] = K[:, keep][:, :, keep]
    sld = np.array(sp_arrays["sld"], dtype=np.int64)
    real = np.asarray(sp_arrays["smask"]) > 0
    if (sld[real] >= n).any():
        raise ValueError("a valid shared slot of savtpu's pallas sld lies "
                         "past the real DOFs")
    sld[~real] = n  # the port's dummy slot
    out["sld"] = sld
    return out


def _trajectory(path: Path, read_h5: Optional[Callable]) -> np.ndarray:
    """A savtpu trajectory artifact: the .npz sibling when savtpu wrote
    one, else the HDF5 file through ``read_h5``."""
    npz = path.with_suffix(".npz")
    if npz.exists():
        return np.load(npz)["Displacement"]
    if read_h5 is None:
        raise FileNotFoundError(
            f"{path}: an HDF5 trajectory needs a read_h5 callable"
        )
    return np.asarray(read_h5(path))


def import_savtpu_run(
    src_workdir,
    src_model_dir,
    n_parts: int,
    store: ArtifactStore,
    *,
    read_h5: Optional[Callable[[Path], np.ndarray]] = None,
    read_params: Optional[Callable[[Path, Dict], Dict]] = None,
    stages: Iterable[int] = (1, 2, 3),
) -> None:
    """Copy a savtpu run's artifacts of the given stages into ``store``.

    Stage 1: label CSVs, the steady VTK, Dynamics/Local-rank-<r> and the
    run log (metrics.jsonl, where stage 3 reads the stage-1 dt). Stage 2:
    sol_on_shared/rank=<r>-shared_dof. Stage 3: each rank's model and
    sidecar, with ``read_params(msgpack_path, sidecar)`` reading savtpu's
    flax msgpack into its parameter tree, which is stored under the
    port's names (:func:`params_from_savtpu`; savtpu's sidecar tag
    directory is ``store.tag``). The port's stage 3 or stage 4 then
    continues the
    run."""
    src = Path(src_workdir)
    src_models = Path(src_model_dir)
    stages = set(stages)
    if 1 in stages:
        for sub in ("Rankwised_Data", "Shared_Data", "Rankwised_Element",
                    "Static"):
            if (src / sub).exists():
                shutil.copytree(src / sub, store.workdir / sub,
                                dirs_exist_ok=True)
        store.workdir.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src / "metrics.jsonl",
                        store.workdir / "metrics.jsonl")
        for r in range(n_parts):
            save_displacement(
                store.dynamics_h5(r),
                _trajectory(src / "Dynamics" / f"Local-rank-{r}.hdf5",
                            read_h5),
            )
    if 2 in stages:
        for r in range(n_parts):
            save_displacement(
                store.shared_dof_h5(r),
                _trajectory(src / "sol_on_shared" /
                            f"rank={r}-shared_dof.hdf5", read_h5),
            )
    if 3 in stages:
        for r in range(n_parts):
            mf = src_models / f"Rank-{r}" / store.tag / "model.msgpack"
            meta = load_params_meta(mf)
            if read_params is None:
                raise FileNotFoundError(
                    f"{mf}: flax msgpack params need a read_params callable"
                )
            save_params(store.model_file(r),
                        params_from_savtpu(read_params(mf, meta), meta),
                        meta=meta)
