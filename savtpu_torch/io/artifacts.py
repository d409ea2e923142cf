"""Artifact contract (port of ``savtpu/io/artifacts.py``): the same paths
as the JAX package, so stages stay filesystem-connected and restartable.

    {workdir}/Rankwised_Data/Rank=<r>_local_nodes.csv
    {workdir}/Shared_Data/Rank=<r>_shared.csv, Global_shared.csv
    {workdir}/Rankwised_Element/Rank=<r>_elements.csv
    {workdir}/Static/steady_distributed.vtk
    {workdir}/Dynamics/Local-rank-<r>.npz
    {workdir}/sol_on_shared/rank=<r>-shared_dof.npz
    {model_dir}/Rank-<r>/<tag>/{model.npz, model.json}
    {model_dir}/Rank-<r>/<tag>/{train,test}_loss.csv, *_acc_{r2,rel}.csv
    {workdir}/Dynamics/Modeled_Local-rank-<r>.npz

Trajectories are ``.npz`` files with a 'Displacement' array of shape
(3*n_local, T) — the JAX package's own branch for a host without h5py.
Parameters are an ``.npz`` of named arrays beside the same JSON
architecture/scaling sidecar the JAX package writes next to its flax
msgpack (``convert.py`` carries those over). An LSTM's ``model.npz``
holds one array per leaf of the JAX package's parameter pytree, named by
its path with dots: ``encoder.<l>.fwd.Wi`` ... ``encoder.<l>.bwd.bh``,
``decoder.{Wi,Wh,bi,bh}``, ``fc.W``, ``fc.b`` and, for
target_mode="increment", ``ginc`` (``models/lstm.py``). An expfit's holds
its fit's arrays under their own names; a linear surrogate's ``lin.W``
and ``lin.b`` (the JAX package's ``{"lin": {"W", "b"}}``); a hybrid's
its expfit arrays under ``expfit.`` and its residual LSTM's under
``lstm.`` (the JAX package's ``{"expfit": ..., "lstm": ...}``). A seed
ensemble's arrays carry a leading member axis (E, ...), and its sidecar
says ``"ensemble": E``, as the JAX package's does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def save_displacement(path: str | Path, data: np.ndarray) -> Path:
    """Save a (3*n_local, T) trajectory under 'Displacement' (.npz)."""
    path = Path(path).with_suffix(".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, Displacement=np.asarray(data))
    return path


def load_displacement(path: str | Path) -> np.ndarray:
    return np.load(Path(path).with_suffix(".npz"))["Displacement"]


def flatten_params(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> {dotted path: array}; flat input passes
    through unchanged."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def subtree(params: Dict[str, np.ndarray], prefix: str
            ) -> Dict[str, np.ndarray]:
    """The arrays under ``prefix.`` of a flat dict, with the prefix
    dropped (a hybrid's "expfit" or "lstm" part)."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + ".")}


def save_params(path: str | Path, params: Dict,
                meta: Optional[Dict] = None) -> None:
    """Save a dict of arrays, flat or nested (stored under dotted paths),
    as .npz + JSON sidecar."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path.with_suffix(".npz"), **flatten_params(params))
    if meta is not None:
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2))


def load_params(path: str | Path) -> Dict[str, np.ndarray]:
    with np.load(Path(path).with_suffix(".npz")) as z:
        return {k: np.array(z[k]) for k in z.files}


def load_params_meta(path: str | Path) -> Dict:
    return json.loads(Path(path).with_suffix(".json").read_text())


class ArtifactStore:
    """Path book-keeping for one pipeline run."""

    def __init__(self, workdir, model_dir, tag: str):
        self.workdir = Path(workdir)
        self.model_dir = Path(model_dir)
        self.tag = tag

    # ---- stage 1 ----
    def local_nodes_csv(self, r: int) -> Path:
        return self.workdir / "Rankwised_Data" / f"Rank={r}_local_nodes.csv"

    def shared_csv(self, r: int) -> Path:
        return self.workdir / "Shared_Data" / f"Rank={r}_shared.csv"

    def global_shared_csv(self) -> Path:
        return self.workdir / "Shared_Data" / "Global_shared.csv"

    def elements_csv(self, r: int) -> Path:
        return self.workdir / "Rankwised_Element" / f"Rank={r}_elements.csv"

    def steady_vtk(self) -> Path:
        return self.workdir / "Static" / "steady_distributed.vtk"

    def dynamics_h5(self, r: int) -> Path:
        return self.workdir / "Dynamics" / f"Local-rank-{r}.npz"

    # ---- stage 2 ----
    def shared_dof_h5(self, r: int) -> Path:
        return self.workdir / "sol_on_shared" / f"rank={r}-shared_dof.npz"

    # ---- stage 3 ----
    def model_run_dir(self, r: int) -> Path:
        return self.model_dir / f"Rank-{r}" / self.tag

    def model_file(self, r: int) -> Path:
        return self.model_run_dir(r) / "model.npz"

    # ---- stage 4 ----
    def modeled_h5(self, r: int) -> Path:
        return self.workdir / "Dynamics" / f"Modeled_Local-rank-{r}.npz"

    # ---- helpers ----
    def ckpt_dir(self, stage: str) -> Path:
        """A stage's mid-run checkpoint directory (utils/checkpoint.py)."""
        return self.workdir / "Checkpoints" / stage

    def save_int_csv(self, path: Path, arr) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savetxt(path, np.asarray(arr, dtype=np.int64), delimiter=",",
                   fmt="%d")

    @staticmethod
    def load_int_csv(path: Path) -> np.ndarray:
        return np.atleast_1d(
            np.genfromtxt(path, delimiter=",").astype(np.int64)
        )

    def save_training_curves(self, r: int, hist: Dict) -> None:
        """CSV (and, where matplotlib is installed, PNG) training curves
        (Model_training.py:143-175), under the JAX package's file names."""
        d = self.model_run_dir(r)
        d.mkdir(parents=True, exist_ok=True)
        names = {
            "train_loss": "train_loss.csv",
            "val_loss": "test_loss.csv",
            "train_r2": "train_acc_r2.csv",
            "val_r2": "test_acc_r2.csv",
            "train_rel": "train_acc_rel.csv",
            "val_rel": "test_acc_rel.csv",
        }
        for key, fname in names.items():
            if hist.get(key):
                np.savetxt(d / fname, np.asarray(hist[key]), delimiter=",")
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig = plt.figure(figsize=(16, 8))
        plt.subplot(1, 2, 1)
        plt.semilogy(hist["train_loss"], label="train")
        if hist.get("val_loss"):
            plt.semilogy(hist["val_loss"], label="test")
        plt.xlabel("epoch")
        plt.legend()
        plt.subplot(1, 2, 2)
        for key, lbl in [("train_r2", "train:R2"), ("val_r2", "test:R2"),
                         ("train_rel", "train:Rel"), ("val_rel", "test:Rel")]:
            if hist.get(key):
                plt.plot(hist[key], label=lbl)
        plt.xlabel("epoch")
        plt.legend()
        fig.savefig(d / "train-test-loss-acc.png")
        plt.close(fig)
