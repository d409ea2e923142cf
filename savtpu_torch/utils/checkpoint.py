"""Solver-state checkpoint and resume (port of
``savtpu/utils/checkpoint.py``).

The explicit runner persists its carry (d0, dn, tn, step index) every N
steps and resumes bit for bit: the update is a pure function of the
carry, so a restart from a saved carry reproduces the rest of the run.
Device tensors go to NumPy at a save; a load puts them back on the
run's device in its dtype. The compensated stepper's carry is already
folded (d = hi + lo, d_prev = d - v) when a run returns, and a chunked
run re-enters folded at every chunk boundary; the checkpointed runners
cut their chunks at the same steps whether or not they were interrupted,
so both carry identical states.

Under a device mesh the files hold the whole problem, as an emulated
run's do: rank 0 writes the carry and the recorded rows gathered from
every rank, and a resume gives each rank its block of the saved carry
(every rank reads the state file, which lies in the store, on one host).
So a checkpoint written under a mesh resumes emulated, and the other way
round.
"""

from __future__ import annotations

import shutil
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_solver_state(path: str | Path, d0, dn, tn: float, step: int,
                      extra: Optional[dict] = None) -> None:
    """Write the carry (and ``extra`` arrays) to ``path`` atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp,
        d0=_host(d0),
        dn=_host(dn),
        tn=np.asarray(tn),
        step=np.asarray(step),
        **{k: _host(v) for k, v in (extra or {}).items()},
    )
    tmp.replace(path)


def load_solver_state(path: str | Path
                      ) -> Tuple[np.ndarray, np.ndarray, float, int]:
    with np.load(Path(path)) as z:
        return z["d0"], z["dn"], float(z["tn"]), int(z["step"])


def restore_carry(sp, d0, dn, tn):
    """A loaded carry (d0, dn, tn) of the whole problem as the run's
    tensors: ShardedProblem ``sp``'s dtype, on its device; under a mesh
    the rank's block of it."""
    def as_t(a):
        a = np.asarray(a)
        if sp.comm is not None:
            a = sp.comm.block(a)
        return torch.as_tensor(a, dtype=sp.dtype).to(sp.device)

    return as_t(d0), as_t(dn), torch.tensor(float(tn), dtype=sp.dtype,
                                            device=sp.device)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class TrajStore:
    """Disk-backed (memmap) recorded-output buffers of a checkpointed run:
    the carry and every recorded row written so far live in ``ckpt_dir``,
    so a killed process resumes with its outputs intact. The "shared"
    buffer takes ``shared_dtype`` when given (stage 4 keeps its history
    window there in the window's own dtype). The buffers hold all ``P``
    parts; under a mesh (``comm``, a ``MeshComm``) rank 0 writes them from
    the rows every rank passes in, and each rank reads back its block."""

    def __init__(self, ckpt_dir, P, DL, S3, n_rec, n_shared, dtype,
                 want_traj, want_shared, shared_dtype=None, comm=None):
        self.comm = comm
        self.root = comm is None or comm.rank == 0
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.state_f = self.dir / "state.npz"
        self.dtypes = {"traj": _np_dtype(dtype),
                       "shared": _np_dtype(shared_dtype or dtype)}
        self.shapes = {
            "traj": (P, n_rec, DL) if want_traj else None,
            "shared": (P, n_shared, S3) if want_shared else None,
        }
        self.mm = {}

    def resume_step(self, expect: dict, resume: bool) -> tuple:
        """(start_step, extras dict): (0, {}) unless a state file exists
        whose ``expect`` entries equal the given values exactly (a changed
        configuration starts the run fresh)."""
        if resume and self.state_f.exists():
            try:
                with np.load(self.state_f) as z:
                    if all(
                        k in z and np.array_equal(z[k], v)
                        for k, v in expect.items()
                    ):
                        return int(z["step"]), {
                            k: np.array(z[k]) for k in z.files
                        }
            except (OSError, ValueError, EOFError, zipfile.BadZipFile):
                pass  # an unreadable state file: start fresh
        return 0, {}

    def _map(self, name, fresh):
        shape = self.shapes[name]
        if shape is None:
            return None
        mm = self.mm.get(name)
        if mm is None:
            f = self.dir / f"{name}.dat"
            mode = "w+" if (fresh or not f.exists()) else "r+"
            if not self.root:
                mode = "r"  # rank 0 made the file (open's barrier)
            mm = np.memmap(f, dtype=self.dtypes[name], mode=mode,
                           shape=shape)
            self.mm[name] = mm
        return mm

    def open(self, fresh: bool):
        if self.root:
            for name in ("traj", "shared"):
                self._map(name, fresh)
        if self.comm is not None:
            self.comm.barrier()
            for name in ("traj", "shared"):
                self._map(name, fresh)
        return self

    def _all(self, arr):
        """``arr`` of every part: under a mesh the ranks' blocks joined."""
        return arr if self.comm is None else self.comm.gather(_host(arr))

    def write(self, name, lo, arr):
        if self.shapes[name] is None:
            return
        arr = self._all(arr)
        if self.root:
            from .offload import fetch_into

            fetch_into(self.mm[name][:, lo : lo + arr.shape[1]], arr)

    def save_state(self, carry, step: int, expect: dict,
                   extras: Optional[dict] = None) -> None:
        d0, dn, tn = self._all(carry[0]), self._all(carry[1]), carry[2]
        if not self.root:
            return
        for mm in self.mm.values():
            if mm is not None:
                mm.flush()
        save_solver_state(
            self.state_f, d0, dn, float(tn), step,
            extra={**expect, **(extras or {})},
        )

    def result(self, name):
        """The rows written so far (under a mesh the rank's block, read
        once every rank has written)."""
        mm = self.mm.get(name)
        if mm is None:
            return None
        if self.comm is None:
            return np.asarray(mm)
        mm.flush()
        self.comm.barrier()
        return np.array(self.comm.block(mm))

    def cleanup(self):
        if self.comm is not None:
            self.comm.barrier()
        if self.root:
            shutil.rmtree(self.dir, ignore_errors=True)


def run_streamed_ckpt(
    solver,
    d0,
    dn,
    t0: float,
    num_steps: int,
    *,
    sync: bool = True,
    record: str = "traj",
    save_every: int = 1,
    ckpt_dir,
    ckpt_every: int,
    resume: bool = True,
    preds=None,
    verbose: bool = False,
):
    """``ShardedSolver.run_streamed`` with the carry and the recorded rows
    persisted at every ``ckpt_every``-step chunk boundary. A killed run
    called again with ``resume=True`` continues from the last completed
    chunk and gives the same bits as a run that was not interrupted (the
    chunk boundaries, the only places where the compensated stepper's lo
    word is folded, are fixed by ``ckpt_every``). Under a mesh the inputs
    and outputs are the rank's block, the files the whole problem's."""
    sp = solver.sp
    if ckpt_every % save_every:
        raise ValueError("ckpt_every must be a multiple of save_every")
    P = sp.n_parts if sp.comm is None else sp.comm.n_parts
    DL, S3 = sp.DL, sp.sld.shape[1]
    want_traj = record in ("all", "traj")
    want_shared = record in ("all", "shared")
    store = TrajStore(
        ckpt_dir, P, DL, S3, num_steps // save_every, num_steps,
        sp.dtype, want_traj, want_shared, comm=sp.comm,
    )
    expect = {
        "num_steps": num_steps, "save_every": save_every,
        "ckpt_every": ckpt_every, "P": P, "DL": DL, "sync": sync,
    }
    start, extras = store.resume_step(expect, resume)
    store.open(fresh=start == 0)
    carry = (d0, dn, torch.tensor(float(t0), dtype=sp.dtype,
                                  device=sp.device))
    if start:
        carry = restore_carry(sp, extras["d0"], extras["dn"], extras["tn"])
        if verbose:
            print(f"[checkpoint] resuming at step {start}/{num_steps}")

    i = start
    while i < num_steps:
        n = min(ckpt_every, num_steps - i)
        pc = None if preds is None else preds[:, i : i + n]
        (traj_c, shared_c), carry = solver.run(
            *carry, n, sync=sync, preds=pc, record=record,
            save_every=save_every,
        )
        if want_traj:
            store.write("traj", i // save_every, traj_c)
        if want_shared:
            store.write("shared", i, shared_c)
        i += n
        store.save_state(carry, i, expect)
    return (store.result("traj"), store.result("shared")), carry


def run_with_checkpoints(
    solver,
    d0,
    dn,
    t0: float,
    num_steps: int,
    ckpt_path: str | Path,
    ckpt_every: int,
    resume: bool = True,
    **run_kwargs,
):
    """Drive ShardedSolver.run in ckpt_every-step chunks, persisting the
    carry after each chunk; resumes from an existing checkpoint file.
    Returns (list of per-chunk (traj, shared) outputs, final carry,
    start_step actually computed from)."""
    sp = solver.sp
    ckpt_path = Path(ckpt_path)
    start = 0
    carry = (d0, dn, torch.tensor(float(t0), dtype=sp.dtype,
                                  device=sp.device))
    if resume and ckpt_path.exists():
        d0_np, dn_np, tn, start = load_solver_state(ckpt_path)
        carry = restore_carry(sp, d0_np, dn_np, tn)

    outputs = []
    i = start
    while i < num_steps:
        n = min(ckpt_every, num_steps - i)
        outs, carry = solver.run(*carry, n, **run_kwargs)
        outputs.append(outs)
        i += n
        save_solver_state(
            ckpt_path, carry[0], carry[1], float(carry[2]), i
        )
    return outputs, carry, start
