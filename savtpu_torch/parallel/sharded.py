"""Stacked-part explicit solver on one device (port of
``savtpu/parallel/sharded.py``).

Every per-part tensor carries a leading part axis; the halo exchange is
the psum semantics of the JAX package emulated over that axis: each part's
interface-force contributions are summed per global shared DOF (exactly
FEM interface assembly) and written back to every owner. Interior DOFs
have a single owner and never move.

Ported here: the ``dense``, ``banded`` and ``pallas`` internal-force
modes (``auto`` picks dense up to DL = 1536 local DOFs, banded beyond),
the psum exchange, the plain and compensated (double-word) steppers with
prediction overwrite and in-loop ``save_every`` recording, and the
comm-free online block, which in banded compensated mode runs as one
hand-written kernel (``ops/online_banded.py``). The generic time loop is
one step function (``ShardedProblem._step``) run two ways: on a CUDA
device from captured CUDA graphs of up to ``GRAPH_STEPS`` steps each,
replayed with no host work inside (the counterpart of the JAX package's
jitted ``lax.scan``), and on the CPU as an eager Python loop. The JAX
package's ``shard_map`` device meshes, the other force modes and the
permute/grid exchanges wait for later slices.

``pallas`` is dense local K whose products go through the port's
hand-written kernels (``ops/dense_step.py``): K1 for each step's F_int,
and K2 for a whole comm-free run when ``ShardedSolver.run``'s gate allows.
Its layout is the dense one: the JAX package pads DL to a multiple of 128
for the TPU's lanes, which a CUDA kernel does not need, so here DL stays
3 L_max + 1. Banded comm-free runs without recording go to K4
(``ops/banded_scan.py``) under the same kind of gate.

Padding: per-part arrays are padded to the max part size; padded scatter
targets point at a dummy DOF slot (index DL-1) that is zeroed every step.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import banded_scan, dense_step, kernels
from ..ops.dense_step import batched_fint_matvec
from ..ops.material import linear_ramp
from ..ops.online_banded import band_matvec, online_chunk
from .halo import PartitionMaps, local_cells_of, rcm_reorder_maps

# the JAX package's internal-force modes, and those ported here
FINT_MODES = frozenset(
    {"auto", "dense", "banded", "ell", "ebe", "pallas", "nh", "stencil"})
PORTED_FINT_MODES = frozenset({"auto", "dense", "banded", "pallas"})

# run_streamed's chunk plan (the JAX package's): at most this many steps,
# or this many bytes of recorded trajectory, per chunk
MAX_CHUNK_STEPS = 25_000
HOST_TRAJ_BUDGET_BYTES = 1 << 28

# the stepper's CUDA graphs: at most this many steps per captured chunk
GRAPH_STEPS = 100


def _build_banded(npn, DLp, edofs, Ke, chunk_quantum=256):
    """Block-tridiagonal storage of per-part local stiffness (requires
    RCM-ordered local DOFs so the bandwidth is small). Chunk size Bk is
    the bandwidth rounded up to ``chunk_quantum``; symmetry lets the
    super-diagonal be the transposed next sub-diagonal. Host float64."""
    band = 1
    for p in range(npn):
        ed = edofs[p]
        real = ed[:, 0] < DLp  # padded rows point at the dummy slot
        if real.any():
            e = ed[real]
            band = max(
                band, int((e.max(axis=1) - e.min(axis=1)).max(initial=1))
            )
    Bk = -(-band // chunk_quantum) * chunk_quantum
    nc = -(-DLp // Bk)
    Kd = np.zeros((npn, nc, Bk, Bk), dtype=np.float64)
    Kl = np.zeros((npn, nc, Bk, Bk), dtype=np.float64)
    for p in range(npn):
        ed = edofs[p]
        real = ed[:, 0] < DLp
        e = ed[real].astype(np.int64)
        nb3 = e.shape[1]
        rows = np.repeat(e, nb3, axis=1).reshape(-1)
        cols = np.tile(e, (1, nb3)).reshape(-1)
        vals = Ke[p][real].reshape(-1)
        rc, ro = np.divmod(rows, Bk)
        cc, co = np.divmod(cols, Bk)
        size = nc * Bk * Bk
        lin = (rc * Bk + ro) * Bk + co
        diag = rc == cc
        Kd[p] += np.bincount(
            lin[diag], weights=vals[diag], minlength=size
        ).reshape(nc, Bk, Bk)
        low = rc == cc + 1
        Kl[p] += np.bincount(
            lin[low], weights=vals[low], minlength=size
        ).reshape(nc, Bk, Bk)
    return Kd, Kl, nc, Bk


def _owner_table(sgi: np.ndarray, smask: np.ndarray, SD: int) -> np.ndarray:
    """(SD, K) flat (part * S3 + slot) indices of every owner of each
    global shared DOF, in increasing flat order, padded with P * S3 (an
    appended zero). Summing over K in column order adds the owners'
    contributions in the same order as a sequential scatter-add."""
    flat = np.flatnonzero(np.asarray(smask).reshape(-1) > 0)
    g = np.asarray(sgi).reshape(-1)[flat]
    order = np.argsort(g, kind="stable")
    g, flat = g[order], flat[order]
    counts = np.bincount(g, minlength=SD)
    K = max(int(counts.max(initial=1)), 1)
    table = np.full((SD, K), sgi.size, dtype=np.int64)
    offs = np.zeros(SD + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts)
    slot = np.arange(len(g)) - offs[g]
    table[g, slot] = flat
    return table


@dataclass
class ShardedProblem:
    """Padded, stacked (leading part axis) tensors of a partitioned
    problem on one device. Built once on the host from an
    AssembledProblem + PartitionMaps."""

    n_parts: int
    DL: int                      # padded local DOF count + 1 dummy slot
    SD: int                      # 3 * |global shared nodes|
    dt: float
    alpha: float
    ramped: bool
    local_dofs_global: np.ndarray  # (P, 3*L_max) global DOF of local slot
    dof_mask: torch.Tensor       # (P, DL) 1 on real local slots
    bc_mask: torch.Tensor        # (P, DL) 0 on Dirichlet + pad + dummy
    lM: torch.Tensor             # (P, DL) lumped mass (pad -> 1)
    F_pre: torch.Tensor          # (P, DL) pre-assembled external force
    sld: torch.Tensor            # (P, 3*S_max) shared local DOF (pad DL-1)
    sgi: torch.Tensor            # (P, 3*S_max) index into global shared
    smask: torch.Tensor          # (P, 3*S_max) 1 on real shared slots
    owners: torch.Tensor         # (SD, K) flat owner slots (_owner_table)
    fint_mode: str = "dense"
    # double-word (hi, lo) state plus the exact last increment; see the
    # compensated branch of stacked_run
    compensated: bool = False
    maps: Optional[PartitionMaps] = None
    denseK: Optional[torch.Tensor] = None   # (P, DL, DL) (fint 'dense')
    band_Kd: Optional[torch.Tensor] = None  # (P, nc, Bk, Bk) diagonal
    band_Kl: Optional[torch.Tensor] = None  # (P, nc, Bk, Bk) sub-diagonal;
                                            # super-diag = Kl[i+1]^T (sym)
    # the stepper's cached graph chunks (_StepChunk), by flags and shapes
    _graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.lM.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lM.dtype

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        prob,                    # AssembledProblem (serial numbering)
        maps: PartitionMaps,
        fint_mode: str = "auto",
        dtype=None,
        exchange_mode: str = "psum",
        compensated: bool = False,
        shared_order=None,
        device="cpu",
    ) -> "ShardedProblem":
        """``shared_order``: optional per-part arrays of global node ids —
        a permutation of each part's shared-node set — fixing the shared
        CHANNEL order of sld/sgi/smask, so stage reruns stay compatible
        with traces and models already on disk."""
        if fint_mode not in FINT_MODES:
            raise ValueError(
                f"unknown fint_mode {fint_mode!r}; expected one of "
                f"{sorted(FINT_MODES)}"
            )
        if fint_mode not in PORTED_FINT_MODES:
            raise NotImplementedError(
                f"fint_mode {fint_mode!r} is not ported yet; use one of "
                f"{sorted(PORTED_FINT_MODES)}"
            )
        if exchange_mode != "psum":
            raise NotImplementedError(
                f"exchange_mode {exchange_mode!r} is not ported yet; use "
                "'psum'"
            )
        if prob.deg != 1:
            raise NotImplementedError("the dynamic path is P1-only")
        if fint_mode == "auto":
            # dense for small local blocks, block-tridiagonal beyond
            DL_est = 3 * maps.max_local_nodes + 1
            fint_mode = "dense" if DL_est <= 1536 else "banded"
        if fint_mode == "banded":
            # banded storage needs small local bandwidth: RCM-reorder the
            # local node lists first (sp.maps is then authoritative)
            maps = rcm_reorder_maps(maps, prob.mesh.tetra)
        if shared_order is not None:
            so = [np.asarray(s, dtype=np.int64) for s in shared_order]
            for p in range(maps.n_parts):
                if not np.array_equal(
                    np.sort(so[p]), np.sort(np.asarray(maps.shared_nodes[p]))
                ):
                    raise ValueError(
                        f"shared_order for part {p} is not a permutation "
                        f"of that part's shared-node set"
                    )
            maps = dataclasses.replace(maps, shared_nodes=so)
        npn = maps.n_parts
        dtype = dtype or prob.lumped_M.dtype
        L_max = maps.max_local_nodes
        DL = 3 * L_max + 1
        S_max = max(maps.max_shared, 1)
        SG = max(len(maps.global_shared), 1)
        SD = 3 * SG

        Ke_np = prob.Ke.numpy()
        cells = np.asarray(prob.mesh.tetra)
        E_max = max(len(e) for e in maps.local_elements)
        nb3 = Ke_np.shape[1]

        local_dofs_global = np.zeros((npn, 3 * L_max), dtype=np.int64)
        dof_mask = np.zeros((npn, DL), dtype=np.float64)
        bc_mask = np.zeros((npn, DL), dtype=np.float64)
        lM = np.ones((npn, DL), dtype=np.float64)
        F_pre = np.zeros((npn, DL), dtype=np.float64)
        edofs = np.full((npn, E_max, nb3), DL - 1, dtype=np.int32)
        Ke = np.zeros((npn, E_max, nb3, nb3), dtype=np.float64)
        sld = np.full((npn, 3 * S_max), DL - 1, dtype=np.int64)
        sgi = np.zeros((npn, 3 * S_max), dtype=np.int64)
        smask = np.zeros((npn, 3 * S_max), dtype=np.float64)

        gshared_pos = {int(g): i for i, g in enumerate(maps.global_shared)}
        lumped_np = prob.lumped_M.numpy()
        fpre_np = prob.F_pre.numpy()
        scratch = np.full(prob.mesh.num_points, -1, dtype=np.int64)

        for p in range(npn):
            nodes = maps.local_nodes[p]
            ln = len(nodes)
            gdofs = (3 * nodes[:, None] + np.arange(3)).reshape(-1)
            local_dofs_global[p, : 3 * ln] = gdofs
            dof_mask[p, : 3 * ln] = 1.0
            bc_mask[p, : 3 * ln] = 1.0
            bc_mask[p, maps.local_dirichlet[p]] = 0.0
            lM[p, : 3 * ln] = lumped_np[gdofs]
            F_pre[p, : 3 * ln] = fpre_np[gdofs]

            elems = maps.local_elements[p]
            loc_cells = local_cells_of(nodes, cells, elems, scratch)
            ed = (3 * loc_cells[:, :, None] + np.arange(3)).reshape(
                len(elems), nb3
            )
            edofs[p, : len(elems)] = ed
            Ke[p, : len(elems)] = Ke_np[elems]

            sh = maps.shared_nodes[p]
            loc_sh = maps.local_index_of(p, sh)
            sdofs = (3 * loc_sh[:, None] + np.arange(3)).reshape(-1)
            gsh = np.array(
                [gshared_pos[int(g)] for g in sh], dtype=np.int64
            )
            gsdofs = (3 * gsh[:, None] + np.arange(3)).reshape(-1)
            sld[p, : len(sdofs)] = sdofs
            sgi[p, : len(sdofs)] = gsdofs
            smask[p, : len(sdofs)] = 1.0

        dev = torch.device(device)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)  # noqa: E731
        denseK = band_Kd = band_Kl = None
        if fint_mode == "banded":
            Kd, Kl, _, _ = _build_banded(npn, 3 * L_max, edofs, Ke)
            band_Kd, band_Kl = as_t(Kd), as_t(Kl)
        else:
            dk = np.zeros((npn, DL, DL), dtype=np.float64)
            for p in range(npn):
                np.add.at(
                    dk[p],
                    (edofs[p][:, :, None], edofs[p][:, None, :]),
                    Ke[p],
                )
            dk[:, DL - 1, :] = 0.0
            dk[:, :, DL - 1] = 0.0
            denseK = as_t(dk)

        return cls(
            n_parts=npn,
            DL=DL,
            SD=SD,
            dt=float(prob.dt),
            alpha=float(prob.alpha),
            ramped=bool(prob.material.ramped),
            local_dofs_global=local_dofs_global,
            dof_mask=as_t(dof_mask),
            bc_mask=as_t(bc_mask),
            lM=as_t(lM),
            F_pre=as_t(F_pre),
            sld=torch.as_tensor(sld).to(dev),
            sgi=torch.as_tensor(sgi).to(dev),
            smask=as_t(smask),
            owners=torch.as_tensor(_owner_table(sgi, smask, SD)).to(dev),
            fint_mode=fint_mode,
            compensated=compensated,
            maps=maps,
            denseK=denseK,
            band_Kd=band_Kd,
            band_Kl=band_Kl,
        )

    # ------------------------------------------------------------------
    def localize(self, vec) -> torch.Tensor:
        """(ndof,) global vector -> (P, DL) stacked local vectors."""
        vec = np.asarray(torch.as_tensor(vec).cpu()).reshape(-1)
        out = np.zeros((self.n_parts, self.DL), dtype=vec.dtype)
        dm = self.dof_mask.cpu().numpy()
        for p in range(self.n_parts):
            n_real = int(dm[p].sum())
            out[p, :n_real] = vec[self.local_dofs_global[p, :n_real]]
        return torch.as_tensor(out, dtype=self.dtype).to(self.device)

    # ------------------------------------------------------------------
    # stacked step machinery (leading axis = parts)
    # ------------------------------------------------------------------
    def _fint_stacked(self, d: torch.Tensor) -> torch.Tensor:
        """F_int = K_local d for every part, (P, DL) -> (P, DL)."""
        if self.fint_mode == "dense":
            return torch.bmm(self.denseK, d[:, :, None])[:, :, 0]
        if self.fint_mode == "pallas":
            # K1 (ops/dense_step.py), once per step
            return batched_fint_matvec(self.denseK, d)
        # block-tridiagonal matvec on the RCM-ordered local DOFs
        P = d.shape[0]
        _, nc, Bk, _ = self.band_Kd.shape
        n = self.DL - 1
        x = d.new_zeros((P, nc * Bk))
        x[:, :n] = d[:, :n]
        y = band_matvec(self.band_Kd, self.band_Kl, x)
        out = d.new_zeros((P, self.DL))
        out[:, :n] = y[:, :n]
        return out

    def _shared_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """(P, S3) per-slot values -> (SD,) sums over each global shared
        DOF's owners, added in increasing (part, slot) order."""
        flat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
        g = flat[self.owners]  # (SD, K)
        tot = vals.new_zeros((self.SD,))
        for k in range(g.shape[1]):
            tot = tot + g[:, k]
        return tot

    def _exchange(self, F_int: torch.Tensor) -> torch.Tensor:
        """psum halo exchange over the stacked part axis: every owner of a
        shared DOF receives the sum of all owners' contributions."""
        vals = torch.gather(F_int, 1, self.sld) * self.smask
        tot = self._shared_sum(vals)
        return F_int.scatter(1, self.sld, tot[self.sgi])

    def _translation_mean(self, d: torch.Tensor) -> torch.Tensor:
        """Per-part, per-component mean displacement as a (P, DL) uniform
        translation field (pad/dummy slots zero).

        Every element stiffness annihilates rigid translations, so
        K (d - tbar) == K d exactly — but only in exact arithmetic:
        rounding K to f32 breaks the row nullspace, and K_f32 tbar is the
        dominant systematic matvec error in compensated mode. Subtracting
        tbar before the product removes it."""
        P, DL = d.shape
        n3 = self.local_dofs_global.shape[1]
        L = n3 // 3
        m = self.dof_mask[:, :n3].reshape(P, L, 3)
        dm = (d[:, :n3] * self.dof_mask[:, :n3]).reshape(P, L, 3)
        mean = dm.sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        tbar = torch.cat(
            [mean.repeat(1, L), d.new_zeros((P, DL - n3))], dim=1
        )
        return tbar * self.dof_mask

    def _update(self, d0, dn, tn, F_int):
        """Central-difference step with mass-proportional damping."""
        dt, alpha = self.dt, self.alpha
        ramp = linear_ramp(tn) if self.ramped else torch.ones_like(tn)
        F_ext = self.F_pre * ramp
        lM = self.lM
        d1 = (
            dt * dt * (F_ext - F_int)
            + 2.0 * lM * d0
            - lM * dn
            + 0.5 * dt * alpha * lM * dn
        ) / (lM + 0.5 * alpha * dt * lM)
        return d1 * self.bc_mask

    def _gather_shared(self, d: torch.Tensor) -> torch.Tensor:
        """(P, DL) -> (P, 3*S_max) shared rows (pad slots 0)."""
        return torch.gather(d, 1, self.sld) * self.smask

    def _scatter_pred(self, d1: torch.Tensor, pred_row: torch.Tensor):
        """Overwrite shared DOFs with the prediction; padded slots land in
        the dummy slot, which is zeroed."""
        out = d1.scatter(1, self.sld, pred_row)
        out[:, self.DL - 1] = 0.0
        return out

    # ------------------------------------------------------------------
    def _online_ok(self, sync, preds, record, save_every, num_steps) -> bool:
        """Gate for the online kernel (ops/online_banded.py): the
        production comm-free block — banded, compensated state, per-step
        prediction overwrite, full recording."""
        return (
            not sync
            and preds is not None
            and record == "all"
            and self.compensated
            and self.fint_mode == "banded"
            and save_every >= 1
            and num_steps % save_every == 0
        )

    def _online_run(self, d0, dn, t0, num_steps, preds, save_every,
                    chunk_steps=None):
        """Comm-free online block through ``online_chunk`` on the
        kernel's (P, nc*Bk) layout, in sub-chunks of ``chunk_steps``
        (a multiple of save_every; default: the whole block). The state
        (hi, lo, v) passes between sub-chunks unrounded, so chunking
        never changes the result. Returns ((traj, shared), carry) in the
        stepper's shapes."""
        P, DL = d0.shape
        _, nc, Bk, _ = self.band_Kd.shape
        DLB = nc * Bk
        n = min(DL - 1, DLB)
        dtype = d0.dtype

        def fit(vv, fill=0.0):
            out = torch.full((P, DLB), fill, dtype=dtype, device=d0.device)
            out[:, :n] = vv[:, :n].to(dtype)
            return out

        d0c = d0 * self.bc_mask
        dnc = dn * self.bc_mask
        hi = fit(d0c)
        lo = fit(torch.zeros_like(d0))
        v = fit(d0c - dnc)
        Fp = fit(self.F_pre)
        lM = fit(self.lM, 1.0)
        bc = fit(self.bc_mask)
        dm = fit(self.dof_mask)
        smask = self.smask.to(dtype)

        Tc = num_steps if chunk_steps is None else int(chunk_steps)
        if Tc < save_every or Tc % save_every:
            raise ValueError(
                f"chunk_steps ({Tc}) must be a positive multiple of "
                f"save_every ({save_every})"
            )
        traj_parts, shared_parts = [], []
        done = 0
        while done < num_steps:
            tc_k = min(Tc, num_steps - done)
            pc = (preds[:, done : done + tc_k, :].to(dtype)
                  * smask[:, None, :]).contiguous()
            hi, lo, v, shared, traj_c = online_chunk(
                self.band_Kd, self.band_Kl, hi, lo, v, Fp, lM, bc, dm,
                self.sld, smask, pc,
                t0=t0, i0=done, dt=self.dt, alpha=self.alpha,
                ramped=self.ramped, save_every=save_every,
            )
            shared_parts.append(shared)
            tr = torch.zeros((P, traj_c.shape[1], DL), dtype=dtype,
                             device=d0.device)
            tr[:, :, :n] = traj_c[:, :, :n]
            traj_parts.append(tr)
            done += tc_k

        traj = torch.cat(traj_parts, dim=1)
        shared = torch.cat(shared_parts, dim=1)

        def unfit(vv):
            out = torch.zeros((P, DL), dtype=dtype, device=d0.device)
            out[:, :n] = vv[:, :n]
            return out

        d1 = unfit(hi + lo)
        dn1 = unfit((hi + lo) - v)
        i_f = torch.tensor(float(num_steps), dtype=dtype, device=d0.device)
        dtc = torch.tensor(self.dt, dtype=dtype, device=d0.device)
        return (traj, shared), (d1, dn1, t0 + dtc * i_f)

    # ------------------------------------------------------------------
    def stacked_run(
        self,
        d0,
        dn,
        t0,
        num_steps: int,
        *,
        sync: bool,
        preds=None,              # (P, num_steps, 3*S_max) if not sync
        record: str = "all",     # "all" | "traj" | "shared" | "none"
        save_every: int = 1,
    ):
        """Step ``num_steps`` times. Returns ((traj, shared_trace), carry)
        with carry = (d_last, d_prev, t); recorded entries are None when
        not requested.

        The trajectory records d1 of every step i with i % save_every ==
        0, shape (P, num_steps // save_every, DL); the shared-DOF trace is
        recorded at every step, shape (P, num_steps, 3*S_max).

        On a CUDA device the step loop replays from CUDA graphs
        (:meth:`_stacked_run_chunked`); on the CPU it is the eager loop
        (:meth:`_stacked_run_eager`). Both run the same step, so they give
        the same bits."""
        if num_steps % save_every:
            raise ValueError(
                f"num_steps ({num_steps}) must be divisible by "
                f"save_every ({save_every})"
            )
        t0 = torch.as_tensor(t0, dtype=d0.dtype).to(d0.device)

        if self._online_ok(sync, preds, record, save_every, num_steps):
            return self._online_run(d0, dn, t0, num_steps, preds,
                                    save_every)
        run = (self._stacked_run_chunked
               if d0.device.type == "cuda" and num_steps > 0
               else self._stacked_run_eager)
        return run(d0, dn, t0, num_steps, sync=sync, preds=preds,
                   record=record, save_every=save_every)

    # The step of the generic loop. Its state is (d, d_prev, t) for the
    # plain stepper and (d_hi, d_lo, v, i) for the compensated one; each
    # step returns the new state and the displacement it records.
    def _init_state(self, d0, dn, t0):
        if not self.compensated:
            return (d0, dn, t0)
        # Dirichlet slots are clamped once here; the per-step mask only
        # touches the increment
        d_hi = d0 * self.bc_mask
        return (d_hi, torch.zeros_like(d0), d_hi - dn * self.bc_mask,
                torch.zeros((), dtype=d0.dtype, device=d0.device))

    def _step_constants(self, dtype, dev):
        """The compensated step's scalars as tensors on the device (made
        before a graph capture, which allows no host-to-device copy)."""
        if not self.compensated:
            return None
        beta = 0.5 * float(self.alpha) * float(self.dt)
        c1 = torch.tensor((1.0 - beta) / (1.0 + beta), dtype=dtype,
                          device=dev)
        c2 = torch.tensor(float(self.dt) ** 2 / (1.0 + beta), dtype=dtype,
                          device=dev)
        dtc = torch.tensor(self.dt, dtype=dtype, device=dev)
        one = torch.ones((), dtype=dtype, device=dev)
        return c1, c2, dtc, one

    def _step(self, state, pred_row, sync, consts, t0):
        F_of = self._fint_stacked
        if not self.compensated:
            d0c, dnc, tn = state
            F_int = F_of(d0c)
            if sync:
                F_int = self._exchange(F_int)
            d1 = self._update(d0c, dnc, tn, F_int)
            if pred_row is not None:
                d1 = self._scatter_pred(d1, pred_row)
            return (d1, d0c, tn + self.dt), d1
        # Compensated (double-word) integration. The update is recast in
        # incremental form: with beta = alpha*dt/2 and v_n = d_n - d_{n-1},
        #   d_{n+1} = d_n + [ (1-beta)*v_n + dt^2*(F_ext-F_int)/M ]
        #             / (1+beta)
        # (algebraically identical to _update). The increment delta is
        # small relative to d, so it is accurate in f32; the state roll
        # d + delta is an error-free TwoSum into an unevaluated (hi, lo)
        # pair. v is carried as the applied increment.
        c1, c2, dtc, one = consts
        d_hi, d_lo, v, i = state
        F_int = F_of(d_hi - self._translation_mean(d_hi))
        if sync:
            F_int = self._exchange(F_int)
        # t from the step index (one rounding) instead of a running
        # accumulation
        tn = t0 + dtc * i
        ramp = linear_ramp(tn) if self.ramped else one
        delta = (
            c1 * v + c2 * ((self.F_pre * ramp - F_int) / self.lM)
        ) * self.bc_mask
        if pred_row is not None:
            # overwrite shared DOFs with the prediction: in incremental
            # form the increment at a shared slot is pred - current
            cur = (torch.gather(d_hi, 1, self.sld)
                   + torch.gather(d_lo, 1, self.sld))
            tgt = (pred_row - cur) * self.smask
            delta = delta.scatter(1, self.sld, tgt)
            delta[:, self.DL - 1] = 0.0
        # TwoSum(d_hi, delta) + renormalize (Knuth/Dekker EFTs)
        s = d_hi + delta
        z = s - d_hi
        e = (d_hi - (s - z)) + (delta - z)
        lo = d_lo + e
        d_hi = s + lo
        d_lo = lo - (d_hi - s)
        return (d_hi, d_lo, delta, i + one), d_hi

    def _carry(self, state, t0, consts):
        if not self.compensated:
            return state
        d_hi, d_lo, v, i = state
        d1 = d_hi + d_lo
        return (d1, d1 - v, t0 + consts[2] * i)

    def _steps(self, state, num_steps, preds, sync, consts, t0, *,
               want_traj, want_shared, save_every):
        """``num_steps`` steps from ``state``; returns the new state, the
        trajectory rows (every save_every-th step) and the shared rows
        (every step), stacked, or None where not wanted."""
        traj, shared = [], []
        for k in range(num_steps):
            state, rec = self._step(
                state, None if preds is None else preds[:, k, :], sync,
                consts, t0)
            if want_traj and k % save_every == 0:
                traj.append(rec)
            if want_shared:
                shared.append(self._gather_shared(rec))
        return (state,
                torch.stack(traj, dim=1) if want_traj else None,
                torch.stack(shared, dim=1) if want_shared else None)

    def _stacked_run_eager(self, d0, dn, t0, num_steps, *, sync, preds,
                           record, save_every):
        """The step loop as eager tensor ops: the CPU path, and on the card
        the reference the graph path is held against."""
        consts = self._step_constants(d0.dtype, d0.device)
        state, traj, shared = self._steps(
            self._init_state(d0, dn, t0), num_steps, preds, sync, consts,
            t0, want_traj=record in ("all", "traj"),
            want_shared=record in ("all", "shared"), save_every=save_every)
        return (traj, shared), self._carry(state, t0, consts)

    def _stacked_run_chunked(self, d0, dn, t0, num_steps, *, sync, preds,
                             record, save_every, graph_steps=None):
        """The step loop in chunks of G steps (:func:`graph_chunks`), each
        a :class:`_StepChunk` whose static buffers carry the state, t0 and
        the chunk's predictions in and its recordings out. On a CUDA device
        every chunk is a captured CUDA graph, cached on the problem by the
        run's flags, its length and its shapes, and replayed; on the CPU
        (the tests) the chunk's body runs directly. If a capture fails the
        run raises."""
        G, n_full, rem = graph_chunks(num_steps, save_every,
                                      graph_steps or GRAPH_STEPS)
        P, DL, S3 = d0.shape[0], self.DL, self.sld.shape[1]
        dtype, dev = d0.dtype, d0.device
        want_traj = record in ("all", "traj")
        want_shared = record in ("all", "shared")
        traj = (torch.empty((P, num_steps // save_every, DL), dtype=dtype,
                            device=dev) if want_traj else None)
        shared = (torch.empty((P, num_steps, S3), dtype=dtype, device=dev)
                  if want_shared else None)
        state = self._init_state(d0, dn, t0)
        done = 0
        for n in [G] * n_full + ([rem] if rem else []):
            chunk = self._chunk(n, state, t0, sync=sync,
                                has_preds=preds is not None,
                                want_traj=want_traj, want_shared=want_shared,
                                save_every=save_every)
            state = chunk.run(state, t0, None if preds is None
                              else preds[:, done : done + n])
            if want_traj:
                traj[:, done // save_every : (done + n) // save_every] = (
                    chunk.traj)
            if want_shared:
                shared[:, done : done + n] = chunk.shared
            done += n
        state = tuple(s.clone() for s in state)
        consts = self._step_constants(dtype, dev)
        return (traj, shared), self._carry(state, t0, consts)

    def _chunk(self, n, state, t0, **flags):
        """The cached :class:`_StepChunk` of ``n`` steps for these flags,
        shapes and problem tensors (made on first use)."""
        tensors = (self.denseK, self.band_Kd, self.band_Kl, self.F_pre,
                   self.lM, self.bc_mask, self.dof_mask, self.sld, self.sgi,
                   self.smask, self.owners)
        key = (n, tuple(sorted(flags.items())), self.compensated,
               self.fint_mode, self.dt, self.alpha, self.ramped,
               t0.dtype, str(t0.device),
               tuple(tuple(s.shape) for s in state),
               tuple(None if t is None else t.data_ptr() for t in tensors))
        chunk = self._graphs.get(key)
        if chunk is None:
            chunk = _StepChunk(self, n, state, t0, **flags)
            self._graphs[key] = chunk
        return chunk


# the kernel wrappers a step may launch: their counts add the captured
# launches at every replay
COUNTED_KERNELS = (batched_fint_matvec,)


class _StepChunk:
    """``n`` steps of ``ShardedProblem._step`` on static buffers: the state
    and t0 in (copied back in place at the chunk's end, so the next run
    continues from it), the chunk's prediction rows in, its trajectory
    rows and shared rows out.

    On a CUDA device the body is captured once into a CUDA graph and
    every :meth:`run` replays it; the kernel wrappers' counts (which the
    capture moved without launching anything) are restored, and each
    replay adds the launches it captured. A port kernel must have its
    library loaded before the capture (``nvcc`` and ``ctypes`` cannot run
    inside one); cuBLAS (dense and banded products) is set up by one eager
    step on the capture stream, which launches no counted kernel."""

    def __init__(self, sp, n, state, t0, *, sync, has_preds, want_traj,
                 want_shared, save_every):
        # a weak reference: the problem caches its chunks, and a cycle
        # would leave a dead problem's graphs to the cyclic collector,
        # which may run (and destroy a graph) during another capture
        self._sp = weakref.ref(sp)
        self.n, self.sync, self.save_every = n, sync, save_every
        self.want_traj, self.want_shared = want_traj, want_shared
        self.state = tuple(s.clone() for s in state)
        self.t0 = t0.clone()
        dtype, dev = t0.dtype, t0.device
        P, S3 = self.state[0].shape[0], sp.sld.shape[1]
        self.preds = (torch.zeros((P, n, S3), dtype=dtype, device=dev)
                      if has_preds else None)
        self.consts = sp._step_constants(dtype, dev)
        self.traj = self.shared = None
        self.graph, self.captured = None, {}
        if dev.type == "cuda":
            self._capture(dev)

    @property
    def sp(self):
        return self._sp()

    def _body(self):
        state, self.traj, self.shared = self.sp._steps(
            self.state, self.n, self.preds, self.sync, self.consts, self.t0,
            want_traj=self.want_traj, want_shared=self.want_shared,
            save_every=self.save_every)
        # back into the static state, last entry first: the plain state's
        # new d_prev is the old d, which for n = 1 is the static d itself
        for dst, src in reversed(list(zip(self.state, state))):
            if src is not dst:
                dst.copy_(src)

    def _capture(self, dev):
        sp = self.sp
        if sp.fint_mode == "pallas":
            kernels.load("dense_step")
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        if sp.fint_mode in ("dense", "banded"):
            with torch.cuda.stream(stream):
                sp._step(self.state, None if self.preds is None
                         else self.preds[:, 0, :], self.sync, self.consts,
                         self.t0)
        before = {fn: fn.launches for fn in COUNTED_KERNELS}
        self.graph = torch.cuda.CUDAGraph()
        # no collection during the capture: destroying any CUDA graph then
        # would invalidate it
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self._body()
        finally:
            if gc_was_on:
                gc.enable()
        for fn in COUNTED_KERNELS:
            self.captured[fn] = fn.launches - before[fn]
            fn.launches = before[fn]

    def run(self, state, t0, preds):
        """Run the chunk from ``state`` (and t0, and the chunk's rows of
        ``preds``). Returns the new state: the static buffers, which the
        next run of this chunk overwrites; ``traj`` and ``shared`` hold
        the recordings until then."""
        for dst, src in zip(self.state, state):
            if src is not dst:
                dst.copy_(src)
        self.t0.copy_(t0)
        if self.preds is not None:
            self.preds.copy_(preds)
        if self.graph is None:
            self._body()
            return self.state
        self.graph.replay()
        for fn, n in self.captured.items():
            fn.launches += n
        return self.state


def graph_chunks(num_steps: int, save_every: int, max_steps: int):
    """How the stepper cuts ``num_steps`` steps into graph chunks: (G,
    number of full chunks, remainder). G is a multiple of save_every (so
    every chunk starts on a recorded step) of at most ``max_steps`` steps
    (at least save_every), and no longer than the run; the remainder,
    also a multiple of save_every, is one more chunk when not 0."""
    if num_steps <= 0 or num_steps % save_every:
        raise ValueError(f"num_steps ({num_steps}) must be a positive "
                         f"multiple of save_every ({save_every})")
    G = min(num_steps, max(save_every, max_steps - max_steps % save_every))
    n_full, rem = divmod(num_steps, G)
    return G, n_full, rem


class ShardedSolver:
    """Runs a ShardedProblem on its device (all parts stacked)."""

    def __init__(self, sp: ShardedProblem):
        self.sp = sp

    def _pallas_scan_ok(self, sync, record, save_every) -> bool:
        """Gate of K2 (ops/dense_step.scan_comm_free), the JAX package's
        conditions: comm-free, pallas, uncompensated, at most shared-row
        recording, save_every 1. Its VMEM budget is not carried over; the
        size rule here is the kernel's own: one part's state (six (DL,)
        vectors and the slot map) must fit in a block's shared memory,
        which every launch shape of ``dense_step.scan_plan`` needs. K
        itself need not fit: where it cannot stay on chip (96x8x8/8, 320
        MB), the plan streams it on the whole card, and the comm-free run
        still beats the exchanged one (PERF.md)."""
        sp = self.sp
        return (
            not sync
            and sp.fint_mode == "pallas"
            and not sp.compensated
            and record in ("none", "shared")
            and save_every == 1
            and dense_step.scan_fits(sp.DL, sp.dtype)
        )

    def _banded_scan_ok(self, sync, record, preds) -> bool:
        """Gate of K4 (ops/banded_scan.scan_comm_free_banded), the JAX
        package's conditions: comm-free, banded, uncompensated, no
        recording, no predictions. Size rule: one part's state (six
        (nc*Bk,) vectors) must fit in a block's shared memory; the band
        streams from global memory."""
        sp = self.sp
        if (sync or preds is not None or sp.fint_mode != "banded"
                or sp.compensated or record != "none"):
            return False
        _, nc, Bk, _ = sp.band_Kd.shape
        return banded_scan.scan_fits(nc, Bk, sp.dtype)

    def run(self, d0, dn, t0, num_steps, *, sync=True, preds=None,
            record="all", save_every=1):
        sp = self.sp
        if self._banded_scan_ok(sync, record, preds):
            d0f, dnf, tf = banded_scan.scan_comm_free_banded(
                sp.band_Kd, sp.band_Kl, d0, dn, t0, sp.F_pre, sp.lM,
                sp.bc_mask, num_steps=num_steps, dt=sp.dt, alpha=sp.alpha,
                ramped=sp.ramped,
            )
            return (None, None), (d0f, dnf, tf)
        if self._pallas_scan_ok(sync, record, save_every):
            d0f, dnf, tf, shared = dense_step.scan_comm_free(
                sp.denseK, d0, dn, t0, sp.F_pre, sp.lM, sp.bc_mask, sp.sld,
                sp.smask, None if preds is None else preds.to(d0.dtype),
                num_steps=num_steps, dt=sp.dt, alpha=sp.alpha,
                ramped=sp.ramped, record_shared=record == "shared",
            )
            return (None, shared), (d0f, dnf, tf)
        return sp.stacked_run(
            d0, dn, t0, num_steps, sync=sync, preds=preds, record=record,
            save_every=save_every,
        )

    def run_streamed(
        self,
        d0,
        dn,
        t0,
        num_steps,
        *,
        sync=True,
        preds=None,
        record="all",
        save_every=1,
        chunk_steps: Optional[int] = None,
    ):
        """Like :meth:`run`, but in chunks whose recordings are copied to
        host numpy as they finish, so device memory holds one chunk.
        Returns ((traj, shared), carry) with the recorded arrays on the
        host.

        The chunk plan is the JAX package's: chunks of at most
        ``MAX_CHUNK_STEPS`` steps or ``HOST_TRAJ_BUDGET_BYTES`` of recorded
        trajectory; runs up to 16 probe lengths (the largest
        divisor of num_steps <= 1000) go in uniform probe-sized chunks;
        longer runs start with two probe-sized chunks, continue in chunks
        that are a multiple of the probe and end in probe-sized pieces. The
        JAX package also re-sizes those chunks from the timed probes to
        guard a remote worker's watchdog; that is not carried over. Chunk
        boundaries matter at round-off level in compensated mode, where
        each chunk re-enters with the lo word folded into d — which is why
        stage 1 and the stage-4 warm-up share their first boundaries."""
        if num_steps % save_every:
            raise ValueError("num_steps must be divisible by save_every")
        sp = self.sp
        adaptive = chunk_steps is None
        if adaptive:
            itemsize = torch.finfo(sp.dtype).bits // 8
            row_bytes = sp.n_parts * sp.DL * itemsize
            rows = max(1, int(HOST_TRAJ_BUDGET_BYTES // max(row_bytes, 1)))
            chunk_steps = min(num_steps, rows * save_every, MAX_CHUNK_STEPS)
        chunk_steps -= chunk_steps % save_every
        chunk_steps = max(chunk_steps, save_every)
        probe = 0
        if adaptive and chunk_steps > save_every:
            probe = max(save_every, min(1000, chunk_steps, num_steps))
            probe -= probe % save_every
            while probe > save_every and num_steps % probe:
                probe -= save_every
            if num_steps % probe or num_steps < 3 * probe:
                probe = 0
        if probe and num_steps <= 16 * probe:
            chunk_steps, probe = probe, 0
        elif probe:
            chunk_steps = max(probe, chunk_steps - chunk_steps % probe)

        P_, S3 = sp.n_parts, sp.sld.shape[1]
        np_dtype = torch.empty((), dtype=sp.dtype).numpy().dtype
        traj_h = (
            np.empty((P_, num_steps // save_every, sp.DL), dtype=np_dtype)
            if record in ("all", "traj") else None
        )
        shared_h = (
            np.empty((P_, num_steps, S3), dtype=np_dtype)
            if record in ("all", "shared") else None
        )
        carry = (d0, dn, torch.as_tensor(t0, dtype=sp.dtype).to(sp.device))
        done = n_dispatch = 0
        while done < num_steps:
            n = min(chunk_steps, num_steps - done)
            if probe and (n_dispatch < 2 or num_steps - done < chunk_steps):
                n = probe
            pc = None if preds is None else preds[:, done : done + n]
            (traj_c, shared_c), carry = self.run(
                *carry, n, sync=sync, preds=pc, record=record,
                save_every=save_every,
            )
            if traj_h is not None:
                traj_h[:, done // save_every : (done + n) // save_every] = (
                    traj_c.cpu().numpy()
                )
            if shared_h is not None:
                shared_h[:, done : done + n] = shared_c.cpu().numpy()
            done += n
            n_dispatch += 1
        return (traj_h, shared_h), carry
