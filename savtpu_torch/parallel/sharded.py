"""Stacked-part explicit solver on one device (port of
``savtpu/parallel/sharded.py``).

Every per-part tensor carries a leading part axis; the halo exchange is
the psum semantics of the JAX package emulated over that axis: each part's
interface-force contributions are summed per global shared DOF (exactly
FEM interface assembly) and written back to every owner. Interior DOFs
have a single owner and never move.

Ported here: the ``dense``, ``banded`` and ``pallas`` internal-force
modes (``auto`` picks dense up to DL = 1536 local DOFs, banded beyond),
``ell`` (node-block ELLPACK: a gather and 3x3 multiply-reduce, no
scatter) and ``ebe`` (element by element: each element's K_e d_e, folded
per DOF through the incident lists in a fixed order, no atomics), the
matrix-free ``nh`` (Neo-Hookean, recomputed every step: the
gather-free stencil on a structured box partition, elsewhere the
windowed layout or the incident-list gather) and ``stencil`` (linear
elastic, gather-free on a box partition) modes, the psum, ``grid``
(box partitions: face-plane sums) and ``permute`` (neighbour-packed:
rounds of point-to-point interface buffers, the JAX package's
``ppermute`` emulated over the part axis) exchanges; the box partitions include
the periodic tube, whose cells carry their own geometry, whose full-ring
parts wrap a corner column and whose part ring adds a seam pair to the
grid exchange; the plain and compensated (double-word) steppers with
prediction overwrite (or its blend toward the computed dynamics, the
resync block's release) and in-loop ``save_every`` recording, and the
comm-free online block, which in banded compensated mode runs as one
hand-written kernel (``ops/online_banded.py``). The generic time loop is
one step function (``ShardedProblem._step``) run two ways: on a CUDA
device from captured CUDA graphs of up to ``GRAPH_STEPS`` steps each,
replayed with no host work inside (the counterpart of the JAX package's
jitted ``lax.scan``), and on the CPU as an eager Python loop.

The JAX package's ``shard_map`` device mesh is ``torch.distributed`` here,
one process per rank (NCCL on CUDA cards, gloo on the CPU):
``make_device_mesh`` gives a one-dimensional ``DeviceMesh`` over the
launched ranks, and ``ShardedSolver(sp, mesh)`` gives each rank its
contiguous block of parts (:meth:`ShardedProblem.mesh_block`) whose
exchanges cross ranks through :class:`MeshComm`: the psum as a local owner
sum and an ``all_reduce``, the permute and grid exchanges as
``batch_isend_irecv`` rounds. The JAX package's face-plane
access to shared DOFs in stencil mode (which keeps scatters out of an
XLA scan on the TPU) is not carried over: every mode here touches shared
DOFs through the same gather and scatter, which give the same values.

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
import os
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..mesh.generator import _CORNERS, _HEX_TO_TETS
from ..ops import banded_scan, dense_step, kernels
from ..ops.assembly import incident_lists
from ..ops.dense_step import batched_fint_matvec
from ..ops.forces import (
    displacement_gradient,
    linear_stress,
    neo_hookean_stress,
    nodal_forces,
)
from ..ops.material import NeoHookean, linear_ramp
from ..ops.online_banded import band_matvec, online_chunk
from ..utils import resolve_device
from ..utils.offload import fetch_into
from . import stencil
from .halo import (
    PartitionMaps,
    build_neighbor_exchange,
    local_cells_of,
    rcm_reorder_maps,
)

# the JAX package's internal-force modes and halo exchanges, all ported
FINT_MODES = frozenset(
    {"auto", "dense", "banded", "ell", "ebe", "pallas", "nh", "stencil"})
EXCHANGE_MODES = frozenset({"psum", "permute", "grid"})

# run_streamed's chunk plan (the JAX package's): at most this many steps,
# or this many bytes of recorded trajectory, per chunk
MAX_CHUNK_STEPS = 25_000
HOST_TRAJ_BUDGET_BYTES = 1 << 28

# the stepper's CUDA graphs: at most this many steps per captured chunk
GRAPH_STEPS = 100

# the device mesh's one axis (the JAX package names it "shards")
AXIS = "parts"


def make_device_mesh(n_devices: Optional[int] = None,
                     device_type: str = "cuda"):
    """A one-dimensional ``DeviceMesh`` (axis ``"parts"``) over the
    launched ranks, one process per rank as ``torchrun`` or
    ``torch.multiprocessing.spawn`` start them: the port of the JAX
    package's ``make_device_mesh``. CUDA unless the caller asks for the
    CPU; on CUDA each rank first takes the card ``LOCAL_RANK`` (else its
    rank modulo the cards), so ``utils.resolve_device`` gives each rank
    its own card. Where the caller has not initialised the process group,
    it is initialised from the environment (NCCL on CUDA, gloo on the
    CPU). ``n_devices`` defaults to the world size, and any other value
    raises: the mesh spans every rank. Under NCCL the stepper captures
    its collectives into CUDA graphs, which the communicator waits for
    when it is destroyed: drop the solvers and stage contexts (and
    collect them) before ``destroy_process_group``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = torch.device(device_type).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device_type='cpu' for a "
                "gloo mesh on the CPU")
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            rank = (dist.get_rank() if dist.is_initialized()
                    else int(os.environ.get("RANK", 0)))
            local = rank % torch.cuda.device_count()
        torch.cuda.set_device(int(local))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev_type == "cuda" else "gloo")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"make_device_mesh: {n_devices} devices asked for, but {world} "
            "ranks were launched; the mesh spans every rank")
    return init_device_mesh(dev_type, (world,), mesh_dim_names=(AXIS,))


def mesh_device(mesh) -> torch.device:
    """The rank's device of ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class MeshComm:
    """One rank's side of a device mesh: its block ``p0 .. p1 - 1`` of the
    ``n_parts`` parts, and the collectives of the exchanges over the
    mesh's process group. ``owner_count`` (SD,) counts every global shared
    DOF's owners on all ranks. ``nx_peers`` and ``grid_peers`` hold, for
    each permute round and each grid pass (x+, x-, y+, y-, z+, z-), the
    part (= rank, one part per rank) this rank sends to and the one it
    receives from, -1 where it has none: the JAX package's
    ``ppermute`` pairs seen from one rank."""

    def __init__(self, mesh, n_parts, p0, p1, device, owner_count,
                 nx_peers=None, grid_peers=None):
        self.group = mesh.get_group()
        self.rank = mesh.get_local_rank()
        self.world = mesh.size()
        self.n_parts, self.p0, self.p1 = n_parts, p0, p1
        self.device = device
        self.owner_count = owner_count
        self.nx_peers = nx_peers
        self.grid_peers = grid_peers

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The psum: ``t`` summed over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def permute(self, buf: torch.Tensor, peers) -> torch.Tensor:
        """``ppermute``: send ``buf`` to ``peers[0]`` and return what
        ``peers[1]`` sent (zeros where either is -1), one
        ``batch_isend_irecv``."""
        send_to, recv_from = peers
        recv = torch.zeros_like(buf)
        ops = []
        if send_to >= 0:
            ops.append(dist.P2POp(dist.isend, buf.contiguous(),
                                  dist.get_global_rank(self.group, send_to),
                                  self.group))
        if recv_from >= 0:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(self.group, recv_from),
                                  self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return recv

    def warm(self) -> None:
        """One collective on the rank's device, so the communicator exists
        before a CUDA graph captures collectives."""
        self.all_reduce(torch.zeros((1,), device=self.device))

    def gather(self, x):
        """Every rank's block of ``x`` (its parts on the leading axis)
        joined into the global part axis, on every rank; NumPy in, NumPy
        out."""
        is_np = not torch.is_tensor(x)
        t = torch.as_tensor(np.ascontiguousarray(x) if is_np else x)
        t = t.to(self.device).contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self.group)
        g = torch.cat(out)
        return g.cpu().numpy() if is_np else g

    def block(self, x):
        """This rank's block of a global stacked ``x`` (parts on the
        leading axis); a tensor goes to the rank's device."""
        if torch.is_tensor(x):
            return x[self.p0 : self.p1].to(self.device)
        return np.asarray(x)[self.p0 : self.p1]

    def barrier(self) -> None:
        dist.barrier(group=self.group)


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


def _build_ell(npn, L_max, edofs, Ke):
    """Node-block ELLPACK from per-part element stiffness: for each local
    node row a fixed-width list of (column node, 3x3 block), duplicate
    element contributions summed on the host (lexsort + reduceat), so the
    step's product is a gather and a multiply-reduce only. Padded column
    slots point at node L_max (an appended zero row). Host float64."""
    per_part = []
    C_max = 1
    for p in range(npn):
        nodes = edofs[p][:, ::3] // 3               # (E, nb) local node ids
        E, nb = nodes.shape
        blocks = (
            Ke[p]
            .reshape(E, nb, 3, nb, 3)
            .transpose(0, 1, 3, 2, 4)
            .reshape(-1, 3, 3)
        )
        rows = np.repeat(nodes, nb, axis=1).reshape(-1)
        cols = np.tile(nodes, (1, nb)).reshape(-1)
        keep = rows < L_max                          # drop padded elements
        rows, cols, blocks = rows[keep], cols[keep], blocks[keep]
        key = rows.astype(np.int64) * (L_max + 1) + cols
        order = np.argsort(key, kind="stable")
        key, blocks = key[order], blocks[order]
        ukey, start = np.unique(key, return_index=True)
        summed = np.add.reduceat(blocks, start, axis=0)
        urow = (ukey // (L_max + 1)).astype(np.int64)
        ucol = (ukey % (L_max + 1)).astype(np.int64)
        counts = np.bincount(urow, minlength=L_max)
        C_max = max(C_max, int(counts.max(initial=1)))
        per_part.append((urow, ucol, summed, counts))

    ell_blocks = np.zeros((npn, L_max, C_max, 3, 3), dtype=np.float64)
    ell_cols = np.full((npn, L_max, C_max), L_max, dtype=np.int32)
    for p, (urow, ucol, summed, counts) in enumerate(per_part):
        offs = np.zeros(L_max + 1, dtype=np.int64)
        offs[1:] = np.cumsum(counts)
        slot = np.arange(len(urow)) - offs[urow]
        ell_blocks[p, urow, slot] = summed
        ell_cols[p, urow, slot] = ucol
    return ell_blocks, ell_cols


def _check_unpack_distinct(unpack, mask):
    """The permute exchange adds each round's buffer with one gather and
    one scatter, which is exact (and the same bits at every run, with no
    atomics) only if a part's real unpack slots in a round are distinct;
    its padded slots all point at the dummy DOF and add 0."""
    P, R, _ = unpack.shape
    for p in range(P):
        for r in range(R):
            real = unpack[p, r][mask[p, r] > 0]
            if len(np.unique(real)) != len(real):
                raise ValueError(
                    f"neighbour exchange: part {p} round {r} unpacks into "
                    "a DOF twice")


def _stencil_index(device):
    """Device constants of the box stencil: the (6, 4) corner of each
    tet type's nodes (``_HEX_TO_TETS``); for each of the 8 cell corners
    the flat (type * 4 + node) slots that land on it, padded with 24 (an
    appended zero slot) to 6 per corner; and the identity."""
    fold = np.full((8, 6), 24, dtype=np.int64)
    for c in range(8):
        k = np.flatnonzero(_HEX_TO_TETS.reshape(-1) == c)
        fold[c, : len(k)] = k
    return (torch.as_tensor(_HEX_TO_TETS, dtype=torch.int64).to(device),
            torch.as_tensor(fold).to(device))


def _element_geometry(ec, n_elems):
    """Constant P1 geometry of each part's elements, host float64:
    physical gradients G = dN J^-1 (P, E_max, 4, 3) and detJ * total
    weight (P, E_max); padded elements keep G = 0 (so F = I and zero
    force there)."""
    dN_ref = np.array(
        [[-1.0, -1.0, -1.0],
         [1.0, 0.0, 0.0],
         [0.0, 1.0, 0.0],
         [0.0, 0.0, 1.0]]
    )
    npn, E_max = ec.shape[:2]
    Gs = np.zeros((npn, E_max, 4, 3))
    dJw = np.zeros((npn, E_max))
    for p in range(npn):
        ne = n_elems[p]
        Pc = ec[p, :ne]                           # (ne, 4, 3)
        Jm = np.einsum("ai,eaj->eij", dN_ref, Pc).transpose(0, 2, 1)
        Gs[p, :ne] = np.einsum("aj,ejk->eak", dN_ref, np.linalg.inv(Jm))
        dJw[p, :ne] = np.linalg.det(Jm) * (1.0 / 6.0)  # 4-pt wts sum 1/6
    return Gs, dJw


def _build_nh_window(npn, maps, cells, Gs, dJw, chunk_elems=256):
    """The JAX package's windowed layout of the Neo-Hookean forces off a
    box partition, host side. Per part (its local nodes RCM-ordered),
    elements are sorted by their least local node and cut into chunks of
    Ec elements; each chunk records the start of its node window and its
    corners relative to it. One window width W (the widest chunk's, padded
    to a multiple of 8) serves every chunk. Padded chunk slots carry G = 0
    (zero force) and relative index 0."""
    scratch = np.full(int(cells.max()) + 1, -1, dtype=np.int64)
    loc_cells, E_real = [], []
    for p in range(npn):
        elems = maps.local_elements[p]
        loc_cells.append(
            local_cells_of(maps.local_nodes[p], cells, elems, scratch))
        E_real.append(len(elems))
    Ec = max(1, min(chunk_elems, max(E_real)))
    NC = max((e + Ec - 1) // Ec for e in E_real)
    orders, Wmax = [], 8
    for p in range(npn):
        lc = loc_cells[p]
        order = np.argsort(lc.min(axis=1), kind="stable")
        orders.append(order)
        lco = lc[order]
        for c in range(0, len(lco), Ec):
            ch = lco[c : c + Ec]
            Wmax = max(Wmax, int(ch.max() - ch.min() + 1))
    W = -(-Wmax // 8) * 8
    nb = loc_cells[0].shape[1] if loc_cells[0].size else 4
    w0 = np.zeros((npn, NC), dtype=np.int64)
    rel = np.zeros((npn, NC, Ec, nb), dtype=np.int64)
    real = np.zeros((npn, NC, Ec), dtype=bool)
    Gw = np.zeros((npn, NC, Ec, 4, 3))
    dJww = np.zeros((npn, NC, Ec))
    for p in range(npn):
        order = orders[p]
        lc = loc_cells[p][order]
        Gp = Gs[p][: E_real[p]][order]
        dp = dJw[p][: E_real[p]][order]
        for ci, c in enumerate(range(0, E_real[p], Ec)):
            ch = lc[c : c + Ec]
            start = int(ch.min())
            n = len(ch)
            w0[p, ci] = start
            rel[p, ci, :n] = ch - start
            real[p, ci, :n] = True
            Gw[p, ci, :n] = Gp[c : c + Ec]
            dJww[p, ci, :n] = dp[c : c + Ec]
    return w0, rel, real, Gw, dJww, W


def _window_edofs(w0, rel, real, DL):
    """(P, NC * Ec, 12) local DOFs of the windowed layout's element slots
    in chunk order (w0 + relative index), padded chunk slots -> DL - 1:
    the ``edofs`` of the incident-list force, whose fold over these slots
    (``incident_lists``) is then a fixed-order sum in chunk order."""
    nodes = w0[:, :, None, None] + rel                   # (P, NC, Ec, 4)
    wed = (3 * nodes[..., None] + np.arange(3)).reshape(
        nodes.shape[0], -1, 3 * nodes.shape[-1])
    wed[~real.reshape(real.shape[0], -1)] = DL - 1
    return wed


def _stencil_geometry(mesh, box):
    """The stencil's geometry (the JAX package's ``_stencil_geom_kwargs``):
    on a congruent Kuhn grid (beam) the per-type G (6, 4, 3) and detJ w
    (6,); on a curvilinear logical grid (tube) the per-cell arrays of
    ``stencil.cell_type_geometry``, Gc (P, 6, bxc, byc, bzc, 4, 3) and
    dJwc (P, 6, bxc, byc, bzc), with the full-ring wrap flag."""
    if box.spacing is not None:
        G6, dJw6 = stencil.type_geometry(box.spacing)
        return dict(nhs_G=G6, nhs_dJw=dJw6)
    Gc, dJwc = stencil.cell_type_geometry(mesh, box)
    return dict(nhs_Gc=Gc, nhs_dJwc=dJwc, nhs_wrap=bool(box.full_ring))


def _grid_layout(box, npn):
    """The grid exchange's part-box layout: (px, py, pz), the part id at
    each box-lex slot, the slot of each part, and whether the y part axis
    is a periodic ring (the tube: one seam pair more)."""
    orig = np.asarray(box.origins)  # (P, 3) cell origins
    bx, by, bz = box.box_cells
    pi, pj, pk = orig[:, 0] // bx, orig[:, 1] // by, orig[:, 2] // bz
    px, py, pz = int(pi.max()) + 1, int(pj.max()) + 1, int(pk.max()) + 1
    slot_of_part = (pi * py + pj) * pz + pk
    perm = np.empty(npn, dtype=np.int64)
    perm[slot_of_part] = np.arange(npn)
    wrap = bool(box.wrap_y and py > 1)
    return (px, py, pz), perm, slot_of_part.astype(np.int64), wrap


def _grid_peers(perm, pdims, wrap, part):
    """The grid exchange's six ``ppermute`` pair lists (x+, x-, y+, y-,
    z+, z-: sender part -> box neighbour, the JAX package's
    ``grid_pairs``, the y lists a ring where ``wrap``) seen from ``part``:
    for each, (the part it sends to, the part it receives from), -1 where
    none."""
    P3 = np.asarray(perm).reshape(pdims)
    ring = np.roll(P3, -1, axis=1), np.roll(P3, 1, axis=1)
    lists = (
        (P3[:-1], P3[1:]), (P3[1:], P3[:-1]),
        (P3, ring[0]) if wrap else (P3[:, :-1], P3[:, 1:]),
        (P3, ring[1]) if wrap else (P3[:, 1:], P3[:, :-1]),
        (P3[:, :, :-1], P3[:, :, 1:]), (P3[:, :, 1:], P3[:, :, :-1]),
    )
    out = []
    for src, dst in lists:
        src, dst = src.ravel(), dst.ravel()
        to, frm = dst[src == part], src[dst == part]
        out.append((int(to[0]) if len(to) else -1,
                    int(frm[0]) if len(frm) else -1))
    return out


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
    # halo exchange: "psum" (per global shared DOF over its owners) or
    # "grid" (box partitions in lex order: face-plane sums)
    exchange_mode: str = "psum"
    # Neo-Hookean matrix-free path (fint_mode 'nh'): the internal forces
    # are recomputed from the displacement every step
    nh_material: Optional[NeoHookean] = None
    # its incident-list layout (a partition that is not a box; in the
    # windowed layout the element slots come in chunk order):
    edofs: Optional[torch.Tensor] = None      # (P, E_max, 12) local DOFs
                                              # (pad -> DL-1; also ebe's)
    nh_G: Optional[torch.Tensor] = None       # (P, E_max, 4, 3) physical
                                              # gradients (pad -> 0)
    nh_detJw: Optional[torch.Tensor] = None   # (P, E_max) detJ * sum(w)
    nh_gather: Optional[torch.Tensor] = None  # (P, DL, C_max) incident
                                              # slots (incident_lists;
                                              # also ebe's)
    # the windowed layout (nh_gather 'auto'/'window', _build_nh_window):
    # RCM-ordered local nodes, elements in chunks of Ec by least node,
    # each chunk reading a W-node window. Its forces run through the
    # incident-list fields above; these are the host build records
    nhw_w0: Optional[np.ndarray] = None       # (P, NC) window start node
    nhw_idx: Optional[np.ndarray] = None      # (P, NC, Ec, 4) node - w0
    nhw_W: Optional[int] = None               # window width (nodes)
    # the structured-box stencil ('nh' on a box partition, and 'stencil'):
    # local nodes in box-lex order form a (NX, NY, NZ, 3) grid, and the
    # element gathers become shifted slices of it (parallel/stencil.py)
    nhs_dims: Optional[tuple] = None          # per-part node box
    nhs_G: Optional[torch.Tensor] = None      # (6, 4, 3) per tet type
    nhs_dJw: Optional[torch.Tensor] = None    # (6,) detJ * sum(w)
    # the curvilinear tube: per-cell geometry (invariant cell axes
    # collapsed to 1; the straight tube is z-invariant) in place of the
    # per-type constants, and the full-ring part's wrapped corner column
    nhs_Gc: Optional[torch.Tensor] = None     # (P, 6, bxc, byc, bzc, 4, 3)
    nhs_dJwc: Optional[torch.Tensor] = None   # (P, 6, bxc, byc, bzc)
    nhs_wrap: bool = False
    # linear-elastic stencil (fint_mode 'stencil'): Lame parameters
    stn_lmd: Optional[float] = None
    stn_mu: Optional[float] = None
    # the grid exchange (exchange_mode 'grid'):
    grid_pdims: Optional[tuple] = None        # (px, py, pz) part boxes
    grid_ndims: Optional[tuple] = None        # per-part node box
    grid_perm: Optional[torch.Tensor] = None  # (P,) part id at box-lex slot
    grid_inv: Optional[torch.Tensor] = None   # (P,) box-lex slot of part
    grid_wrap: bool = False                   # y part axis is a periodic
                                              # ring (tube): one seam pair
    # node-block ELLPACK (fint_mode 'ell', _build_ell)
    ell_blocks: Optional[torch.Tensor] = None  # (P, L_max, C_max, 3, 3)
    ell_cols: Optional[torch.Tensor] = None    # (P, L_max, C_max) node col
                                               # (pad -> L_max, a zero row)
    # element by element (fint_mode 'ebe'): element stiffness on edofs,
    # folded through nh_gather's incident lists
    Ke: Optional[torch.Tensor] = None          # (P, E_max, 12, 12)
    # the neighbour-packed exchange (exchange_mode 'permute',
    # halo.build_neighbor_exchange)
    nx_pack: Optional[torch.Tensor] = None     # (P, R, B) send DOF ids
    nx_unpack: Optional[torch.Tensor] = None   # (P, R, B) add-into DOF ids
    nx_mask: Optional[torch.Tensor] = None     # (P, R, B) 1 on real slots
    nx_src: Optional[torch.Tensor] = None      # (P, R) partner id, -1 idle
    # under a device mesh (ShardedSolver(sp, mesh)): the rank's side of
    # the mesh, and the global id of its first part; the per-part fields
    # then hold the rank's block and ``owners`` points into it
    comm: Optional[MeshComm] = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    part0: int = 0
    # the stepper's cached graph chunks (_StepChunk), by flags and shapes
    _graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    # device constants of the matrix-free forces (__post_init__)
    _eye: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _stencil_idx: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.fint_mode in ("nh", "stencil"):
            self._eye = torch.eye(3, dtype=self.dtype, device=self.device)
        if self.nhs_dims is not None:
            self._stencil_idx = _stencil_index(self.device)

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
        material=None,
        nh_stencil: str = "auto",
        nh_gather: str = "auto",
        shared_order=None,
        device=None,
    ) -> "ShardedProblem":
        """``material``: a ``NeoHookean`` switches the stepper to per-step
        matrix-free nonlinear forces (fint_mode becomes 'nh').
        ``nh_stencil``: 'auto' takes the gather-free stencil where
        parallel/stencil.py detects a box partition, 'off' the
        incident-list gather. ``nh_gather``: the layout of the gather
        path off a box partition, 'auto' or 'window' (the windowed layout,
        on RCM-ordered local nodes) or 'incident'.

        ``shared_order``: optional per-part arrays of global node ids —
        a permutation of each part's shared-node set — fixing the shared
        CHANNEL order of sld/sgi/smask, so stage reruns stay compatible
        with traces and models already on disk.

        ``device``: where the tensors go, CUDA unless the caller asks for
        another (``utils.resolve_device``: raises without CUDA)."""
        dev = resolve_device(device)
        if isinstance(material, NeoHookean):
            fint_mode = "nh"
        if fint_mode == "nh" and not isinstance(material, NeoHookean):
            raise ValueError(
                "fint_mode='nh' requires a NeoHookean material instance"
            )
        if fint_mode not in FINT_MODES:
            raise ValueError(
                f"unknown fint_mode {fint_mode!r}; expected one of "
                f"{sorted(FINT_MODES)}"
            )
        if exchange_mode not in EXCHANGE_MODES:
            raise ValueError(
                f"unknown exchange_mode {exchange_mode!r}; expected one of "
                f"{sorted(EXCHANGE_MODES)}"
            )
        if nh_gather not in ("auto", "window", "incident"):
            raise ValueError(
                f"unknown nh_gather {nh_gather!r}; expected 'auto', "
                f"'window' or 'incident'"
            )
        if prob.deg != 1:
            raise NotImplementedError(
                "the distributed dynamic path is P1-only; deg=2 is "
                "steady-only, like the reference (Data_prepare.py:42)"
            )
        if fint_mode == "auto":
            # dense for small local blocks, block-tridiagonal beyond
            DL_est = 3 * maps.max_local_nodes + 1
            fint_mode = "dense" if DL_est <= 1536 else "banded"
        grid_box = None
        if exchange_mode == "grid":
            grid_box = stencil.detect_box_partition(prob.mesh, maps)
            if grid_box is None:
                raise ValueError(
                    "exchange_mode='grid' requires a structured box "
                    "partition (partition method 'box' or 'slab' on a "
                    "generated structured mesh); use 'psum' for other "
                    "meshes and partitions"
                )
            # the face-plane exchange needs box-lexicographic local node
            # order; it doubles as a banded ordering, so banded mode
            # skips RCM here
            maps = stencil.lex_reorder_maps(maps, grid_box)
        if fint_mode == "banded" and grid_box is None:
            # banded storage needs small local bandwidth: RCM-reorder the
            # local node lists first (sp.maps is then authoritative)
            maps = rcm_reorder_maps(maps, prob.mesh.tetra)
        stn_box = None
        if fint_mode == "stencil":
            stn_box = grid_box or stencil.detect_box_partition(
                prob.mesh, maps)
            if stn_box is None:
                raise ValueError(
                    "fint_mode='stencil' requires a structured box "
                    "partition (partition method 'box' or 'slab' on a "
                    "generated structured mesh); use 'banded' or 'auto' "
                    "for other meshes and partitions"
                )
            if grid_box is None:
                maps = stencil.lex_reorder_maps(maps, stn_box)
        nh_box = None
        if fint_mode == "nh" and nh_stencil != "off":
            nh_box = stencil.detect_box_partition(prob.mesh, maps)
            if nh_box is not None:
                # the stencil layout needs box-lexicographic local order
                maps = stencil.lex_reorder_maps(maps, nh_box)
        nh_window = (fint_mode == "nh" and nh_box is None
                     and nh_gather in ("auto", "window"))
        if nh_window:
            # the windowed layout wants a small per-part node bandwidth:
            # RCM-reorder like the banded path
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

        as_t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)  # noqa: E731
        as_i = lambda a: torch.as_tensor(a, dtype=torch.int64).to(dev)  # noqa: E731
        denseK = band_Kd = band_Kl = None
        extra = {}
        box = nh_box or stn_box
        if box is not None:
            extra["nhs_dims"] = tuple(box.node_dims)
            for k, v in _stencil_geometry(prob.mesh, box).items():
                extra[k] = v if k == "nhs_wrap" else as_t(v)
        if fint_mode == "nh":
            extra["nh_material"] = material
            if nh_box is None:
                coords_np = prob.coords.numpy()
                ec = np.zeros((npn, E_max, 4, 3))
                n_elems = [len(e) for e in maps.local_elements]
                for p in range(npn):
                    ec[p, : n_elems[p]] = coords_np[maps.local_elements[p]]
                Gs, dJw = _element_geometry(ec, n_elems)
            if nh_window:
                w0, rel, real, Gw, dJww, W = _build_nh_window(
                    npn, maps, cells, Gs, dJw)
                edofs = _window_edofs(w0, rel, real, DL)
                Gs = Gw.reshape(npn, -1, 4, 3)
                dJw = dJww.reshape(npn, -1)
                extra.update(nhw_w0=w0, nhw_idx=rel, nhw_W=W)
            if nh_box is None:
                extra.update(edofs=as_i(edofs), nh_G=as_t(Gs),
                             nh_detJw=as_t(dJw),
                             nh_gather=as_i(incident_lists(edofs, DL)))
        elif fint_mode == "stencil":
            extra.update(stn_lmd=float(prob.material.lmd),
                         stn_mu=float(prob.material.mu))
        elif fint_mode == "banded":
            Kd, Kl, _, _ = _build_banded(npn, 3 * L_max, edofs, Ke)
            band_Kd, band_Kl = as_t(Kd), as_t(Kl)
        elif fint_mode == "ell":
            blocks, cols = _build_ell(npn, L_max, edofs, Ke)
            extra.update(ell_blocks=as_t(blocks), ell_cols=as_i(cols))
        elif fint_mode == "ebe":
            extra.update(Ke=as_t(Ke), edofs=as_i(edofs),
                         nh_gather=as_i(incident_lists(edofs, DL)))
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
        if exchange_mode == "permute":
            nx = build_neighbor_exchange(maps, DL)
            _check_unpack_distinct(nx.unpack_idx, nx.mask)
            extra.update(nx_pack=as_i(nx.pack_idx),
                         nx_unpack=as_i(nx.unpack_idx),
                         nx_mask=as_t(nx.mask), nx_src=as_i(nx.src_of))
        if grid_box is not None:
            pdims, perm, inv, wrap = _grid_layout(grid_box, npn)
            extra.update(grid_pdims=pdims,
                         grid_ndims=tuple(grid_box.node_dims),
                         grid_perm=as_i(perm), grid_inv=as_i(inv),
                         grid_wrap=wrap)

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
            exchange_mode=exchange_mode,
            **extra,
        )

    # per-part fields (leading part axis): tensors, then host arrays
    _PART_TENSORS = (
        "dof_mask", "bc_mask", "lM", "F_pre", "sld", "sgi", "smask",
        "denseK", "band_Kd", "band_Kl", "edofs", "nh_G", "nh_detJw",
        "nh_gather", "nhs_Gc", "nhs_dJwc", "ell_blocks", "ell_cols", "Ke",
        "nx_pack", "nx_unpack", "nx_mask", "nx_src")
    _PART_ARRAYS = ("local_dofs_global", "nhw_w0", "nhw_idx")
    # global tensors every rank keeps whole
    _GLOBAL_TENSORS = ("nhs_G", "nhs_dJw", "grid_perm", "grid_inv")

    def mesh_block(self, mesh, p0: int, p1: int) -> "ShardedProblem":
        """The rank's local view under ``mesh`` (the JAX package's
        ``_local_view`` inside ``shard_map``): every per-part field sliced
        to the parts p0 .. p1 - 1 and moved to the rank's device; SD, dt
        and the other scalars, the partition maps and the global tensors
        stay whole. The owner table is re-indexed to the block: each row
        keeps its local owners in their order, then pads (a slot another
        rank holds adds nothing here; ``MeshComm.all_reduce`` adds it)."""
        dev = mesh_device(mesh)
        P, S3 = self.n_parts, self.sld.shape[1]
        own = self.owners.cpu().numpy()
        real = own < P * S3
        mine = real & (own // S3 >= p0) & (own // S3 < p1)
        order = np.argsort(~mine, axis=1, kind="stable")
        local = np.where(mine, own - p0 * S3, (p1 - p0) * S3)
        local = np.take_along_axis(local, order, axis=1)
        local = local[:, : max(int(mine.sum(axis=1).max(initial=1)), 1)]
        nx_peers = grid_peers = None
        if self.nx_src is not None:
            # one part per rank: round r's partner of part q is nx_src[q, r]
            src = self.nx_src.cpu().numpy()
            nx_peers = []
            for r in range(src.shape[1]):
                to = np.flatnonzero(src[:, r] == p0)
                nx_peers.append((int(to[0]) if len(to) else -1,
                                 int(src[p0, r])))
        if self.grid_perm is not None:
            grid_peers = _grid_peers(self.grid_perm.cpu().numpy(),
                                     self.grid_pdims, self.grid_wrap, p0)
        comm = MeshComm(
            mesh, P, p0, p1, dev,
            torch.as_tensor(real.sum(axis=1)).to(dev),
            nx_peers=nx_peers, grid_peers=grid_peers)
        kw = {k: getattr(self, k)[p0:p1].to(dev)
              for k in self._PART_TENSORS if getattr(self, k) is not None}
        kw.update({k: getattr(self, k)[p0:p1]
                   for k in self._PART_ARRAYS if getattr(self, k) is not None})
        kw.update({k: getattr(self, k).to(dev)
                   for k in self._GLOBAL_TENSORS
                   if getattr(self, k) is not None})
        return dataclasses.replace(
            self, n_parts=p1 - p0, owners=torch.as_tensor(local).to(dev),
            comm=comm, part0=p0, **kw)

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

    def globalize(self, stacked, ndof: int) -> np.ndarray:
        """(P, DL) stacked -> (ndof,) global NumPy vector of the input's
        dtype: each DOF takes its lowest part's value (the parts are
        written in reverse order; duplicates agree in the exchanged
        path). ``stacked`` is a tensor on any device or an array."""
        if torch.is_tensor(stacked):
            stacked = stacked.detach().cpu().numpy()
        stacked = np.asarray(stacked)
        out = np.zeros(ndof, dtype=stacked.dtype)
        dm = self.dof_mask.cpu().numpy()
        for p in range(self.n_parts - 1, -1, -1):
            n_real = int(dm[p].sum())
            out[self.local_dofs_global[p, :n_real]] = stacked[p, :n_real]
        return out

    # ------------------------------------------------------------------
    # stacked step machinery (leading axis = parts)
    # ------------------------------------------------------------------
    def _fint_stacked(self, d: torch.Tensor) -> torch.Tensor:
        """The internal forces of every part, (P, DL) -> (P, DL): K_local d
        in the linear modes, the matrix-free forces in 'nh' and
        'stencil'."""
        mode = self.fint_mode
        if mode == "ell":
            return self._ell_fint(d)
        if mode == "ebe":
            return self._ebe_fint(d)
        if mode == "dense":
            return torch.bmm(self.denseK, d[:, :, None])[:, :, 0]
        if mode == "pallas":
            # K1 (ops/dense_step.py), once per step
            return batched_fint_matvec(self.denseK, d)
        if mode == "banded":
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
        if mode == "nh":
            mat = self.nh_material
            if self.nhs_dims is not None:
                return self._stencil_fint(d, neo_hookean_stress, mat.mu,
                                          mat.lmd)
            return self._nh_fint(d)
        if mode == "stencil":
            return self._stencil_fint(d, linear_stress, self.stn_mu,
                                      self.stn_lmd)
        raise ValueError(f"unknown fint_mode {mode!r}")

    def _ell_fint(self, d: torch.Tensor) -> torch.Tensor:
        """Node-block ELLPACK product: each node row gathers its column
        nodes' displacements (padded columns read an appended zero node)
        and multiply-reduces them with its 3x3 blocks."""
        P = d.shape[0]
        L = (self.DL - 1) // 3
        dn = torch.cat([d[:, : 3 * L].reshape(P, L, 3),
                        d.new_zeros((P, 1, 3))], dim=1)
        C = self.ell_cols.shape[2]
        dg = torch.gather(dn, 1, self.ell_cols.reshape(P, -1, 1).expand(
            -1, -1, 3)).reshape(P, L, C, 1, 3)
        fi = (self.ell_blocks * dg).sum(dim=(2, 4))      # (P, L, 3)
        return torch.cat([fi.reshape(P, 3 * L), d.new_zeros((P, 1))], dim=1)

    def _ebe_fint(self, d: torch.Tensor) -> torch.Tensor:
        """Element by element: each element's K_e d_e (multiply and reduce
        over the 12 columns), then every DOF's incident element rows summed
        by a fixed-width gather (``nh_gather``) in element order. The JAX
        package adds them with a segment sum; here no scatter-add runs, so
        the card gives the same bits at every run and in a replayed
        graph."""
        P, E, nb3 = self.edofs.shape
        de = torch.gather(d, 1, self.edofs.reshape(P, -1)).reshape(
            P, E, 1, nb3)
        fe = (self.Ke * de).sum(-1).reshape(P, -1)
        flat = torch.cat([fe, fe.new_zeros((P, 1))], dim=1)
        return torch.gather(flat, 1, self.nh_gather.reshape(P, -1)).reshape(
            P, self.DL, -1).sum(-1)

    def _nh_fint(self, d: torch.Tensor) -> torch.Tensor:
        """Neo-Hookean forces on any partition: each element's nodal
        displacements gathered by ``edofs``, the forces of all elements at
        once (ops/forces.py), assembled by a fixed-width gather of each
        DOF's incident element slots (no scatter, no atomics: the same bits
        at every run and in a replayed CUDA graph). The windowed layout
        runs here too, its element slots in chunk order: the JAX package
        selects each chunk's corners with a one-hot product against its
        node window and adds the transposed products chunk after chunk;
        a one-hot row selects one node, so the gather by w0 + relative
        index and the fold in chunk order compute the same."""
        mat = self.nh_material
        P, E = self.edofs.shape[:2]
        u = torch.gather(d, 1, self.edofs.reshape(P, -1)).reshape(P, E, 4, 3)
        S = neo_hookean_stress(displacement_gradient(u, self.nh_G), mat.mu,
                               mat.lmd, self._eye)
        fe = nodal_forces(S, self.nh_G, self.nh_detJw).reshape(P, -1)
        flat = torch.cat([fe, fe.new_zeros((P, 1))], dim=1)
        return torch.gather(flat, 1, self.nh_gather.reshape(P, -1)).reshape(
            P, self.DL, -1).sum(-1)

    def _stencil_fint(self, d, stress, mu, lmd) -> torch.Tensor:
        """Matrix-free forces on a structured box partition (the JAX
        package's ``_nh_fint_stencil`` and ``_lin_fint_stencil``). The
        local nodes are box-lex ordered, so the (P, NX, NY, NZ, 3) nodal
        grid is a view of ``d``; the 8 corner views of every cell are
        stacked once, indexed by ``_HEX_TO_TETS`` into all six tet types,
        and the stress of ``stress(H, mu, lmd, I)`` gives every element's
        nodal forces at once (G per type, a (6, 4, 3) tensor). Each cell's
        forces are summed per corner and added into the grid with 8
        static slice adds.

        On the curvilinear tube G and detJ w are per-cell arrays
        (``nhs_Gc``, ``nhs_dJwc``, broadcast over collapsed cell axes), and
        a full-ring part (``nhs_wrap``) gains a wrapped corner column, a
        copy of y = 0, so the seam cells see their far corners; the forces
        gathered there are added back into column 0."""
        NX, NY, NZ = self.nhs_dims
        L = NX * NY * NZ
        P = d.shape[0]
        NYe = NY + 1 if self.nhs_wrap else NY
        bx, by, bz = NX - 1, NYe - 1, NZ - 1
        tets, fold = self._stencil_idx
        u = d[:, : 3 * L].reshape(P, NX, NY, NZ, 3)
        if self.nhs_wrap:
            u = torch.cat([u, u[:, :, :1]], dim=2)
        if self.nhs_Gc is None:
            G, dJw = self.nhs_G, self.nhs_dJw
        else:  # cells axes before the type axis, as the corner views
            G, dJw = self.nhs_Gc.movedim(1, 4), self.nhs_dJwc.movedim(1, 4)
        corners = torch.stack(
            [u[:, ox : ox + bx, oy : oy + by, oz : oz + bz]
             for ox, oy, oz in _CORNERS], dim=-2)       # (P, bx, by, bz, 8, 3)
        ue = corners[..., tets, :]                      # (..., 6, 4, 3)
        S = stress(displacement_gradient(ue, G), mu, lmd, self._eye)
        f = nodal_forces(S, G, dJw).reshape(P, bx, by, bz, 24, 3)
        f = torch.cat([f, f.new_zeros((P, bx, by, bz, 1, 3))], dim=-2)
        fc = f[..., fold, :].sum(-2)                    # (..., 8, 3)
        out = d.new_zeros((P, NX, NYe, NZ, 3))
        for c, (ox, oy, oz) in enumerate(_CORNERS):
            out[:, ox : ox + bx, oy : oy + by, oz : oz + bz].add_(
                fc[..., c, :])
        if self.nhs_wrap:
            out[:, :, 0].add_(out[:, :, NY])
            out = out[:, :, :NY]
        return torch.cat([out.reshape(P, 3 * L),
                          d.new_zeros((P, self.DL - 3 * L))], dim=1)

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
        if self.comm is not None:
            tot = self.comm.all_reduce(tot)
        return F_int.scatter(1, self.sld, tot[self.sgi])

    def _exchange_grid(self, F_int: torch.Tensor) -> torch.Tensor:
        """The halo exchange as a dimension-split face-plane sum on the
        part-box grid (exchange_mode 'grid'). Boxes overlap at 1-node face
        planes; summing the x, then y, then z overlapping planes carries
        edge and corner contributions exactly (after the x pass an x-face
        node holds its pair's sum, the y pass sums those, and so on). The
        same contract as :meth:`_exchange`, with another order of the
        additions at the 4-8-owner nodes. Each plane sum is made before
        it is written into both planes."""
        P = self.n_parts
        NX, NY, NZ = self.grid_ndims
        px, py, pz = self.grid_pdims
        L = NX * NY * NZ
        v = F_int[self.grid_perm, : 3 * L].reshape(px, py, pz, NX, NY, NZ, 3)
        if px > 1:
            s = v[:-1, :, :, NX - 1] + v[1:, :, :, 0]
            v[:-1, :, :, NX - 1] = s
            v[1:, :, :, 0] = s
        if py > 1:
            s = v[:, :-1, :, :, NY - 1] + v[:, 1:, :, :, 0]
            v[:, :-1, :, :, NY - 1] = s
            v[:, 1:, :, :, 0] = s
        if self.grid_wrap:
            # the tube's periodic part ring: the seam pairs the last
            # part's high plane with the first part's low plane (planes
            # disjoint from the interior pairs above, py = 2 included)
            s = v[:, -1:, :, :, NY - 1] + v[:, :1, :, :, 0]
            v[:, -1:, :, :, NY - 1] = s
            v[:, :1, :, :, 0] = s
        if pz > 1:
            s = v[:, :, :-1, :, :, NZ - 1] + v[:, :, 1:, :, :, 0]
            v[:, :, :-1, :, :, NZ - 1] = s
            v[:, :, 1:, :, :, 0] = s
        flat = v.reshape(P, 3 * L)[self.grid_inv]
        return torch.cat([flat, F_int[:, 3 * L :]], dim=1)

    def _exchange_grid_mesh(self, F_int: torch.Tensor) -> torch.Tensor:
        """The grid exchange across ranks (one part per rank; the JAX
        package's ``_exchange_grid_mesh``): each axis pass sends the high
        face plane to the +axis box neighbour and the low plane to the
        -axis one, and each rank adds what arrives, the tube's seam pair
        riding the wrapped y ring. A plane sum is the same two addends as
        the emulated pass's, so the same bits; a rank with no neighbour
        in a direction adds zeros."""
        NX, NY, NZ = self.grid_ndims
        px, py, pz = self.grid_pdims
        L = NX * NY * NZ
        Pl = F_int.shape[0]
        v = F_int[:, : 3 * L].reshape(Pl, NX, NY, NZ, 3).clone()
        peers = self.comm.grid_peers
        for axis, (n, size, wrapped) in enumerate((
                (px, NX, False), (py, NY, self.grid_wrap), (pz, NZ, False))):
            if n == 1 and not wrapped:
                continue
            lo = v.select(axis + 1, 0).clone()
            hi = v.select(axis + 1, size - 1).clone()
            recv_lo = self.comm.permute(hi, peers[2 * axis])
            recv_hi = self.comm.permute(lo, peers[2 * axis + 1])
            v.select(axis + 1, 0).copy_(lo + recv_lo)
            v.select(axis + 1, size - 1).copy_(hi + recv_hi)
        return torch.cat([v.reshape(Pl, 3 * L), F_int[:, 3 * L :]], dim=1)

    def _emulated_permute(self, buf: torch.Tensor, r: int) -> torch.Tensor:
        """The JAX package's single-device stand-in for ``ppermute`` on
        the part axis: part p receives round r's buffer from its partner,
        or zeros when idle."""
        src = self.nx_src[:, r]
        got = buf.index_select(0, src.clamp(min=0))
        return torch.where((src >= 0)[:, None], got, torch.zeros_like(got))

    def _exchange_permute(self, F_int: torch.Tensor) -> torch.Tensor:
        """Neighbour-packed halo exchange: R rounds, each packing every
        part's interface DOFs with its round's partner, permuting the
        buffers and adding the received one in. A shared DOF thus sums its
        owners' contributions in round order, as the JAX package's permute
        does (not in the psum's owner order). A part's real unpack slots in
        a round are distinct (checked at build), so the add is a gather
        and a scatter: no atomics."""
        out = F_int
        for r in range(self.nx_pack.shape[1]):
            m = self.nx_mask[:, r]
            buf = torch.gather(F_int, 1, self.nx_pack[:, r]) * m
            ui = self.nx_unpack[:, r]
            if self.comm is not None:
                recv = self.comm.permute(buf, self.comm.nx_peers[r]) * m
            else:
                recv = self._emulated_permute(buf, r) * m
            out = out.scatter(1, ui, torch.gather(out, 1, ui) + recv)
        return out

    def _sync(self, F_int: torch.Tensor) -> torch.Tensor:
        """The exchanged step's halo exchange, by ``exchange_mode``."""
        if self.exchange_mode == "grid":
            if self.comm is not None:
                return self._exchange_grid_mesh(F_int)
            return self._exchange_grid(F_int)
        if self.exchange_mode == "permute":
            return self._exchange_permute(F_int)
        return self._exchange(F_int)

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
    def _online_ok(self, sync, preds, record, save_every, num_steps,
                   blend=None) -> bool:
        """Gate for the online kernel (ops/online_banded.py): the
        production comm-free block — banded, compensated state, per-step
        prediction overwrite (no blend), full recording."""
        return (
            not sync
            and preds is not None
            and blend is None
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
        blend=None,              # (num_steps,) overwrite->dynamics weight
        record: str = "all",     # "all" | "traj" | "shared" | "none"
        save_every: int = 1,
    ):
        """Step ``num_steps`` times. Returns ((traj, shared_trace), carry)
        with carry = (d_last, d_prev, t); recorded entries are None when
        not requested.

        The trajectory records d1 of every step i with i % save_every ==
        0, shape (P, num_steps // save_every, DL); the shared-DOF trace is
        recorded at every step, shape (P, num_steps, 3*S_max).

        ``blend`` (with ``preds``): per-step weights w that move the shared
        DOFs from the prediction (w = 0, the overwrite) to the computed
        dynamics (w = 1): the resync block's release, which the stage-4
        loop ramps by a smoothstep. They ride as a device tensor that each
        step reads by its index, so a captured graph replays them.

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
        if blend is not None:
            if preds is None:
                raise ValueError("blend needs preds")
            blend = torch.as_tensor(blend, dtype=d0.dtype).to(d0.device)

        if self._online_ok(sync, preds, record, save_every, num_steps,
                           blend):
            return self._online_run(d0, dn, t0, num_steps, preds,
                                    save_every)
        run = (self._stacked_run_chunked
               if d0.device.type == "cuda" and num_steps > 0
               else self._stacked_run_eager)
        return run(d0, dn, t0, num_steps, sync=sync, preds=preds,
                   blend=blend, record=record, save_every=save_every)

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

    def _step(self, state, pred_row, sync, consts, t0, w=None):
        """One step; ``pred_row`` overwrites the shared DOFs, or with a
        blend weight ``w`` (a 0-d tensor) is blended toward the computed
        dynamics: w * dynamics + (1 - w) * prediction."""
        F_of = self._fint_stacked
        if not self.compensated:
            d0c, dnc, tn = state
            F_int = F_of(d0c)
            if sync:
                F_int = self._sync(F_int)
            d1 = self._update(d0c, dnc, tn, F_int)
            if pred_row is not None:
                if w is not None:
                    cur = torch.gather(d1, 1, self.sld)
                    pred_row = w * cur + (1.0 - w) * pred_row
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
            F_int = self._sync(F_int)
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
            if w is not None:
                dyn = cur + torch.gather(delta, 1, self.sld)
                pred_row = w * dyn + (1.0 - w) * pred_row
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
               want_traj, want_shared, save_every, blend=None):
        """``num_steps`` steps from ``state``; returns the new state, the
        trajectory rows (every save_every-th step) and the shared rows
        (every step), stacked, or None where not wanted."""
        traj, shared = [], []
        for k in range(num_steps):
            state, rec = self._step(
                state, None if preds is None else preds[:, k, :], sync,
                consts, t0, None if blend is None else blend[k])
            if want_traj and k % save_every == 0:
                traj.append(rec)
            if want_shared:
                shared.append(self._gather_shared(rec))
        return (state,
                torch.stack(traj, dim=1) if want_traj else None,
                torch.stack(shared, dim=1) if want_shared else None)

    def _stacked_run_eager(self, d0, dn, t0, num_steps, *, sync, preds,
                           record, save_every, blend=None):
        """The step loop as eager tensor ops: the CPU path, and on the card
        the reference the graph path is held against."""
        consts = self._step_constants(d0.dtype, d0.device)
        state, traj, shared = self._steps(
            self._init_state(d0, dn, t0), num_steps, preds, sync, consts,
            t0, want_traj=record in ("all", "traj"),
            want_shared=record in ("all", "shared"), save_every=save_every,
            blend=blend)
        return (traj, shared), self._carry(state, t0, consts)

    def _stacked_run_chunked(self, d0, dn, t0, num_steps, *, sync, preds,
                             record, save_every, blend=None,
                             graph_steps=None):
        """The step loop in chunks of G steps (:func:`graph_chunks`), each
        a :class:`_StepChunk` whose static buffers carry the state, t0 and
        the chunk's predictions (and blend weights) in and its recordings
        out. On a CUDA device
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
                                has_blend=blend is not None,
                                want_traj=want_traj, want_shared=want_shared,
                                save_every=save_every)
            state = chunk.run(
                state, t0, None if preds is None
                else preds[:, done : done + n],
                None if blend is None else blend[done : done + n])
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
                   self.smask, self.owners, self.edofs, self.nh_G,
                   self.nh_detJw, self.nh_gather, self.nhs_G, self.nhs_dJw,
                   self.nhs_Gc, self.nhs_dJwc, self.grid_perm, self.grid_inv,
                   self.ell_blocks, self.ell_cols, self.Ke, self.nx_pack,
                   self.nx_unpack, self.nx_mask, self.nx_src)
        key = (n, tuple(sorted(flags.items())), self.compensated,
               self.fint_mode, self.exchange_mode, self.nh_material,
               self.stn_lmd, self.stn_mu, self.nhs_wrap, self.grid_wrap,
               self.dt, self.alpha, self.ramped,
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
    continues from it), the chunk's prediction rows and blend weights in,
    its trajectory rows and shared rows out.

    On a CUDA device the body is captured once into a CUDA graph and
    every :meth:`run` replays it; the kernel wrappers' counts (which the
    capture moved without launching anything) are restored, and each
    replay adds the launches it captured. A port kernel must have its
    library loaded before the capture (``nvcc`` and ``ctypes`` cannot run
    inside one); in every other mode one eager step on the capture stream
    sets up what the step's kernels need first (cuBLAS for the dense and
    banded products), and launches no counted kernel."""

    def __init__(self, sp, n, state, t0, *, sync, has_preds, has_blend,
                 want_traj, want_shared, save_every):
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
        self.blend = (torch.zeros((n,), dtype=dtype, device=dev)
                      if has_blend else None)
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
            save_every=self.save_every, blend=self.blend)
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
        if sp.comm is not None:
            # the communicator exists before the capture records a
            # collective (each rank captures the same chunks in order)
            with torch.cuda.stream(stream):
                sp.comm.warm()
        if sp.fint_mode != "pallas":
            with torch.cuda.stream(stream):
                sp._step(self.state, None if self.preds is None
                         else self.preds[:, 0, :], self.sync, self.consts,
                         self.t0, None if self.blend is None
                         else self.blend[0])
        before = {fn: fn.launches for fn in COUNTED_KERNELS}
        self.graph = torch.cuda.CUDAGraph()
        # no collection during the capture: destroying any CUDA graph then
        # would invalidate it
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            # under a mesh the process group's watchdog thread polls its
            # events during the capture: only this thread's calls are
            # checked
            mode = "global" if sp.comm is None else "thread_local"
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode=mode):
                self._body()
        finally:
            if gc_was_on:
                gc.enable()
        for fn in COUNTED_KERNELS:
            self.captured[fn] = fn.launches - before[fn]
            fn.launches = before[fn]

    def run(self, state, t0, preds, blend=None):
        """Run the chunk from ``state`` (and t0, and the chunk's rows of
        ``preds`` and ``blend``). Returns the new state: the static
        buffers, which the next run of this chunk overwrites; ``traj`` and
        ``shared`` hold the recordings until then."""
        for dst, src in zip(self.state, state):
            if src is not dst:
                dst.copy_(src)
        self.t0.copy_(t0)
        if self.preds is not None:
            self.preds.copy_(preds)
        if self.blend is not None:
            self.blend.copy_(blend)
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
    """Runs a ShardedProblem: all parts stacked on its device, or under a
    device mesh (``make_device_mesh``) each rank its block of parts.

    Under ``mesh`` rank r of n holds the contiguous parts r P/n .. (r+1)
    P/n - 1, as ``shard_map`` splits the part axis: ``self.sp`` is that
    block (:meth:`ShardedProblem.mesh_block`) on the rank's device, and
    :meth:`run` and :meth:`run_streamed` take and return the block's
    tensors (:meth:`block` cuts a global stacked tensor to it,
    :meth:`gather` joins the ranks' blocks). The exchanged steps cross
    ranks through ``torch.distributed``; K2 and K4 are refused under a
    mesh, as in the JAX package, while K1 and K3 run on each rank's
    parts."""

    def __init__(self, sp: ShardedProblem, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            n_dev = mesh.size()
            if sp.n_parts % n_dev:
                raise ValueError(
                    f"mesh has {n_dev} devices; the part count "
                    f"{sp.n_parts} must be a multiple (several parts per "
                    f"device keep the local dense blocks small)"
                )
            if sp.exchange_mode == "permute" and sp.n_parts != n_dev:
                raise ValueError(
                    "exchange_mode='permute' permutes on the device axis "
                    f"and needs one part per device ({sp.n_parts} parts, "
                    f"{n_dev} devices); use exchange_mode='psum' for "
                    "multiple parts per device"
                )
            if sp.exchange_mode == "grid" and sp.n_parts != n_dev:
                raise ValueError(
                    "exchange_mode='grid' under a device mesh ppermutes "
                    "face planes between box-neighbor devices and needs "
                    f"one part per device ({sp.n_parts} parts, {n_dev} "
                    "devices); use exchange_mode='psum' for multiple "
                    "parts per device"
                )
            per = sp.n_parts // n_dev
            r = mesh.get_local_rank()
            sp = sp.mesh_block(mesh, r * per, (r + 1) * per)
        self.sp = sp

    @property
    def parts(self) -> range:
        """The global ids of the parts this solver runs."""
        return range(self.sp.part0, self.sp.part0 + self.sp.n_parts)

    def block(self, x):
        """This rank's block of a global stacked ``x`` (itself without a
        mesh)."""
        return x if self.sp.comm is None else self.sp.comm.block(x)

    def gather(self, x):
        """The ranks' blocks of ``x`` joined on the global part axis, on
        every rank (itself without a mesh)."""
        return x if self.sp.comm is None else self.sp.comm.gather(x)

    def _pallas_scan_ok(self, sync, record, save_every, blend=None) -> bool:
        """Gate of K2 (ops/dense_step.scan_comm_free), the JAX package's
        conditions: comm-free, pallas, uncompensated, at most shared-row
        recording, save_every 1; and no blend, which K2 does not apply
        (the JAX package's K2 gate never sees one: its pipeline blends
        only exchanged runs). Its VMEM budget is not carried over; the
        size rule here is the kernel's own: one part's state (six (DL,)
        vectors and the slot map) must fit in a block's shared memory,
        which every launch shape of ``dense_step.scan_plan`` needs. K
        itself need not fit: where it cannot stay on chip (96x8x8/8, 320
        MB), the plan streams it on the whole card, and the comm-free run
        still beats the exchanged one (PERF.md)."""
        sp = self.sp
        return (
            self.mesh is None
            and not sync
            and blend is None
            and sp.fint_mode == "pallas"
            and not sp.compensated
            and record in ("none", "shared")
            and save_every == 1
            and dense_step.scan_fits(sp.DL, sp.dtype)
        )

    def _banded_scan_ok(self, sync, record, preds, blend=None) -> bool:
        """Gate of K4 (ops/banded_scan.scan_comm_free_banded), the JAX
        package's conditions: comm-free, banded, uncompensated, no
        recording, no predictions, no blend. Size rule: one part's state (six
        (nc*Bk,) vectors) must fit in a block's shared memory; the band
        streams from global memory."""
        sp = self.sp
        if (self.mesh is not None or sync or preds is not None
                or blend is not None
                or sp.fint_mode != "banded" or sp.compensated
                or record != "none"):
            return False
        _, nc, Bk, _ = sp.band_Kd.shape
        return banded_scan.scan_fits(nc, Bk, sp.dtype)

    def run(self, d0, dn, t0, num_steps, *, sync=True, preds=None,
            blend=None, record="all", save_every=1):
        sp = self.sp
        if self._banded_scan_ok(sync, record, preds, blend):
            d0f, dnf, tf = banded_scan.scan_comm_free_banded(
                sp.band_Kd, sp.band_Kl, d0, dn, t0, sp.F_pre, sp.lM,
                sp.bc_mask, num_steps=num_steps, dt=sp.dt, alpha=sp.alpha,
                ramped=sp.ramped,
            )
            return (None, None), (d0f, dnf, tf)
        if self._pallas_scan_ok(sync, record, save_every, blend):
            d0f, dnf, tf, shared = dense_step.scan_comm_free(
                sp.denseK, d0, dn, t0, sp.F_pre, sp.lM, sp.bc_mask, sp.sld,
                sp.smask, None if preds is None else preds.to(d0.dtype),
                num_steps=num_steps, dt=sp.dt, alpha=sp.alpha,
                ramped=sp.ramped, record_shared=record == "shared",
            )
            return (None, shared), (d0f, dnf, tf)
        return sp.stacked_run(
            d0, dn, t0, num_steps, sync=sync, preds=preds, blend=blend,
            record=record, save_every=save_every,
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
        blend=None,
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
        stage 1 and the stage-4 warm-up share their first boundaries.
        Under a mesh the plan is the whole problem's, so every rank cuts
        its block where an emulated run cuts."""
        if num_steps % save_every:
            raise ValueError("num_steps must be divisible by save_every")
        sp = self.sp
        adaptive = chunk_steps is None
        if adaptive:
            itemsize = torch.finfo(sp.dtype).bits // 8
            n_all = sp.n_parts if sp.comm is None else sp.comm.n_parts
            row_bytes = n_all * sp.DL * itemsize
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
            bc = None if blend is None else blend[done : done + n]
            (traj_c, shared_c), carry = self.run(
                *carry, n, sync=sync, preds=pc, blend=bc, record=record,
                save_every=save_every,
            )
            if traj_h is not None:
                fetch_into(
                    traj_h[:, done // save_every : (done + n) // save_every],
                    traj_c,
                )
            if shared_h is not None:
                fetch_into(shared_h[:, done : done + n], shared_c)
            done += n
            n_dispatch += 1
        return (traj_h, shared_h), carry
