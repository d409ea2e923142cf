"""Shared stage context: mesh -> assembly -> partition -> sharded problem
(port of ``savtpu/pipeline/common.py``).

Under a device mesh (``build_context(..., device_mesh=make_device_mesh())``
on every rank) each rank assembles and partitions the whole problem on the
host, as the JAX package's single controller does (the setup is
deterministic), and its solver holds the rank's block of parts on the
rank's device. The stages then write the per-part artifacts of their own
parts, and rank 0 alone the global ones and the run log."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..io.artifacts import ArtifactStore
from ..ops.material import NeoHookean
from ..mesh import dirichlet_nodes
from ..parallel.halo import PartitionMaps, build_partition_maps
from ..parallel.partition import partition_elements
from ..parallel.sharded import ShardedProblem, ShardedSolver, mesh_device
from ..solvers.problem import AssembledProblem, setup_problem
from ..utils import full_precision_products, resolve_device, stage_log

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class StageContext:
    cfg: Config
    prob: AssembledProblem
    maps: PartitionMaps
    sp: ShardedProblem
    solver: ShardedSolver
    store: ArtifactStore
    device: torch.device
    # artifact-layout adoption (see _load_artifact_layout): when existing
    # per-rank label CSVs describe the same partition, their node ORDER is
    # authoritative for the trajectory writers
    artifact_local_nodes: "list | None" = None  # per-rank node ids, CSV order
    artifact_local_perm: "list | None" = None   # per-rank perm cur->CSV

    @property
    def comm(self):
        """The rank's side of the device mesh (None when emulated)."""
        return self.sp.comm

    @property
    def is_root(self) -> bool:
        """Whether this process writes the global artifacts and the log:
        always when emulated, rank 0 under a mesh."""
        return self.comm is None or self.comm.rank == 0

    @property
    def parts(self) -> range:
        """The global ids of the parts this process runs."""
        return self.solver.parts

    def log(self, event: str, **fields) -> None:
        """A run-log record, written by the root process only."""
        if self.is_root:
            stage_log(self.cfg).log(event, **fields)

    def barrier(self) -> None:
        """Wait for every rank (nothing to wait for when emulated)."""
        if self.comm is not None:
            self.comm.barrier()

    def rank_values(self, value: float) -> list:
        """``value`` of every rank, in rank order ([value] when
        emulated)."""
        if self.comm is None:
            return [value]
        t = torch.tensor([float(value)], dtype=torch.float64)
        return [float(v) for v in self.comm.gather(t.numpy())]


def state_dtype(cfg: Config, dtype=None) -> torch.dtype:
    """The run's state dtype: ``dtype`` if given, else cfg.solver.dtype."""
    if dtype is not None:
        return dtype
    try:
        return _DTYPES[cfg.solver.dtype]
    except KeyError:
        raise ValueError(
            f"solver.dtype {cfg.solver.dtype!r}; expected one of "
            f"{sorted(_DTYPES)}"
        ) from None


def _load_artifact_layout(store: ArtifactStore, maps: PartitionMaps):
    """(shared_order, local_order) from existing per-rank label CSVs, or
    (None, None) when absent or describing another partition. A stage
    rerun built with another fint_mode would otherwise permute every
    channel against the traces already on disk."""
    n = maps.n_parts
    try:
        if not all(
            store.shared_csv(r).exists() and store.local_nodes_csv(r).exists()
            for r in range(n)
        ):
            return None, None
        shared = [store.load_int_csv(store.shared_csv(r)) for r in range(n)]
        local = [
            store.load_int_csv(store.local_nodes_csv(r)) for r in range(n)
        ]
    except (OSError, ValueError):
        return None, None
    for r in range(n):
        if not np.array_equal(
            np.sort(shared[r]), np.sort(np.asarray(maps.shared_nodes[r]))
        ) or not np.array_equal(
            np.sort(local[r]), np.sort(np.asarray(maps.local_nodes[r]))
        ):
            return None, None
    return shared, local


def build_context(cfg: Config, mesh=None, dtype=None, device=None,
                  device_mesh=None) -> StageContext:
    """Assemble, partition and pack the problem on ``device`` (CUDA unless
    the caller asks for the CPU). The state dtype is ``dtype`` or
    cfg.solver.dtype; ``compensated=None`` turns the double-word state on
    for float32. ``device_mesh`` (``parallel.make_device_mesh``, called
    on every rank): the problem is packed on the host and the solver takes
    the rank's block of parts onto the rank's device, which must be of
    ``device``'s type."""
    dev = resolve_device(device)
    if device_mesh is not None:
        mdev = mesh_device(device_mesh)
        if mdev.type != dev.type:
            raise ValueError(
                f"the device mesh is on {mdev.type}, the run asks for "
                f"{dev.type}")
        dev = mdev
    dtype = state_dtype(cfg, dtype)
    full_precision_products()
    if cfg.solver.deg != 1:
        raise NotImplementedError(
            "the distributed dynamic pipeline is P1-only; deg=2 is "
            "steady-only, like the reference (Data_prepare.py:42) — use "
            "savtpu_torch.pipeline.data_prepare.run or "
            "api.Simulation.steady()"
        )
    tmarks = {}
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        t1 = time.perf_counter()
        tmarks[name] = round(t1 - t0, 3)
        t0 = t1

    prob = setup_problem(cfg, mesh=mesh, dtype=dtype)
    mark("assembly_s")
    # the graph method's refiner (native C++ or NumPy) decides the
    # partition, so the route taken goes into the setup record
    pinfo = {}
    epart = partition_elements(
        prob.mesh.tetra, prob.mesh.points, cfg.partition.n_parts,
        method=cfg.partition.method, info=pinfo,
    )
    dnodes = dirichlet_nodes(
        prob.mesh.triangles,
        prob.mesh.points,
        axis=cfg.partition.dirichlet_axis,
        value=cfg.partition.dirichlet_value,
        tol=cfg.partition.dirichlet_tol,
    )
    maps = build_partition_maps(
        prob.mesh.tetra, epart, prob.mesh.num_points, dnodes
    )
    mark("partition_s")
    compensated = cfg.solver.compensated
    if compensated is None:
        compensated = torch.finfo(dtype).bits <= 32
    material = None
    if cfg.material.model == "neo_hookean":
        # matrix-free nonlinear stepper; the steady solve and the ghost
        # init keep the linearization at d0 = 0, which is exact there
        m = cfg.material
        material = NeoHookean.from_engineering(
            E=m.E, nu=m.nu, rho=m.rho, fz=m.fz, ramped=m.ramped
        )
    store = ArtifactStore(cfg.workdir, cfg.model_dir, cfg.surrogate.run_tag())
    shared_order, art_local = _load_artifact_layout(store, maps)
    sp = ShardedProblem.build(
        prob, maps, fint_mode=cfg.solver.fint_mode, dtype=dtype,
        exchange_mode=cfg.solver.exchange_mode, compensated=compensated,
        material=material, nh_stencil=cfg.solver.nh_stencil,
        shared_order=shared_order,
        device=dev if device_mesh is None else "cpu",
    )
    solver = ShardedSolver(sp, device_mesh)
    mark("device_pack_s")
    # banded mode RCM-reorders the local layout and the box paths (grid,
    # stencil, the Neo-Hookean stencil) lex-reorder it; sp.maps is
    # authoritative
    maps = sp.maps
    art_perm = None
    if art_local is not None:
        perms, differs = [], False
        for r in range(maps.n_parts):
            cur = np.asarray(maps.local_nodes[r])
            if np.array_equal(cur, art_local[r]):
                perms.append(None)
            else:
                lookup = {int(g): i for i, g in enumerate(cur)}
                perms.append(np.array(
                    [lookup[int(g)] for g in art_local[r]], dtype=np.int64
                ))
                differs = True
        art_perm = perms if differs else None
    ctx = StageContext(
        cfg, prob, maps, solver.sp, solver, store, dev,
        artifact_local_nodes=art_local, artifact_local_perm=art_perm,
    )
    mesh_info = {}
    if device_mesh is not None:
        mesh_info = dict(world=device_mesh.size(),
                         backend=str(dist.get_backend(ctx.comm.group)))
    ctx.log(
        "setup_breakdown",
        n_parts=cfg.partition.n_parts,
        elements=len(prob.mesh.tetra),
        partition_method=cfg.partition.method,
        partition_route=pinfo.get("route"),
        fint_mode=sp.fint_mode,
        nh_window=sp.nhw_W is not None,
        nh_stencil_dims=(
            list(sp.nhs_dims) if sp.nhs_dims is not None else None
        ),
        device=str(dev),
        **mesh_info,
        **tmarks,
    )
    # no rank writes the labels (stage 1, 4) before every rank has read
    # them above
    ctx.barrier()
    return ctx


def save_partition_labels(ctx: StageContext) -> None:
    """Rank-wise node/element/shared CSV labels (global artifacts: the
    root process writes them)."""
    if not ctx.is_root:
        return
    maps, store = ctx.maps, ctx.store
    local = ctx.artifact_local_nodes or maps.local_nodes
    for r in range(maps.n_parts):
        store.save_int_csv(store.local_nodes_csv(r), local[r])
        store.save_int_csv(store.shared_csv(r), maps.shared_nodes[r])
        store.save_int_csv(store.elements_csv(r), maps.local_elements[r])
    store.save_int_csv(store.global_shared_csv(), maps.global_shared)


def rank_trajectory(ctx: StageContext, traj, r: int) -> np.ndarray:
    """Part r's rows of the (P, T, DL) stacked trajectory (under a mesh,
    the rank's block, which holds part r) -> reference layout (3*n_local,
    T), rows permuted to the artifact node order when one was adopted."""
    n_real = 3 * len(ctx.maps.local_nodes[r])
    rows = np.asarray(traj[r - ctx.sp.part0][:, :n_real])
    perm = (
        ctx.artifact_local_perm[r]
        if ctx.artifact_local_perm is not None else None
    )
    if perm is not None:
        rows = rows.reshape(len(rows), -1, 3)[:, perm].reshape(
            len(rows), n_real
        )
    return rows.T
