"""One-shot problem assembly: everything the time loop needs, precomputed
(port of ``savtpu/solvers/problem.py``).

CFL dt, lumped mass, pre-assembled external force, Dirichlet DOFs and the
ghost step (0 under a ramped load; the consistent-mass solve of
``solvers/steady.py`` under an unramped one), as host tensors. P1, and
the steady-only P2 path (``solver.deg = 2``: a P1 mesh is promoted by
``mesh.to_p2``; the CFL dt comes from the corner tets). Assembly
ALWAYS runs in float64 on the host and is then cast to the run dtype:
assembling in float32 costs ~500x
trajectory accuracy (element integrals, lumped mass and the ghost init all
lose bits that the stepper then amplifies over 1e5 steps).
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..mesh import (
    Mesh,
    beam_mesh,
    cfl_dt,
    dirichlet_nodes,
    read_mesh,
    to_p2,
)
from ..mesh.geometry import node_to_dof
from ..ops.assembly import (
    assemble_force,
    assemble_lumped_mass,
    dirichlet_mask,
    element_dofs,
)
from ..ops.element import batch_element_mkf, gather_coords
from ..ops.material import LinearElastic
from .steady import ghost_step_init, ghost_step_init_cg


@dataclass
class AssembledProblem:
    """Static data of one elastodynamics problem (serial numbering); every
    tensor lives on the host."""

    mesh: Mesh
    material: LinearElastic
    deg: int
    n_quad: int
    dt: float
    alpha: float
    edofs: np.ndarray        # (E, 3nb) int32
    Ke: torch.Tensor         # (E, 3nb, 3nb) element stiffness
    lumped_M: torch.Tensor   # (ndof,) row-sum lumped mass
    F_pre: torch.Tensor      # (ndof,) unramped external force
    dirichlet_dofs: np.ndarray
    mask: torch.Tensor       # (ndof,) 0 on Dirichlet DOFs
    d0: torch.Tensor         # initial displacement
    dn: torch.Tensor         # ghost step d_{-1}
    coords: torch.Tensor     # (E, nb, 3) element coordinates

    @property
    def ndof(self) -> int:
        return self.mesh.num_dofs

    def with_dtype(self, dtype) -> "AssembledProblem":
        """Cast the runtime tensors to ``dtype``."""
        cast = lambda a: a.to(dtype)  # noqa: E731
        return dc_replace(
            self,
            Ke=cast(self.Ke),
            lumped_M=cast(self.lumped_M),
            F_pre=cast(self.F_pre),
            mask=cast(self.mask),
            d0=cast(self.d0),
            dn=cast(self.dn),
            coords=cast(self.coords),
        )


def load_mesh(cfg: Config) -> Mesh:
    if cfg.mesh_path is not None:
        return read_mesh(cfg.mesh_path)
    nx, ny, nz = cfg.beam_cells
    return beam_mesh(nx, ny, nz, extent=cfg.beam_extent)


def setup_problem(
    cfg: Config,
    mesh: Optional[Mesh] = None,
    dtype=torch.float64,
) -> AssembledProblem:
    """Assemble in float64 on the host, then cast to ``dtype``."""
    mat_cfg = cfg.material
    sol = cfg.solver
    if mat_cfg.model not in ("linear", "neo_hookean"):
        raise ValueError(
            f"unknown material.model {mat_cfg.model!r}; expected "
            "'linear' or 'neo_hookean'"
        )
    if mesh is None:
        mesh = load_mesh(cfg)

    # Neo-Hookean runs too: the linear M, F_pre and steady operator are
    # assembled as for the linear material, and the steady solve and the
    # ghost init keep the linearization at d0 = 0 (exact there). The
    # stepper's nonlinear forces come from ShardedProblem.build's
    # ``material`` (pipeline/common.py).
    material = LinearElastic(
        lmd=mat_cfg.lmd,
        mu=mat_cfg.mu,
        rho=mat_cfg.rho,
        fz=mat_cfg.fz,
        ramped=mat_cfg.ramped,
    )
    # unramped variant for F_pre and the lumped mass: the pre-assembled
    # load is the full body force, ramped per step
    material_steady = dc_replace(material, ramped=False)

    if sol.deg == 2:
        # the steady-only P2 path: a P1 mesh is promoted to tetra10 here;
        # the dynamic layers refuse deg != 1 themselves
        if "tetra10" not in mesh.cells:
            mesh = to_p2(mesh)
        cells = mesh.cells["tetra10"]
        corner_tets = cells[:, :4]
    elif sol.deg == 1:
        cells = mesh.tetra
        corner_tets = cells
    else:
        raise ValueError(f"unsupported polynomial degree {sol.deg}")
    points = mesh.points
    ndof = mesh.num_dofs
    dt = cfl_dt(corner_tets, points, mat_cfg.E, mat_cfg.rho, mat_cfg.nu,
                gamma=sol.gamma)

    coords = gather_coords(cells, points, dtype=torch.float64)
    edofs = element_dofs(cells)
    Me, Ke, Fe = batch_element_mkf(
        sol.deg, sol.n_quad, material_steady, 0.0, coords
    )
    lumped_M = assemble_lumped_mass(Me, edofs, ndof)
    F_pre = assemble_force(Fe, edofs, ndof)

    if sol.deg == 2:
        # the boundary triangles are corner facets, and the edge midpoints
        # on the clamped plane must be clamped too: detect by coordinate
        # over all nodes (the plane is the face on these geometries)
        dnodes = np.flatnonzero(
            np.abs(points[:, cfg.partition.dirichlet_axis]
                   - cfg.partition.dirichlet_value)
            < max(cfg.partition.dirichlet_tol, 1e-9)
        )
    else:
        dnodes = dirichlet_nodes(
            mesh.triangles,
            points,
            axis=cfg.partition.dirichlet_axis,
            value=cfg.partition.dirichlet_value,
            tol=cfg.partition.dirichlet_tol,
        )
    ddofs = node_to_dof(dnodes)
    mask = dirichlet_mask(ndof, ddofs)

    # ghost step d_{-1}: with a ramped load F(0) = 0 and zero initial data
    # the initial acceleration is 0, so d_{-1} = 0 analytically; an
    # unramped load solves M a0 = F(0) - K d0 with the consistent mass
    # (dense up to 6144 DOFs, CG beyond)
    d0 = torch.zeros((ndof,), dtype=torch.float64)
    if mat_cfg.ramped:
        dn = torch.zeros((ndof,), dtype=torch.float64)
    else:
        ghost = ghost_step_init if ndof <= 6144 else ghost_step_init_cg
        dn = ghost(Me, Ke, Fe, edofs, ndof, ddofs, d0, torch.zeros_like(d0),
                   float(dt))

    prob = AssembledProblem(
        mesh=mesh,
        material=material,
        deg=sol.deg,
        n_quad=sol.n_quad,
        dt=float(dt),
        alpha=sol.alpha,
        edofs=edofs,
        Ke=Ke,
        lumped_M=lumped_M,
        F_pre=F_pre,
        dirichlet_dofs=np.asarray(ddofs),
        mask=mask,
        d0=d0,
        dn=dn,
        coords=coords,
    )
    if dtype != torch.float64:
        prob = prob.with_dtype(dtype)
    return prob
