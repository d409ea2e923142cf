"""One-shot problem assembly: everything the time loop needs, precomputed
(port of ``savtpu/solvers/problem.py``).

CFL dt, lumped mass, pre-assembled external force, Dirichlet DOFs and the
ghost step, as host tensors. Assembly ALWAYS runs in float64 on the host
and is then cast to the run dtype: assembling in float32 costs ~500x
trajectory accuracy (element integrals, lumped mass and the ghost init all
lose bits that the stepper then amplifies over 1e5 steps).
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..mesh import Mesh, beam_mesh, cfl_dt, dirichlet_nodes, read_vtk
from ..mesh.geometry import node_to_dof
from ..ops.assembly import (
    assemble_force,
    assemble_lumped_mass,
    dirichlet_mask,
    element_dofs,
)
from ..ops.element import batch_element_mkf, gather_coords
from ..ops.material import LinearElastic


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
        if not str(cfg.mesh_path).lower().endswith(".vtk"):
            raise NotImplementedError(
                f"{cfg.mesh_path}: only legacy .vtk meshes are read by the "
                "port so far (.msh/.vtu readers are not ported yet)"
            )
        return read_vtk(cfg.mesh_path)
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
    if sol.deg != 1:
        raise NotImplementedError(
            "only P1 tets are ported (the P2 path is steady-only in the "
            "JAX package)"
        )
    if mat_cfg.model != "linear":
        raise NotImplementedError(
            f"material.model {mat_cfg.model!r} is not ported yet"
        )
    if not mat_cfg.ramped:
        raise NotImplementedError(
            "an unramped load needs the ghost-step solve, which is not "
            "ported yet"
        )
    if mesh is None:
        mesh = load_mesh(cfg)

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

    cells = mesh.tetra
    points = mesh.points
    ndof = mesh.num_dofs
    dt = cfl_dt(cells, points, mat_cfg.E, mat_cfg.rho, mat_cfg.nu,
                gamma=sol.gamma)

    coords = gather_coords(cells, points, dtype=torch.float64)
    edofs = element_dofs(cells)
    Me, Ke, Fe = batch_element_mkf(
        sol.deg, sol.n_quad, material_steady, 0.0, coords
    )
    lumped_M = assemble_lumped_mass(Me, edofs, ndof)
    F_pre = assemble_force(Fe, edofs, ndof)

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
    # the initial acceleration is 0, so d_{-1} = 0 analytically
    d0 = torch.zeros((ndof,), dtype=torch.float64)
    dn = torch.zeros((ndof,), dtype=torch.float64)

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
