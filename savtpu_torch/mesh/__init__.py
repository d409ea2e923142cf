from .vtk_io import Mesh, read_vtk, write_vtk
from .generator import beam_mesh
from .geometry import cfl_dt, dirichlet_nodes, min_mesh_size, node_to_dof

__all__ = [
    "Mesh",
    "read_vtk",
    "write_vtk",
    "beam_mesh",
    "cfl_dt",
    "dirichlet_nodes",
    "min_mesh_size",
    "node_to_dof",
]
