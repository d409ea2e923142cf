from .vtk_io import Mesh, read_vtk, write_vtk
from .vtu_io import read_vtu, write_vtu
from .msh_io import read_mesh, read_msh, write_msh
from .generator import beam_mesh, irregular_beam_mesh, to_p2, tube_mesh
from .geometry import cfl_dt, dirichlet_nodes, min_mesh_size, node_to_dof

__all__ = [
    "Mesh",
    "read_vtk",
    "write_vtk",
    "read_vtu",
    "write_vtu",
    "read_msh",
    "write_msh",
    "read_mesh",
    "beam_mesh",
    "tube_mesh",
    "irregular_beam_mesh",
    "to_p2",
    "cfl_dt",
    "dirichlet_nodes",
    "min_mesh_size",
    "node_to_dof",
]
