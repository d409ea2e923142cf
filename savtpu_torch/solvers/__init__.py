from .problem import AssembledProblem, setup_problem
from .steady import (
    ghost_step_init,
    ghost_step_init_cg,
    steady_displacement,
)

__all__ = ["AssembledProblem", "setup_problem", "ghost_step_init",
           "ghost_step_init_cg", "steady_displacement"]
