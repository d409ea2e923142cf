from .explicit import make_step_fn, run_explicit
from .nonlinear import NeoHookeanFIntOperator
from .problem import AssembledProblem, setup_problem
from .steady import (
    eigen_modes,
    ghost_step_init,
    ghost_step_init_cg,
    steady_displacement,
    steady_solve,
)

__all__ = ["AssembledProblem", "setup_problem", "ghost_step_init",
           "ghost_step_init_cg", "steady_displacement", "steady_solve",
           "eigen_modes", "make_step_fn", "run_explicit",
           "NeoHookeanFIntOperator"]
