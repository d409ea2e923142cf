from .problem import AssembledProblem, setup_problem
from .steady import steady_displacement

__all__ = ["AssembledProblem", "setup_problem", "steady_displacement"]
