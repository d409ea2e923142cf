from .expfit import (
    advance_expfit,
    eval_expfit,
    eval_expfit_device,
    fit_expfit,
    init_expfit,
    matrix_pencil,
)
from .modal import from_modal, modal_basis, to_modal

__all__ = [
    "advance_expfit",
    "eval_expfit",
    "eval_expfit_device",
    "fit_expfit",
    "init_expfit",
    "matrix_pencil",
    "from_modal",
    "modal_basis",
    "to_modal",
]
