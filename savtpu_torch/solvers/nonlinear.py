"""Neo-Hookean matrix-free internal forces for the serial runner (port of
``savtpu/solvers/nonlinear.py``).

The internal force is recomputed from the current displacement every
step: per-element deformation gradient, first Piola-Kirchhoff stress and
nodal forces (``ops.element.neo_hookean_element_fint``), then each DOF's
incident element rows summed in element order by a fixed-width gather
(``ops.assembly.incident_lists``), where the JAX package uses a segment
sum: no scatter-add, so no atomics on a card. It drops into
``solvers.explicit.make_step_fn`` in place of ``FIntOperator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.assembly import incident_lists
from ..ops.element import neo_hookean_element_fint
from ..ops.material import NeoHookean


class NeoHookeanFIntOperator:
    """F_int(d) of P1 tets under Neo-Hookean stress; the tensors live on
    ``coords``' device."""

    def __init__(self, material: NeoHookean, coords: torch.Tensor, edofs,
                 ndof: int):
        self.material = material
        self.coords = coords                     # (E, 4, 3)
        self.device = coords.device
        self.ndof = int(ndof)
        ed = np.asarray(edofs, dtype=np.int64)
        self.edofs = torch.as_tensor(ed).to(self.device)   # (E, 12)
        # one "part" whose dummy slot (ndof) no element writes into
        self._slots = torch.as_tensor(
            incident_lists(ed[None], ndof + 1)[0, :ndof]).to(self.device)

    def __call__(self, d: torch.Tensor) -> torch.Tensor:
        d = d.reshape(-1)
        fe = neo_hookean_element_fint(self.material, self.coords,
                                      d[self.edofs]).reshape(-1)
        flat = torch.cat([fe, fe.new_zeros(1)])
        return flat[self._slots].sum(-1)
