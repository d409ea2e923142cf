"""Partition localization and halo (shared-node) index maps (NumPy copy
of ``savtpu/parallel/halo.py``: ``PartitionMaps``,
``build_partition_maps``, ``local_cells_of``, ``rcm_reorder_maps``).

- per-part element lists (ascending global order),
- per-part node lists in *first-touch* order — this order defines the
  local DOF layout (the RCM reorder below replaces it in banded mode),
- shared nodes: nodes owned by >= 2 parts, per part in local order,
- the sorted global union of shared nodes,
- per-part Dirichlet DOFs.

The first-touch scan is a vectorized ``np.unique`` instead of the JAX
package's native C++ kernel; the order it returns is the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class PartitionMaps:
    n_parts: int
    epart: np.ndarray                    # (E,) element -> part
    local_elements: List[np.ndarray]     # per part: global element ids
    local_nodes: List[np.ndarray]        # per part: first-touch node ids
    shared_nodes: List[np.ndarray]       # per part: its shared node ids
    global_shared: np.ndarray            # sorted union of shared nodes
    local_dirichlet: List[np.ndarray]    # per part: local DOF ids clamped

    @property
    def max_local_nodes(self) -> int:
        return max(len(l) for l in self.local_nodes)

    @property
    def max_shared(self) -> int:
        return max((len(s) for s in self.shared_nodes), default=0)

    def local_index_of(self, p: int, global_nodes: np.ndarray) -> np.ndarray:
        """Positions of global node ids inside part p's local node list
        (local_mat_node, Distributed_tools.py:66-73)."""
        lookup = {int(g): i for i, g in enumerate(self.local_nodes[p])}
        return np.array([lookup[int(g)] for g in global_nodes], dtype=np.int64)


def local_cells_of(nodes, cells, elems, scratch):
    """Vectorized global->local renumbering of element connectivity:
    (E_local, nb) local node ids of ``elems``'s rows of ``cells`` under
    the part's ``nodes`` ordering. ``scratch`` is a reusable (n_global,)
    int64 work array (left reset to -1) — replaces the per-part Python
    dict loops that dominated ShardedProblem.build's host time at
    589k elements x 256 parts (~4 min of device_pack_s)."""
    scratch[nodes] = np.arange(len(nodes), dtype=np.int64)
    out = scratch[cells[elems]]
    scratch[nodes] = -1
    return out


def _first_touch(flat: np.ndarray, n_global: int) -> np.ndarray:
    """Distinct values of ``flat`` in order of first appearance."""
    del n_global
    uniq, first = np.unique(np.asarray(flat), return_index=True)
    return uniq[np.argsort(first, kind="stable")].astype(np.int64)


def build_partition_maps(
    cells: np.ndarray,
    epart: np.ndarray,
    n_points: int,
    dirichlet_nodes: np.ndarray,
) -> PartitionMaps:
    cells = np.asarray(cells)
    epart = np.asarray(epart)
    n_parts = int(epart.max()) + 1 if len(epart) else 1

    local_elements, local_nodes = [], []
    owner_count = np.zeros(n_points, dtype=np.int64)
    for p in range(n_parts):
        elems = np.flatnonzero(epart == p)
        nodes = _first_touch(cells[elems].reshape(-1), n_points)
        local_elements.append(elems)
        local_nodes.append(nodes)
        owner_count[nodes] += 1

    shared_mask = owner_count >= 2
    shared_nodes = [ln[shared_mask[ln]] for ln in local_nodes]
    global_shared = np.sort(np.flatnonzero(shared_mask))

    dset = np.zeros(n_points, dtype=bool)
    dset[np.asarray(dirichlet_nodes, dtype=np.int64)] = True
    local_dirichlet = []
    for p in range(n_parts):
        loc = np.flatnonzero(dset[local_nodes[p]])
        local_dirichlet.append(
            (3 * loc[:, None] + np.arange(3)[None, :]).reshape(-1)
        )

    return PartitionMaps(
        n_parts=n_parts,
        epart=epart,
        local_elements=local_elements,
        local_nodes=local_nodes,
        shared_nodes=shared_nodes,
        global_shared=global_shared,
        local_dirichlet=local_dirichlet,
    )


def rcm_reorder_maps(maps: PartitionMaps, cells: np.ndarray) -> PartitionMaps:
    """Reverse-Cuthill-McKee reorder of each part's local node list.

    Minimizes the local stiffness bandwidth so the banded F_int mode can
    store K as block-tridiagonal chunks (parallel/sharded.py). The
    local DOF layout is an internal choice — all downstream maps
    (shared lists, Dirichlet, element localization) are rebuilt from the
    new order, so artifacts stay self-consistent."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    cells = np.asarray(cells)
    scratch = np.full(int(cells.max()) + 1, -1, dtype=np.int64)
    new_local = []
    for p in range(maps.n_parts):
        nodes = maps.local_nodes[p]
        loc = np.asarray(
            local_cells_of(nodes, cells, maps.local_elements[p], scratch)
        )
        L = len(nodes)
        rows, cols = [], []
        nb = loc.shape[1]
        for a in range(nb):
            for b in range(nb):
                rows.append(loc[:, a])
                cols.append(loc[:, b])
        adj = sps.coo_matrix(
            (
                np.ones(len(maps.local_elements[p]) * nb * nb),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(L, L),
        ).tocsr()
        perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
        new_local.append(nodes[perm])

    # rebuild shared + dirichlet in the new local orders
    new_shared = [
        ln[np.isin(ln, maps.global_shared)] for ln in new_local
    ]
    # recover dirichlet node set from the old maps (local dof -> node)
    new_dirichlet = []
    for p in range(maps.n_parts):
        old_nodes = maps.local_nodes[p]
        dir_nodes = set(
            int(old_nodes[d // 3]) for d in maps.local_dirichlet[p]
        )
        loc = np.flatnonzero(
            np.fromiter((int(g) in dir_nodes for g in new_local[p]), bool)
        )
        new_dirichlet.append(
            (3 * loc[:, None] + np.arange(3)[None, :]).reshape(-1)
        )

    return PartitionMaps(
        n_parts=maps.n_parts,
        epart=maps.epart,
        local_elements=maps.local_elements,
        local_nodes=new_local,
        shared_nodes=new_shared,
        global_shared=maps.global_shared,
        local_dirichlet=new_dirichlet,
    )
