"""Partition localization and halo (shared-node) index maps (NumPy copy
of ``savtpu/parallel/halo.py``: ``PartitionMaps``,
``build_partition_maps``, ``local_cells_of``, ``rcm_reorder_maps``,
``NeighborExchange`` and ``build_neighbor_exchange``).

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


@dataclass
class NeighborExchange:
    """The neighbour-packed halo exchange's static plan (exchange_mode
    'permute'): R rounds, in each of which every part sends its interface
    DOFs to at most one partner and receives that partner's. Greedy edge
    colouring of the part-adjacency graph gives the rounds (R <= max
    degree + 1). pack/unpack indices address the part's padded local DOF
    vector; padded buffer slots point at the dummy DOF and carry mask 0.
    """

    n_rounds: int
    buf_len: int                 # 3 * max pairwise interface size
    pack_idx: np.ndarray         # (P, R, B) local DOF to send (pad DL-1)
    unpack_idx: np.ndarray       # (P, R, B) local DOF to add into
    mask: np.ndarray             # (P, R, B) 1 on real slots
    src_of: np.ndarray           # (P, R) partner part id, -1 if idle
    pairs: list                  # per round: [(src, dst), ...]


def build_neighbor_exchange(maps: PartitionMaps, DL: int) -> NeighborExchange:
    """Pairwise interfaces and their greedy edge colouring.

    For parts p < q the interface is local_nodes[p] & local_nodes[q],
    ordered by global node id so both sides pack and unpack alike. Summing
    every partner's contribution reproduces the psum exchange: a node
    owned by k parts rides k-1 edges at each owner, so every owner
    accumulates all k contributions (in round order, which may differ
    from part to part)."""
    P = maps.n_parts
    node_sets = [set(ln.tolist()) for ln in maps.local_nodes]
    edges = []  # (p, q, sorted interface nodes)
    for p in range(P):
        for q in range(p + 1, P):
            inter = node_sets[p] & node_sets[q]
            if inter:
                edges.append((p, q, np.array(sorted(inter), dtype=np.int64)))

    # greedy edge colouring: the smallest colour free at both endpoints
    used = [set() for _ in range(P)]
    colors = []
    for p, q, _ in edges:
        c = 0
        while c in used[p] or c in used[q]:
            c += 1
        used[p].add(c)
        used[q].add(c)
        colors.append(c)
    R = max(colors, default=-1) + 1
    B = max((3 * len(e[2]) for e in edges), default=1)

    pack_idx = np.full((P, max(R, 1), B), DL - 1, dtype=np.int32)
    unpack_idx = np.full((P, max(R, 1), B), DL - 1, dtype=np.int32)
    mask = np.zeros((P, max(R, 1), B), dtype=np.float64)
    src_of = np.full((P, max(R, 1)), -1, dtype=np.int32)
    pairs: list = [[] for _ in range(max(R, 1))]

    for (p, q, inter), c in zip(edges, colors):
        for a, b in ((p, q), (q, p)):
            loc = maps.local_index_of(a, inter)
            dofs = (3 * loc[:, None] + np.arange(3)).reshape(-1)
            pack_idx[a, c, : len(dofs)] = dofs
            unpack_idx[a, c, : len(dofs)] = dofs
            mask[a, c, : len(dofs)] = 1.0
            src_of[a, c] = b
            pairs[c].append((a, b))

    return NeighborExchange(
        n_rounds=max(R, 1),
        buf_len=B,
        pack_idx=pack_idx,
        unpack_idx=unpack_idx,
        mask=mask,
        src_of=src_of,
        pairs=[tuple(sorted(pr)) for pr in pairs],
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
