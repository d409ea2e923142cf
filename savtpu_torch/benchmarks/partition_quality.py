"""Partition quality of the port (counterpart of the JAX package's
``benchmarks/partition_quality.py``): interface size and edge cut per
partition method.

    python -m savtpu_torch.benchmarks.partition_quality [--out PATH]

The interface (shared-node) count sets the surrogate's input width and
the per-step exchange volume, and the edge cut tracks the halo work: the
quantities ParMETIS minimises for the reference (Data_prepare.py:94). It
measures graph, rcb and slab (``parallel.partition_elements``; graph
through the ``native/`` refiner where it builds) on the beam and on two
geometries that are not slab-like, a thick block and a plate. Host only:
no device. It prints one JSON line per row and a markdown table, and
writes the rows only to ``--out``; without it nothing is written. Where
the reference repository's unstructured mesh (``REF_MESH``) exists, it
is measured too, as ``gmsh_beam_unstructured``, as the JAX package does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ..mesh import beam_mesh, read_vtk
from ..parallel import build_partition_maps, partition_elements
from ..parallel.partition import dual_graph
from . import REF_MESH


def measure(cells, points, n_parts, method):
    t0 = time.perf_counter()
    epart = partition_elements(cells, points, n_parts, method=method)
    part_s = time.perf_counter() - t0
    dn = np.zeros(0, dtype=np.int64)
    maps = build_partition_maps(cells, epart, len(points), dn)

    xadj, adjncy = dual_graph(cells)
    src = np.repeat(np.arange(len(cells)), np.diff(xadj))
    cut = int(np.sum(epart[src] != epart[adjncy]) // 2)

    counts = np.bincount(epart, minlength=n_parts)
    return {
        "method": method,
        "n_parts": n_parts,
        "edge_cut": cut,
        "global_shared_nodes": int(len(maps.global_shared)),
        "max_shared_per_part": int(maps.max_shared),
        "imbalance": float(counts.max() / (len(cells) / n_parts)),
        "partition_seconds": round(part_s, 4),
    }


GEOMETRIES = {
    # slab-like: the reference cantilever family
    "beam_48x4x4": ((48, 4, 4), (12.0, 1.0, 1.0)),
    # thick block: no long axis, slab and rcb must cut large faces
    "block_12x12x12": ((12, 12, 12), (1.0, 1.0, 1.0)),
    # flat plate: two comparable axes
    "plate_24x24x3": ((24, 24, 3), (8.0, 8.0, 1.0)),
}
PART_COUNTS = (4, 8, 16)
METHODS = ("graph", "rcb", "slab")


def rows(mesh, name):
    """The rows of one mesh: every part count with at least 8 elements a
    part, every method."""
    out = []
    for n_parts in PART_COUNTS:
        if n_parts * 8 > len(mesh.tetra):
            continue
        for method in METHODS:
            r = measure(mesh.tetra, mesh.points, n_parts, method)
            r["geometry"] = name
            r["elements"] = len(mesh.tetra)
            out.append(r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="the JSON file to write (none written without it)")
    args = ap.parse_args(argv)

    meshes = {name: beam_mesh(*cells_n, extent=extent)
              for name, (cells_n, extent) in GEOMETRIES.items()}
    # the reference's gmsh mesh is unstructured: the case where FM
    # refinement can beat coordinate bisection
    if REF_MESH.exists():
        meshes["gmsh_beam_unstructured"] = read_vtk(REF_MESH)
    results = []
    for name, mesh in meshes.items():
        for r in rows(mesh, name):
            results.append(r)
            print(json.dumps(r), flush=True)

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=2))

    print("\n| geometry | parts | method | edge cut | shared nodes "
          "| max shared/part | imbalance |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        print(
            f"| {r['geometry']} | {r['n_parts']} | {r['method']} "
            f"| {r['edge_cut']} | {r['global_shared_nodes']} "
            f"| {r['max_shared_per_part']} | {r['imbalance']:.2f} |"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
