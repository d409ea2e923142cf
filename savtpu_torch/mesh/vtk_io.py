"""Legacy ASCII VTK (DataFile 2.0, UNSTRUCTURED_GRID) reader/writer.

The reference reads its mesh with meshio (Data_prepare.py:56-62) and writes
the steady solution back as VTK (Data_prepare.py:168). We depend on nothing:
the legacy format is a few whitespace-separated blocks. Supports tetra (type
10), triangle (type 5), and quadratic tetra (type 24) cells, plus POINT_DATA
scalar fields on write — everything the pipeline needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_CELL_TYPE_BY_NAME = {"triangle": 5, "tetra": 10, "tetra10": 24}
_NAME_BY_CELL_TYPE = {v: k for k, v in _CELL_TYPE_BY_NAME.items()}
_NODES_PER_CELL = {"triangle": 3, "tetra": 4, "tetra10": 10}


@dataclass
class Mesh:
    """In-memory unstructured mesh.

    points: (N, 3) float64; cells: name -> (E, nodes_per_cell) int32 arrays
    (same role as meshio's ``cells_dict`` used at Data_prepare.py:58-60).
    """

    points: np.ndarray
    cells: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def tetra(self) -> np.ndarray:
        return self.cells["tetra"]

    @property
    def triangles(self) -> Optional[np.ndarray]:
        return self.cells.get("triangle")

    @property
    def num_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def num_dofs(self) -> int:
        return 3 * self.num_points


def read_vtk(path: str | Path) -> Mesh:
    """Parse a legacy ASCII VTK unstructured grid."""
    tokens = _tokenize(path)
    i = 0
    points = None
    conn = None
    types = None
    n = len(tokens)
    while i < n:
        tok = tokens[i].upper()
        if tok == "POINTS":
            npts = int(tokens[i + 1])
            # tokens[i+2] is the dtype name
            flat = np.array(tokens[i + 3 : i + 3 + 3 * npts], dtype=np.float64)
            points = flat.reshape(npts, 3)
            i += 3 + 3 * npts
        elif tok == "CELLS":
            ncell = int(tokens[i + 1])
            total = int(tokens[i + 2])
            conn = np.array(tokens[i + 3 : i + 3 + total], dtype=np.int64)
            i += 3 + total
        elif tok == "CELL_TYPES":
            ncell = int(tokens[i + 1])
            types = np.array(tokens[i + 2 : i + 2 + ncell], dtype=np.int64)
            i += 2 + ncell
        else:
            i += 1

    if points is None or conn is None or types is None:
        raise ValueError(f"{path}: missing POINTS/CELLS/CELL_TYPES block")

    cells: Dict[str, list] = {}
    pos = 0
    for t in types:
        cnt = int(conn[pos])
        ids = conn[pos + 1 : pos + 1 + cnt]
        pos += 1 + cnt
        name = _NAME_BY_CELL_TYPE.get(int(t))
        if name is not None:
            cells.setdefault(name, []).append(ids)

    return Mesh(
        points=points,
        cells={k: np.asarray(v, dtype=np.int32) for k, v in cells.items()},
    )


def _tokenize(path: str | Path) -> list:
    """Tokenize the body of a legacy VTK file.

    The legacy header is LINE-structured (version comment, then one
    free-text title line, then the ASCII/BINARY marker, then the DATASET
    line), so it is parsed line by line here — the title line is skipped
    verbatim no matter what it contains (it may legally hold numbers or
    keywords, which a token-soup heuristic would mis-parse)."""
    lines = Path(path).read_text().splitlines()
    i = 0
    while i < len(lines) and not lines[i].strip():
        i += 1
    if i < len(lines) and lines[i].lstrip().startswith("#"):
        i += 1  # '# vtk DataFile Version x.x'
        while i < len(lines) and not lines[i].strip():
            i += 1
        i += 1  # the title line, skipped verbatim

    toks: list = []
    for line in lines[i:]:
        s = line.strip()
        if not s or s.startswith("#") or s.startswith("//"):
            continue
        first = s.split()[0].upper()
        if first in ("ASCII", "BINARY"):
            if first == "BINARY":
                raise ValueError(f"{path}: binary legacy VTK not supported")
            continue
        if first == "DATASET":
            kind = s.split()[1].upper() if len(s.split()) > 1 else ""
            if kind != "UNSTRUCTURED_GRID":
                raise ValueError(
                    f"{path}: unsupported DATASET {kind or '<missing>'}; "
                    f"only UNSTRUCTURED_GRID is supported"
                )
            continue
        toks.extend(s.split())
    return toks


def write_vtk(
    path: str | Path,
    mesh: Mesh,
    point_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write a legacy ASCII VTK unstructured grid with optional scalar
    POINT_DATA fields (used for the steady solution, as the reference does
    via meshio.write_points_cells at Data_prepare.py:168)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(mesh.points, dtype=np.float64)
    lines = [
        "# vtk DataFile Version 2.0",
        "savtpu mesh",
        "ASCII",
        "DATASET UNSTRUCTURED_GRID",
        f"POINTS {len(pts)} double",
    ]
    lines += [" ".join(f"{v:.17g}" for v in p) for p in pts]

    blocks = [(name, np.asarray(arr)) for name, arr in mesh.cells.items()]
    ncells = sum(len(arr) for _, arr in blocks)
    total = sum(arr.size + len(arr) for _, arr in blocks)
    lines.append(f"CELLS {ncells} {total}")
    for name, arr in blocks:
        k = _NODES_PER_CELL[name]
        lines += [f"{k} " + " ".join(str(int(v)) for v in row) for row in arr]
    lines.append(f"CELL_TYPES {ncells}")
    for name, arr in blocks:
        lines += [str(_CELL_TYPE_BY_NAME[name])] * len(arr)

    if point_data:
        lines.append(f"POINT_DATA {len(pts)}")
        for fname, vals in point_data.items():
            vals = np.asarray(vals).reshape(len(pts), -1)
            if vals.shape[1] == 1:
                lines.append(f"SCALARS {fname} double 1")
                lines.append("LOOKUP_TABLE default")
                lines += [f"{v:.17g}" for v in vals[:, 0]]
            else:
                lines.append(f"VECTORS {fname} double")
                lines += [" ".join(f"{x:.17g}" for x in v) for v in vals]

    path.write_text("\n".join(lines) + "\n")
