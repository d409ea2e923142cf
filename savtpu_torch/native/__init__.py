"""The port's native (C++) host code, loaded through ctypes (after
``savtpu/native/__init__.py``).

``sav_native.cpp`` copies the JAX package's source, all three entry
points: ``sav_partition_refine`` (:func:`native_refine`),
Fiduccia-Mattheyses boundary refinement of a k-way partition, the
stand-in for the reference's ParMETIS, which the graph partition calls;
``sav_partition_graph`` (:func:`native_partition`), a k-way partition
of its own from greedy growing; and ``sav_first_touch``
(:func:`native_first_touch`), the first-appearance dedup of a node-id
stream. It is built with ``g++`` at first use into
``savtpu_torch/_build/`` (the file name carries a hash of the source and
the flags), never into or from the JAX package's directory. Without a
toolchain every entry point returns None, as the JAX package's do: the
graph partition then takes its NumPy refiner, which gives another
partition, and records which route it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "sav_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_tried = False


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsavnative-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None without g++."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    target = _target()
    if not target.exists() and not _build(target):
        return None
    lib = ctypes.CDLL(str(target))
    ptr = ctypes.POINTER(ctypes.c_int64)
    for name in ("sav_partition_refine", "sav_partition_graph"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ptr,             # xadj
            ptr,             # adjncy
            ctypes.c_int64,  # n vertices
            ctypes.c_int64,  # n parts
            ctypes.c_int64,  # refinement passes
            ptr,             # epart: in/out (refine), out (graph)
        ]
    lib.sav_first_touch.restype = ctypes.c_int64
    lib.sav_first_touch.argtypes = [
        ptr,             # flat node ids
        ctypes.c_int64,  # count
        ctypes.c_int64,  # n nodes global
        ptr,             # out unique ids (cap = count)
    ]
    _lib = lib
    return _lib


def native_partition(xadj, adjncy, n_parts, refine_passes=8):
    """k-way partition of a CSR graph (the dual graph of a mesh) by the C++
    greedy growing and refinement; None if the library is unavailable or
    refuses the input."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = ctypes.POINTER(ctypes.c_int64)
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    out = np.empty(len(xadj) - 1, dtype=np.int64)
    rc = lib.sav_partition_graph(
        xadj.ctypes.data_as(ptr), adjncy.ctypes.data_as(ptr),
        len(xadj) - 1, n_parts, refine_passes, out.ctypes.data_as(ptr),
    )
    return out if rc == 0 else None


def native_refine(xadj, adjncy, epart, n_parts, refine_passes=8):
    """FM boundary refinement of a given partition (in a copy); None if
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = ctypes.POINTER(ctypes.c_int64)
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    out = np.ascontiguousarray(epart, dtype=np.int64).copy()
    rc = lib.sav_partition_refine(
        xadj.ctypes.data_as(ptr), adjncy.ctypes.data_as(ptr),
        len(xadj) - 1, n_parts, refine_passes, out.ctypes.data_as(ptr),
    )
    return out if rc == 0 else None


def native_first_touch(flat_nodes, n_nodes_global):
    """The node ids of a flat stream in order of first appearance; None
    if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = ctypes.POINTER(ctypes.c_int64)
    flat = np.ascontiguousarray(flat_nodes, dtype=np.int64)
    out = np.empty(len(flat), dtype=np.int64)
    cnt = lib.sav_first_touch(flat.ctypes.data_as(ptr), len(flat),
                              n_nodes_global, out.ctypes.data_as(ptr))
    return out[:cnt].copy()
