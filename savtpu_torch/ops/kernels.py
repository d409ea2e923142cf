"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` on its own into ``_build/<name>-<hash>.so`` (the hash covers the
source and the flags), then loaded with ``ctypes``. Nothing here includes
PyTorch's headers, so a build takes seconds. The library is built at first
use; :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# -fmad=false: no mul+add contraction, so every update and compensation
# op rounds exactly as the plain PyTorch version does
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    name: str
    path: Path
    seconds: float      # compile time in this process (0.0 if cached)
    log: str            # nvcc / ptxas output of the build


_LOADED: dict = {}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels are built from source"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp path, target)."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build_all(names) -> dict:
    """Build every named kernel library that is not built yet, one nvcc
    process per source, in parallel. Returns {name: Built}."""
    out, running = {}, []
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            log_path = target.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            out[name] = Built(name, target, 0.0, log)
        else:
            running.append((name, *_start(name)))
    for name, proc, tmp, target in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
        out[name] = Built(name, target, time.perf_counter() - t0, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _LOADED.get(name)
    if lib is None:
        built = build_all([name])[name]
        lib = ctypes.CDLL(str(built.path))
        lib.savtpu_error_string.restype = ctypes.c_char_p
        lib.savtpu_error_string.argtypes = [ctypes.c_int]
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.savtpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
