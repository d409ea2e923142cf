"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` on its own into ``_build/<name>-<hash>.so`` (the hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags), then loaded
with ``ctypes``. Nothing here includes PyTorch's headers, so a build takes
seconds. The library is built at first use; :func:`build_all` starts one
``nvcc`` per source, all at once. The helpers below are what every
kernel wrapper shares: the C function with its argument types, the
shared-slot map, the dtype suffix, the stream, and the checks of the
tensors going in and of the error code coming out.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# -fmad=false: no mul+add contraction, so every update and compensation
# op rounds exactly as the plain PyTorch version does
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Shared memory one block may use on an H100 (sm_90, opt-in dynamic): the
# size rule of the gates that send a run to a one-block-per-part kernel
SMEM_PER_BLOCK = 232_448


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
    """The library's path; its hash covers the source, every shared header
    of ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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


def function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library, with its
    argument types declared and an int (CUDA error code) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def slot_map(sld: torch.Tensor, smask: torch.Tensor, n: int) -> torch.Tensor:
    """(P, n) int32 map from local DOF to shared slot: slot[p, j] = s where
    sld[p, s] == j on a valid slot (smask > 0), else -1. The kernels
    overwrite and record the shared slots through it."""
    P, S3 = sld.shape
    out = torch.full((P, n + 1), -1, dtype=torch.int32, device=sld.device)
    tgt = torch.where(smask > 0, sld, torch.full_like(sld, n))
    if int(tgt.max()) > n:
        raise ValueError(f"a valid shared slot lies past the {n} local DOFs")
    src = torch.arange(S3, dtype=torch.int32, device=sld.device)
    out.scatter_(1, tgt, src.expand(P, S3))
    return out[:, :n].contiguous()


def suffix(dtype) -> str:
    """The C symbol suffix of a kernel's ``dtype`` instance."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the kernels take float32 or float64, not {dtype}")


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream


def check_tensors(what: str, device, dtype, specs) -> None:
    """Raise unless every (name, tensor, shape) of ``specs`` is a
    contiguous tensor of that shape, ``dtype`` and ``device``."""
    for name, t, shape in specs:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} on {device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be contiguous {tuple(shape)}, got "
                f"{tuple(t.shape)}"
            )


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch of ``csrc/<name>.cu``'s library returned a CUDA
    error code."""
    if err != 0:
        msg = load(name).savtpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
