"""Device selection, and the run log, step timer and profiler trace of
``utils/profiling.py`` (re-exported)."""

from __future__ import annotations

import torch

from .profiling import MetricsLog, StepTimer, profile_trace, stage_log

__all__ = ["MetricsLog", "StepTimer", "profile_trace", "stage_log",
           "resolve_device", "full_precision_products", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """The device a run uses: CUDA unless the caller asks for another.
    Raises when CUDA is asked for (or defaulted to) and absent — a run
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run on the CPU"
        )
    return dev


def full_precision_products() -> None:
    """Keep float32 products in full float32 on the card: no TF32 in
    matmuls or cuDNN. The JAX package computes them at HIGHEST precision;
    FEM matvecs cancel heavily and the LSTM's recursive decode feeds its
    products back. Every stage that multiplies on the device, and
    ``fit_stacked``, passes through here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
