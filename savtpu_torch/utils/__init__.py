"""Run log (port of ``savtpu/utils/profiling.py``: ``MetricsLog`` and
``stage_log``) and device selection."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch


class MetricsLog:
    """Append-only JSONL run log: one {"ts", "event", **fields} line per
    event. Every pipeline stage appends to <workdir>/metrics.jsonl."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


def stage_log(cfg) -> MetricsLog:
    """The pipeline's shared metrics log under cfg.workdir."""
    return MetricsLog(Path(cfg.workdir) / "metrics.jsonl")


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
