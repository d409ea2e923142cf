"""Run log, step timer and profiler trace (port of
``savtpu/utils/profiling.py``: ``MetricsLog``, ``stage_log``,
``StepTimer``, ``profile_trace``).

``profile_trace`` records a ``torch.profiler`` trace (CPU, and CUDA where
a card is present) and writes it as a Chrome trace under its directory.
Where the JAX package's ``profile_trace`` does nothing when the profiler
fails to start, this one raises: a missing trace is never silent.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import torch


@dataclass
class StepTimer:
    """Wall-clock section timer with derived throughput metrics."""

    n_elements: int = 0
    sections: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = (
                self.sections.get(name, 0.0) + time.perf_counter() - t0
            )

    def throughput(self, name: str, num_steps: int) -> Dict[str, float]:
        el = self.sections.get(name, 0.0)
        sps = num_steps / el if el > 0 else float("inf")
        out = {"seconds": el, "timesteps_per_sec": sps}
        if self.n_elements:
            out["element_updates_per_sec"] = sps * self.n_elements
        return out

    def report(self, path: Optional[str | Path] = None) -> Dict:
        data = dict(self.sections)
        if path is not None:
            Path(path).write_text(json.dumps(data, indent=2))
        return data


@contextlib.contextmanager
def profile_trace(logdir: str | Path):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA where available) and write a Chrome trace into ``logdir``.
    Yields the profiler (``key_averages()`` etc.); its ``trace_path`` is
    set on exit. Raises RuntimeError where the profiler cannot start
    (e.g. another profiler is running)."""
    from torch import profiler

    if torch._C._autograd._profiler_enabled():
        # a second profiler on top of a running one crashes the process
        raise RuntimeError("the profiler did not start: another profiler "
                           "is running")
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    try:
        prof = profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        raise RuntimeError(f"the profiler did not start: {e}") from e
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.trace_path = logdir / f"trace-{os.getpid()}-{time.time_ns()}.json"
        prof.export_chrome_trace(str(prof.trace_path))


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
