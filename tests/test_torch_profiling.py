"""The port's profiling utilities (``utils/profiling.py``): ``StepTimer``
as savtpu's (the same sections, throughput keys and report), the run log
re-exported from ``utils``, and ``profile_trace`` writing a Chrome trace
on the CPU that names the profiled ops, and raising where the profiler
cannot start (savtpu's does nothing there)."""

import json
import time

import pytest
import torch

torch.set_num_threads(1)


def test_step_timer_matches_savtpus(tmp_path):
    from savtpu.utils.profiling import StepTimer as JTimer

    from savtpu_torch.utils import StepTimer

    for T in (JTimer, StepTimer):
        t = T(n_elements=6)
        with t.section("solve"):
            time.sleep(0.01)
        with t.section("solve"):
            time.sleep(0.01)
        out = t.throughput("solve", 100)
        assert set(out) == {"seconds", "timesteps_per_sec",
                            "element_updates_per_sec"}
        assert out["seconds"] >= 0.02
        assert out["timesteps_per_sec"] == pytest.approx(
            100 / out["seconds"])
        assert out["element_updates_per_sec"] == pytest.approx(
            6 * out["timesteps_per_sec"])
        assert T().throughput("none", 5)["timesteps_per_sec"] == float("inf")
        rep = t.report(tmp_path / f"{T.__module__}.json")
        assert json.loads((tmp_path / f"{T.__module__}.json").read_text()) \
            == rep == {"solve": out["seconds"]}


def test_run_log_is_reexported(tmp_path):
    from savtpu_torch import utils
    from savtpu_torch.utils import profiling

    assert utils.MetricsLog is profiling.MetricsLog
    assert utils.stage_log is profiling.stage_log
    log = utils.MetricsLog(tmp_path / "m.jsonl")
    log.log("e", x=1)
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["event"] == "e" and rec["x"] == 1


def test_profile_trace_writes_a_trace(tmp_path):
    from savtpu_torch.utils import profile_trace

    a = torch.ones(64, 64, dtype=torch.float64)
    with profile_trace(tmp_path / "prof") as prof:
        for _ in range(3):
            a = torch.mm(a, a) * 1e-2
    path = prof.trace_path
    assert path.parent == tmp_path / "prof" and path.exists()
    names = {ev.get("name") for ev in json.loads(path.read_text())[
        "traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" and e.count == 3
               for e in prof.key_averages())


def test_profile_trace_raises_where_the_profiler_cannot_start(
        tmp_path, monkeypatch):
    from torch import profiler

    from savtpu_torch.utils import profile_trace

    # another profiler already running
    with profiler.profile():
        with pytest.raises(RuntimeError, match="another profiler"):
            with profile_trace(tmp_path / "inner"):
                pass
    assert not (tmp_path / "inner").exists() or not any(
        (tmp_path / "inner").iterdir())

    # a profiler that fails to start
    class Broken:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise OSError("no tracer")

    monkeypatch.setattr(profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="did not start: no tracer"):
        with profile_trace(tmp_path / "broken"):
            pass
