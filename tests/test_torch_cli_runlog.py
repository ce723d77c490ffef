"""The command line's run log, progress and profiling hook of the port
(``core.runlog``, ``utils.profiling``) against the JAX package's: the
``Progress`` lines and ``RunLogger``'s lines under one monkeypatched
clock, and ``maybe_profile`` (a trace that parses as JSON, a no-op without
a directory)."""

import glob
import json

import numpy as np
import pytest
import torch

from imageprocess_tpu.core import runlog as jrunlog
from imageprocess_tpu_torch.core import runlog as trunlog
from imageprocess_tpu_torch.utils import maybe_profile

TICKS = (2, 1, 3, 1, 2, 1, 1, 2, 1, 3, 1, 2, 4, 1, 1)


def _clock(monkeypatch, step=0.25):
    clock = iter(np.arange(1000.0, 5000.0, step))
    now = lambda: float(next(clock))  # noqa: E731
    for mod in (trunlog, jrunlog):
        monkeypatch.setattr(mod.time, "time", now)


def test_progress_defaults_are_jax_defaults(monkeypatch):
    _clock(monkeypatch, step=1.5)
    out = {}
    for name, mod in (("t", trunlog), ("j", jrunlog)):
        lines = []
        prog = mod.Progress(40, log=lines.append)
        for n in TICKS:
            prog.step(n)
        out[name] = lines
    assert out["t"] == out["j"] and len(out["t"]) == len(TICKS)


def test_run_logger_lines_match_jax(tmp_path):
    out = {}
    for name, mod in (("t", trunlog), ("j", jrunlog)):
        lines = []
        log = mod.RunLogger(str(tmp_path / name), echo=lines.append)
        log("first", 1)
        log("second")
        log.close()
        with open(log.path, encoding="utf-8") as f:
            text = f.read().splitlines()
        assert text[0].startswith("[START] ") and text[-1].startswith("[END] ")
        out[name] = (lines, text[1:-1])
    assert out["t"] == out["j"]
    assert out["t"][0] == ["first 1", "second"] == out["t"][1]


def test_maybe_profile_writes_a_trace_on_the_cpu(tmp_path):
    with maybe_profile(str(tmp_path / "trace"), torch.device("cpu")):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(x[0, 0]) == 64.0
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("trace_dir", [None, ""])
def test_maybe_profile_without_a_directory_is_a_no_op(trace_dir, tmp_path, monkeypatch):
    import torch.profiler

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.profiler, "profile", None)  # would fail if used
    with maybe_profile(trace_dir, "cpu"):
        pass
    assert list(tmp_path.iterdir()) == []

