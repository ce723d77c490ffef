"""The batched tables runners' own tracing (``timing.HostPhases``,
``timing.call_range``) on the CPU: under a ``torch.profiler`` every phase
is a ``phase:`` range, each call a ``call:`` range and each key's load a
``key:`` range; the main thread's phases never overlap and cover the call;
``IP_TIMING=1`` prints the new phases on an ``[IP_TIMING+]`` line; and no
switch changes a row.

The experiments hold a key of another frame shape (the serial path) and
one without ROIs, so that every main-thread phase runs.  The loader's
threads are recorded by a profiler that records every thread (the CLI's
``--xprof`` does); ``gather`` runs the loader without the fused native
call, so that ``ld_gather`` runs."""

import contextlib
import json
import os

import numpy as np
import pytest
from torch.profiler import _ExperimentalConfig, profile

from imageprocess_tpu_torch import native, timing
from imageprocess_tpu_torch.core import roiio, tiffio
from imageprocess_tpu_torch.pipelines import fret as tfret
from imageprocess_tpu_torch.pipelines import intensity as tint
from imageprocess_tpu_torch.utils import maybe_profile

P1 = np.array([[15, 15], [60, 18], [55, 70], [12, 66]], float)
P2 = np.array([[70, 40], [115, 45], [110, 85], [65, 80]], float)
P3 = np.array([[120.5, 100.5], [170.5, 104.5], [150.5, 140.5]], float)
# stage: (frame shape, ROIs); S04 of another shape, S05 without ROIs
PLAN = {1: ((160, 192), [P1, P2]), 2: ((160, 192), [P2]), 3: ((160, 192), [P1, P2, P3]),
        4: ((192, 224), [P3, P1]), 5: ((160, 192), None), 6: ((160, 192), [P1])}
STIDS = [f"S{s:02d}" for s in PLAN]
MAIN = {"plan", "load_wait", "classify", "pack", "upload", "fetch", "emit", "recycle",
        "serial", "xls"}
EXTRA = ["plan", "classify", "serial", "recycle", "ld_roi"]
COUNTERS = ["xls_cells_made", "xls_cells_reused", "xls_threaded_kb"]
# half the least share of a call's wall that its main-thread phases
# covered in 20 CPU runs of each runner (0.893)
MIN_COVER = 0.44

RUNNERS = {
    "intensity": (tint.run_intensity_batched, lambda: tint.IntensityConfig(channels=(1, 2)),
                  "ld_bg", "[IP_TIMING+]"),
    "fret": (tfret.run_fret_batched, lambda: tfret.FretConfig(donor_ch=1, acceptor_ch=2),
             "ld_scalars", "[IP_TIMING+:fret]"),
}


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    folder = tmp_path_factory.mktemp("traced")
    (folder / "roi").mkdir()
    rng = np.random.default_rng(0)
    for s, (shape, polys) in PLAN.items():
        tag = f"S{s:02d}"
        for ch in (1, 2):
            tiffio.write_tiff16(str(folder / f"{tag}_{ch}.TIF"),
                                rng.integers(10, 3000, shape).astype(np.uint16))
        if polys is not None:
            roiio.save_roi_bundle(str(folder / "roi" / f"{tag}.json"), tag, shape, polys)
    return folder


def _call(name, exp, out):
    run, cfg, *_ = RUNNERS[name]
    return run(str(exp), cfg(), out_root=str(out), log=lambda *_: None, batch_size=2,
               device="cpu")


def _all_threads():
    return profile(experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _ranges(prof):
    """(name, thread, start_us, end_us) of the runners' ranges."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(("phase:", "call:", "key:"))]


def _main(ranges):
    (call,) = [r for r in ranges if r[0].startswith("call:")]
    phases = sorted((a, b, n[len("phase:"):]) for n, th, a, b in ranges
                    if th == call[1] and n.startswith("phase:"))
    return call, phases


@pytest.mark.parametrize("path", ["fused", "gather"])
@pytest.mark.parametrize("name", list(RUNNERS))
def test_a_profiled_call_holds_every_phase_and_its_call_and_key_ranges(
        name, path, exp, tmp_path, monkeypatch):
    monkeypatch.delenv("IP_TIMING", raising=False)
    if path == "gather":
        monkeypatch.setattr(native, "decode_tiff_batch_hist_tiles", lambda *a, **k: None)
    with _all_threads() as prof:
        rows = _call(name, exp, tmp_path)
    assert rows
    ranges = _ranges(prof)
    call, phases = _main(ranges)
    assert call[0].startswith(f"call:{RUNNERS[name][0].__name__}#")
    assert {p for _, _, p in phases} == MAIN
    loader = {(n, th) for n, th, _, _ in ranges if th != call[1]}
    ld = {"ld_roi", "ld_decode", RUNNERS[name][2]} | ({"ld_gather"} if path == "gather" else set())
    assert {n for n, _ in loader if n.startswith("phase:")} == {"phase:" + p for p in ld}
    keys = sorted(n for n, _, _, _ in ranges if n.startswith("key:"))
    assert keys == ["key:" + s for s in STIDS]
    assert all(n.startswith(("phase:ld_", "key:")) for n, _ in loader)


@pytest.mark.parametrize("name", list(RUNNERS))
def test_main_thread_phases_are_disjoint_and_cover_the_call(name, exp, tmp_path, monkeypatch):
    monkeypatch.setenv("IP_TIMING", "1")
    _call(name, exp, tmp_path / "warm")     # first-call imports stay out of the reading
    with _all_threads() as prof:
        _call(name, exp, tmp_path / "traced")
    call, phases = _main(_ranges(prof))
    for (_, end, p), (start, _, q) in zip(phases, phases[1:]):
        assert start >= end, (p, q)
    covered = sum(b - a for a, b, _ in phases)
    assert covered >= MIN_COVER * (call[3] - call[2]), (covered, call)


@pytest.mark.parametrize("name", list(RUNNERS))
def test_rows_are_equal_with_tracing_off_timed_and_profiled(name, exp, tmp_path, monkeypatch):
    monkeypatch.delenv("IP_TIMING", raising=False)
    plain = _call(name, exp, tmp_path / "a")
    with _all_threads():
        profiled = _call(name, exp, tmp_path / "b")
    monkeypatch.setenv("IP_TIMING", "1")
    timed = _call(name, exp, tmp_path / "c")
    with profile():
        both = _call(name, exp, tmp_path / "d")
    assert plain == profiled == timed == both


@pytest.mark.parametrize("name", list(RUNNERS))
def test_ip_timing_plus_line_holds_the_new_phases(name, exp, tmp_path, monkeypatch, capfd):
    monkeypatch.setenv("IP_TIMING", "1")
    _call(name, exp, tmp_path)
    tag = RUNNERS[name][3]
    lines = [ln for ln in capfd.readouterr().err.splitlines() if ln.startswith(tag + " ")]
    assert len(lines) == 1
    pairs = [kv.split("=") for kv in lines[0][len(tag) + 1:].split("  ")]
    phases, counters = pairs[:len(EXTRA)], dict(pairs[len(EXTRA):])
    assert [k for k, _ in phases] == EXTRA
    assert all(v.endswith("ms") and v[:-2].isdigit() for _, v in phases)
    assert list(counters) == COUNTERS
    assert all(v.isdigit() for v in counters.values())
    # the per_ROI sheet makes each cell's text; the other sheets and the
    # CSV take most of theirs from it
    assert int(counters["xls_cells_reused"]) > int(counters["xls_cells_made"]) > 0


def test_without_a_switch_a_phase_is_a_null_context(monkeypatch, capfd):
    monkeypatch.delenv("IP_TIMING", raising=False)
    tm = timing.HostPhases(("load_wait",), extra=("plan",))
    assert isinstance(tm("plan"), contextlib.nullcontext)
    assert isinstance(tm.key(("S01", None)), contextlib.nullcontext)
    items = [1, 2]
    assert tm.iterate(items, "load_wait") is items
    with profile():
        traced = timing.HostPhases(("load_wait",), extra=("plan",))
        with traced("plan"):
            pass
        traced.report()                 # profiled without IP_TIMING: no sums, no line
    assert traced.profiled and traced.tm is None
    assert "IP_TIMING" not in capfd.readouterr().err


def test_call_range_numbers_each_call_of_a_runner():
    def runner(x, *, y=1):
        """doc"""
        return x + y

    wrapped = timing.call_range(runner)
    assert wrapped.__name__ == "runner" and wrapped.__doc__ == "doc"
    assert wrapped(1) == 2                  # not profiled: call 1, no range
    with profile() as prof:
        assert wrapped(1, y=2) == 3
        assert wrapped(2) == 3
    assert [e.name for e in prof.events() if e.name.startswith("call:")] == [
        "call:runner#2", "call:runner#3"]


def test_xprof_trace_holds_the_loader_threads_ranges(exp, tmp_path, monkeypatch):
    """``maybe_profile`` (the CLI's ``--xprof``) records every thread: the
    trace holds the call, its phases, and every key's load."""
    monkeypatch.delenv("IP_TIMING", raising=False)
    with maybe_profile(str(tmp_path / "trace"), "cpu"):
        _call("intensity", exp, tmp_path / "out")
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "trace") for f in fs
               if f.endswith(".pt.trace.json")]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("call:run_intensity_batched#") for n in names)
    assert {"key:" + s for s in STIDS} <= names
    assert {"phase:" + p for p in MAIN | {"ld_decode", "ld_roi"}} <= names
