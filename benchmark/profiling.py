"""The traced run: a fixed count of whole calls under ``torch.profiler``,
with the program's host phases (``timing.HostPhases``) recorded as ranges
on the same timeline.

What it returns is what the per-layer metric readers read: the traced
wall, the device's kernel and copy intervals, the phase sums, the busy
union, and the longest idle gaps labelled by the host phase open in them.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

WINDOW = "benchmark:traced_calls"
PHASE = "phase:"
NAME_CHARS = 120   # kernel names in the breakdown (C++ templates run to thousands)
TOP = 10           # entries of each breakdown list


def union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_gaps(spans, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@contextlib.contextmanager
def host_phases(sums: dict):
    """Turn the program's ``IP_TIMING`` phases on and record each phase as a
    profiler range and into *sums* (seconds per phase)."""
    from torch.profiler import record_function

    from imageprocess_tpu_torch import timing

    orig = getattr(getattr(timing, "HostPhases", None), "_span", None)
    if orig is None:
        raise RuntimeError("imageprocess_tpu_torch.timing.HostPhases._span is gone: the "
                           "host-phase metrics cannot be read")
    lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, phase):
        t0 = time.perf_counter()
        try:
            with record_function(PHASE + phase), orig(self, phase):
                yield
        finally:
            with lock:
                sums[phase] += time.perf_counter() - t0

    old = os.environ.get("IP_TIMING")
    os.environ["IP_TIMING"] = "1"
    timing.HostPhases._span = span
    try:
        yield
    finally:
        timing.HostPhases._span = orig
        if old is None:
            os.environ.pop("IP_TIMING", None)
        else:
            os.environ["IP_TIMING"] = old


def _label(gap, phases) -> str:
    best, name = 0.0, "host outside any phase"
    for ph, a, b in phases:
        ov = min(b, gap[1]) - max(a, gap[0])
        if ov > best:
            best, name = ov, ph
    return name


def trace_calls(call, n: int, cuda: bool = True) -> dict:
    """*n* calls of *call* under the profiler (the device's activity too
    when *cuda*).  Returns ``results`` (each
    call's return value, or the exception it raised), ``walls_s``,
    ``kernels`` and ``copies`` ((name, start_us, end_us) on
    the device), ``traced_s`` (their wall), ``phase_s`` (host phase sums),
    ``busy_s``, ``device_ops``
    and ``idle_gaps`` (the TOP longest, labelled)."""
    import io

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sums = defaultdict(float)
    results, walls = [], []
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    # the runners' [IP_TIMING] lines go nowhere: the sums above replace them
    with contextlib.redirect_stderr(io.StringIO()), host_phases(sums), \
            profile(activities=activities) as prof:
        t_start = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(n):
                t0 = time.perf_counter()
                try:
                    results.append(call())
                except Exception as e:  # noqa: BLE001 -- a failed call is counted
                    results.append(e)
                sync()
                walls.append(time.perf_counter() - t0)
        window_s = time.perf_counter() - t_start
    kernels, copies, phases, win = [], [], [], None
    main = None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append((e.name, a, b))
        elif e.name == WINDOW:
            win, main = (a, b), e.thread
        elif e.name.startswith(PHASE):
            phases.append((e.name[len(PHASE):], a, b, e.thread))
    spans = [(a, b) for _, a, b in kernels + copies]
    busy_us = union(spans)
    by_name = defaultdict(float)
    for name, a, b in kernels + copies:
        by_name[name[:NAME_CHARS]] += (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    if win is not None:
        main_phases = [(p, a, b) for p, a, b, th in phases if th == main]
        gaps = sorted(idle_gaps(spans, *win), key=lambda g: g[0] - g[1])[:TOP]
        gaps = [[_label(g, main_phases), (g[1] - g[0]) / 1e6] for g in gaps]
    return {"results": results, "walls_s": walls, "traced_s": window_s,
            "kernels": kernels, "copies": copies, "phase_s": dict(sums),
            "busy_s": busy_us / 1e6, "device_ops": [[n_, s] for n_, s in ops],
            "idle_gaps": gaps}
