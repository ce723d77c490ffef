"""Per-phase times and counters of one call, for instrumentation.

``PhaseTimer(device).phase(name)`` brackets a phase with CUDA events on a
CUDA device (read after one synchronize in ``times_ms``) or with the host
clock on the CPU; ``count(name, n)`` adds to a counter named after the
innermost open phase.  Functions on the segmentation path take
``timer=NO_TIMER``, whose phases and counters cost nothing.

``HostPhases`` is the batched tables runners' host phases: their sums
and the ``IP_TIMING=1`` lines, and their ranges on the profiler's clock
whenever a ``torch.profiler`` records.  ``call_range`` names each call of
a runner on that clock.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import sys
import threading
import time
from typing import Dict

import torch
import torch.autograd.profiler as _profiler


class PhaseTimer:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []          # (name, start mark, end mark), in order
        self.counts: Dict[str, int] = {}
        self._open = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = self._mark()
        self._open.append(name)
        try:
            yield
        finally:
            self._open.pop()
            self.spans.append((name, start, self._mark()))

    def count(self, name: str, n: int = 1) -> None:
        key = f"{self._open[-1]}.{name}" if self._open else name
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def times_ms(self) -> Dict[str, float]:
        """Milliseconds per phase name (summed over repeats)."""
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, s, e in self.spans:
            ms = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


class _NoTimer:
    def phase(self, name: str):
        return contextlib.nullcontext()

    def count(self, name: str, n: int = 1) -> None:
        pass


NO_TIMER = _NoTimer()


def call_range(runner):
    """*runner*, each call of it inside a ``call:<name>#<n>`` profiler range
    while a ``torch.profiler`` records (*n* counts the runner's calls in
    the process), so that a trace tells its calls apart."""
    calls = itertools.count(1)

    @functools.wraps(runner)
    def call(*args, **kwargs):
        n = next(calls)
        if not _profiler._is_profiler_enabled:
            return runner(*args, **kwargs)
        with _profiler.record_function(f"call:{runner.__name__}#{n}"):
            return runner(*args, **kwargs)

    return call


class HostPhases:
    """Host phases of one batched runner call.

    Phases named ``ld_*`` run on the prefetch loader's threads and sum over
    them; together they are the whole load of a key.  Every other phase
    runs on the runner's main thread, and those never nest or overlap:
    together they cover the call.

    Two switches, each read once, when the runner builds its
    ``HostPhases``: the ``IP_TIMING`` environment variable sums each phase's
    host wall seconds, which ``report()`` prints to stderr; a recording
    ``torch.profiler`` makes each phase a ``phase:<name>`` range and
    ``key()`` a ``key:<stid>`` range, on the clock the device's activity
    is stamped with.  With neither on, a phase is a ``nullcontext``.

    ``report()`` prints ``{tag} k=Nms  k=Nms ...``, the JAX runners' line,
    with *keys* in the order given, then the *extra* phases and the
    *counters* (``k=N``, summed by ``count``) on a second line tagged
    ``IP_TIMING+``."""

    def __init__(self, keys, tag: str = "[IP_TIMING]", extra=(), counters=()):
        self.keys, self.extra = tuple(keys), tuple(extra)
        self.tm = (dict.fromkeys(self.keys + self.extra, 0.0)
                   if os.environ.get("IP_TIMING") else None)
        self.counts = dict.fromkeys(counters, 0)
        self.profiled = _profiler._is_profiler_enabled
        self.tag = tag
        self._lock = threading.Lock()

    def __call__(self, phase: str):
        """A context manager timing its block into *phase*."""
        if self.tm is None and not self.profiled:
            return contextlib.nullcontext()
        return self._span(phase)

    @contextlib.contextmanager
    def _span(self, phase: str):
        rng = (_profiler.record_function("phase:" + phase) if self.profiled
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rng:
                yield
        finally:
            if self.tm is not None:
                with self._lock:
                    self.tm[phase] += time.perf_counter() - t0

    def key(self, key):
        """A ``key:<stid>`` profiler range around the load of the
        ``(stage, time)`` *key* while profiled (not a phase: no sum)."""
        if not self.profiled:
            return contextlib.nullcontext()
        s, t_code = key
        return _profiler.record_function(f"key:{s}" if t_code is None else f"key:{s}_{t_code}")

    def iterate(self, items, phase: str):
        """*items*, each ``next`` timed into *phase* (a loader's wait)."""
        if self.tm is None and not self.profiled:
            return items
        return self._timed(items, phase)

    def _timed(self, items, phase):
        it = iter(items)
        while True:
            with self._span(phase):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def count(self, counts: Dict[str, int]) -> None:
        """Add *counts* to the counters of the same names."""
        for k, n in counts.items():
            self.counts[k] += n

    def report(self) -> None:
        if self.tm is None:
            return
        def ms(keys):
            return [f"{k}={self.tm[k] * 1000.0:.0f}ms" for k in keys]

        extra_tag = self.tag.replace("IP_TIMING", "IP_TIMING+", 1)
        counts = [f"{k}={n}" for k, n in self.counts.items()]
        for tag, items in ((self.tag, ms(self.keys)), (extra_tag, ms(self.extra) + counts)):
            if items:
                print(f"{tag} " + "  ".join(items), file=sys.stderr)
