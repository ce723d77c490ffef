"""Per-phase times and counters of one call, for instrumentation.

``PhaseTimer(device).phase(name)`` brackets a phase with CUDA events on a
CUDA device (read after one synchronize in ``times_ms``) or with the host
clock on the CPU; ``count(name, n)`` adds to a counter named after the
innermost open phase.  Functions on the segmentation path take
``timer=NO_TIMER``, whose phases and counters cost nothing.

``HostPhases`` is the batched tables runners' ``IP_TIMING=1`` line: host
wall time per phase, printed to stderr at the end of the run in the JAX
runners' format.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Dict

import torch


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


class HostPhases:
    """Host wall seconds per phase of one batched runner call, on only when
    the ``IP_TIMING`` environment variable is set (else every call is a
    no-op).  ``report()`` prints ``{tag} k=Nms  k=Nms ...`` to stderr, the
    keys in the order given.  Phases may be added from the prefetch
    threads: theirs (``ld_*``) sum over threads."""

    def __init__(self, keys, tag: str = "[IP_TIMING]"):
        self.tm = dict.fromkeys(keys, 0.0) if os.environ.get("IP_TIMING") else None
        self.tag = tag
        self._lock = threading.Lock()

    def __call__(self, phase: str):
        """A context manager timing its block into *phase*."""
        if self.tm is None:
            return contextlib.nullcontext()
        return self._span(phase)

    @contextlib.contextmanager
    def _span(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.tm[phase] += time.perf_counter() - t0

    def iterate(self, items, phase: str):
        """*items*, each ``next`` timed into *phase* (a loader's wait)."""
        if self.tm is None:
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

    def report(self) -> None:
        if self.tm is not None:
            print(f"{self.tag} " + "  ".join(
                f"{k}={v * 1000.0:.0f}ms" for k, v in self.tm.items()),
                file=sys.stderr)
