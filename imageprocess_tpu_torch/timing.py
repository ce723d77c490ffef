"""Per-phase times and counters of one call, for instrumentation.

``PhaseTimer(device).phase(name)`` brackets a phase with CUDA events on a
CUDA device (read after one synchronize in ``times_ms``) or with the host
clock on the CPU; ``count(name, n)`` adds to a counter named after the
innermost open phase.  Functions on the segmentation path take
``timer=NO_TIMER``, whose phases and counters cost nothing.
"""

from __future__ import annotations

import contextlib
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
