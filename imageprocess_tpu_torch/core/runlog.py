"""Run logs and progress with an ETA (port of
``imageprocess_tpu/core/runlog.py``).

``RunLogger`` appends to ``RES/logs/run_YYYYMMDD_HHMMSS.txt`` with
``[START]``/``[END]`` stamps and mirrors every line to the console;
``Progress`` reports ROI-weighted progress with a moving-average ETA.
"""

from __future__ import annotations

import os
import threading
import time
from datetime import datetime
from typing import Callable, Optional

ETA_WINDOW = 8  # ticks in the ETA's moving average


class RunLogger:
    """Console + append-only file logger with [START]/[END] stamps."""

    def __init__(self, log_dir: Optional[str] = None, echo: Callable = print):
        self._echo = echo
        self._lock = threading.Lock()
        self._path: Optional[str] = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            ts = datetime.now().strftime("%Y%m%d_%H%M%S")
            self._path = os.path.join(log_dir, f"run_{ts}.txt")
            self._write(f"[START] {datetime.now().strftime('%H:%M:%S')}")

    @property
    def path(self) -> Optional[str]:
        return self._path

    def _write(self, line: str) -> None:
        if self._path is None:
            return
        with self._lock:
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(line + "\n")

    def __call__(self, *args) -> None:
        msg = " ".join(str(a) for a in args)
        self._echo(msg)
        self._write(msg)

    def close(self) -> None:
        self._write(f"[END] {datetime.now().strftime('%H:%M:%S')}")


class Progress:
    """Determinate progress with a moving-average ETA over weighted units
    (the caller steps by the ROIs a key produced)."""

    def __init__(self, total: int, log: Callable = print):
        self.total = max(1, int(total))
        self.done = 0
        self._log = log
        self._times = [time.time()]
        self._units = [0]  # cumulative weighted units at each tick

    def step(self, n: int = 1, label: str = "") -> None:
        self.done += n
        now = time.time()
        self._times.append(now)
        self._units.append(self.done)
        if len(self._times) > ETA_WINDOW + 1:
            self._times.pop(0)
            self._units.pop(0)
        span = self._times[-1] - self._times[0]
        units = self._units[-1] - self._units[0]
        rate = units / span if span > 0 else 0.0
        remain = (self.total - self.done) / rate if rate > 0 else 0.0
        mm, ss = divmod(int(remain), 60)
        pct = 100.0 * self.done / self.total
        suffix = f" {label}" if label else ""
        self._log(f"[{pct:5.1f}%] {self.done}/{self.total} "
                  f"ETA {mm:02d}:{ss:02d}{suffix}")
