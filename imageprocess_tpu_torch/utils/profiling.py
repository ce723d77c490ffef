"""Profiling hook: ``torch.profiler`` traces.

Pass ``--xprof DIR`` to any command of the port's CLI (or use
:func:`maybe_profile`) to capture a TensorBoard-loadable trace of the run:
the host's operators always, the card's kernels and copies when the run's
device is a card.
"""

from __future__ import annotations

import contextlib
from typing import Optional


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], device=None):
    """``torch.profiler.profile`` over the block when *trace_dir* is given,
    else a no-op.  CPU activity is recorded always, CUDA activity when
    *device* is a card; on exit the trace lands in *trace_dir* as
    ``<host>_<pid>.<ns>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield

