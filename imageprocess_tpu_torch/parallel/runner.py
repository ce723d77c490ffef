"""Batched execution on one device, and the host streaming protocol.

Port of ``imageprocess_tpu/parallel/runner.py``: ``batched_tile_stats_step``
(the minimum-transfer intensity step), its FRET counterpart
``batched_fret_tile_stats_step`` and the pure-Python protocol shared
by the batched runners — ``stream_batches``, ``PrefetchLoader``,
``make_autoscaler``, ``LoadError`` and ``EmitFetchError`` — unchanged.
Mesh and sharding code wait for the multi-device slice.
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque
from typing import Callable, Iterator, List, Sequence

import torch

from ..ops.roi_stats_kernel import (
    fret_tile_stats_packed, fret_tile_stats_packed_plain,
)
from ..ops.tile_stats_kernel import tile_stats_packed, tile_stats_packed_plain


def batched_tile_stats_step(
    tiles: torch.Tensor,        # (B, N, C, t, t) raw u16 tile pixels
    local_polys: torch.Tensor,  # (B, N, V, 2) float32 tile-local
    roi_valid: torch.Tensor,    # (B, N) bool
    bgs: torch.Tensor,          # (B, C) float32 host-computed backgrounds
    *,
    clip_neg: bool = True,
) -> torch.Tensor:
    """Whole-batch minimum-transfer intensity step: the host gathers ROI
    tiles and computes the (scalar) backgrounds, the device rasterizes and
    quantifies.  Returns the packed (B, 10, C, N) float32 result (the nine
    ``STAT_FIELDS`` rows, then the area) that the JAX runner's ``_pack``
    builds from this step's (stats, area).

    CUDA tensors launch the hand kernel (``tile_stats_packed``, which
    raises rather than fall back); CPU tensors take its plain version."""
    if tiles.device.type == "cpu":
        return tile_stats_packed_plain(tiles, local_polys, roi_valid, bgs,
                                       clip_neg=clip_neg)
    return tile_stats_packed(tiles, local_polys, roi_valid, bgs,
                             clip_neg=clip_neg)


def batched_fret_tile_stats_step(
    tiles: torch.Tensor,        # (B, N, 2, t, t) raw u16 [donor, acceptor]
    local_polys: torch.Tensor,  # (B, N, V, 2) float32 tile-local
    roi_valid: torch.Tensor,    # (B, N) bool
    bgs: torch.Tensor,          # (B, 2) float32 host backgrounds
    eps: torch.Tensor,          # (B,) float32 host epsilons
    *,
    clip_neg: bool = True,
    flip: bool = False,
) -> torch.Tensor:
    """Whole-batch minimum-transfer FRET step (the device part of the JAX
    ``batched_fret_tile_stats`` plus the runner's packing): rasterize, form
    [ratio, donor, acceptor] per tile, quantify.  Returns the packed
    (B, 10, 3, N) float32 result (the nine ``STAT_FIELDS`` rows, then the
    area).

    CUDA tensors launch the hand kernel (``fret_tile_stats_packed``, which
    raises rather than fall back); CPU tensors take its plain version."""
    if tiles.device.type == "cpu":
        return fret_tile_stats_packed_plain(tiles, local_polys, roi_valid, bgs,
                                            eps, clip_neg=clip_neg, flip=flip)
    return fret_tile_stats_packed(tiles, local_polys, roi_valid, bgs, eps,
                                  clip_neg=clip_neg, flip=flip)


def make_autoscaler(loader, batch_size: int, cap: int = 32):
    """Chunk-size auto-scaling shared by the batched runners: a
    (current_size, maybe_grow) pair.  maybe_grow doubles the size (up to
    *cap*) whenever the loader's decoded-and-waiting queue outruns 1.5x the
    current size; on a decode-bound host the queue never fills and the
    size never moves."""
    state = {"bs": batch_size}

    def current() -> int:
        return state["bs"]

    def maybe_grow() -> None:
        bs = state["bs"]
        if bs * 2 <= cap and loader.ready >= (3 * bs) // 2:
            state["bs"] = bs * 2

    return current, maybe_grow


class LoadError:
    """Sentinel yielded by PrefetchLoader when an item's load_fn raised:
    carries the item and the exception so callers can log-and-skip."""

    def __init__(self, item, error):
        self.item = item
        self.error = error


class EmitFetchError(Exception):
    """Raised by an emit() callback when the device->host result fetch
    failed BEFORE any side effect ran (row append, buffer recycle, file
    write).  This is the only emit failure :func:`stream_batches` recovers
    by re-running the chunk's keys through the serial path — recovering
    after a partial emit would duplicate report rows and double-put
    recycled decode buffers into the FrameBufferPool."""


def stream_batches(loader, batch_size: int, classify, dispatch, emit,
                   serial, on_error, cancel=None, in_flight: int = 2) -> bool:
    """The batches-in-flight streaming protocol: consume a PrefetchLoader,
    keep up to *in_flight* dispatched batches pending so host decode of
    chunk k+1 overlaps device compute of chunk k, and preserve key order
    across serial fallbacks (buffered entries flush, then every in-flight
    batch drains, before a serial key's rows are emitted).  Results are
    emitted strictly in dispatch order.

    - batch_size: target chunk length — an int, or a zero-arg callable
      re-read before each chunk boundary (chunk-size auto-scaling)
    - classify(item) -> ("batch", entry) | ("serial", entry) | ("skip", _)
    - dispatch(entries) -> opaque record, or None when the chunk can't take
      the batch program (its entries are then serialized in order)
    - emit(record): fetch + emit a dispatched batch's rows
    - serial(entry): per-key fallback
    - on_error(LoadError): log-and-skip
    - cancel: optional zero-arg callable checked between items.  On cancel
      the dispatched chunks drain (their rows are kept) but buffered,
      never-dispatched entries are DROPPED.  Returns True if cancelled.

    Fault isolation: a dispatch failure, or an emit failure raised as
    :class:`EmitFetchError`, degrades that chunk to the per-key serial
    path; a key whose serial fallback also fails is logged through
    on_error and skipped.  Any OTHER emit exception means rows/buffers may
    already be partially emitted, so the chunk is NOT re-run; its keys are
    logged through on_error instead.
    """
    size = batch_size if callable(batch_size) else (lambda: batch_size)
    buf = []
    pending = deque()  # (opaque dispatch record, its entries) FIFO

    def serial_safe(entry):
        try:
            serial(entry)
        except Exception as e:  # noqa: BLE001 — log-and-skip per key
            on_error(LoadError(entry, e))

    def drain_one():
        rec, entries = pending.popleft()
        try:
            emit(rec)
        except EmitFetchError:  # result fetch failed pre-emit: redo
            for e in entries:   # the chunk per key
                serial_safe(e)
        except Exception as exc:  # noqa: BLE001 — emit partially ran
            for e in entries:
                on_error(LoadError(e, exc))

    def drain_all():
        while pending:
            drain_one()

    def flush():
        if not buf:
            return
        entries = list(buf)  # copy: buf.clear() must not empty the
        buf.clear()          # chunk held by an in-flight record
        cap = max(1, in_flight)
        if cap > 1:
            # at capacity, drain the oldest BEFORE dispatching: peak memory
            # stays at `cap` chunks of live entries
            while len(pending) >= cap:
                drain_one()
        try:
            rec = dispatch(entries)
        except Exception:  # noqa: BLE001 — dispatch failed: go serial
            drain_all()
            for e in entries:
                serial_safe(e)
            return
        if rec is None:
            drain_all()  # order: earlier chunks' rows before these keys'
            for e in entries:
                serial_safe(e)
        else:
            pending.append((rec, entries))
            if cap == 1:
                while len(pending) > 1:
                    drain_one()

    cancelled = False
    for item in loader:
        if cancel is not None and cancel():
            cancelled = True
            break
        if isinstance(item, LoadError):
            on_error(item)
            continue
        kind, entry = classify(item)
        if kind == "skip":
            continue
        if kind == "serial":
            flush()
            drain_all()
            serial_safe(entry)
            continue
        buf.append(entry)
        if len(buf) >= size():
            flush()
    if cancelled:
        buf.clear()
    else:
        flush()
    drain_all()
    return cancelled


class PrefetchLoader:
    """Decode-ahead host loader: maps *load_fn* over work items with a
    thread pool, yielding results in order while later decodes overlap
    device compute.  Items whose load raises yield a ``LoadError`` instead
    of aborting the iteration."""

    def __init__(self, load_fn: Callable, items: Sequence, workers: int = 8,
                 ahead: int = 16):
        self._load = load_fn
        self._items = list(items)
        self._workers = workers
        self._ahead = ahead
        #: decoded-and-waiting item count as of the last yield — the
        #: backpressure signal for chunk-size auto-scaling
        self.ready = 0

    def __iter__(self) -> Iterator:
        pool = cf.ThreadPoolExecutor(self._workers)
        try:
            futures: List[cf.Future] = []
            it = iter(self._items)
            for _ in range(self._ahead):
                try:
                    futures.append(pool.submit(self._load, next(it)))
                except StopIteration:
                    break
            idx = 0
            while futures:
                fut = futures.pop(0)
                try:
                    futures.append(pool.submit(self._load, next(it)))
                except StopIteration:
                    pass
                self.ready = sum(f.done() for f in futures)
                try:
                    yield fut.result()
                except Exception as e:  # noqa: BLE001 - surfaced to caller
                    yield LoadError(self._items[idx], e)
                idx += 1
        finally:
            # abandoned mid-iteration (the cancel path): drop the queued
            # decodes instead of blocking on them
            pool.shutdown(wait=False, cancel_futures=True)
