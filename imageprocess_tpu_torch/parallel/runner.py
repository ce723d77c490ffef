"""Batched and sharded execution, and the host streaming protocol.

Port of ``imageprocess_tpu/parallel/runner.py``: the mesh (``Mesh``,
``make_mesh``, ``round_batch_to_mesh``), the batched steps
(``batched_intensity_step(_tiled)``, the minimum-transfer
``batched_tile_stats_step`` and its FRET counterpart
``batched_fret_tile_stats_step``), their sharded forms and the
pure-Python protocol shared by the batched runners — ``stream_batches``,
``PrefetchLoader``, ``make_autoscaler``, ``LoadError`` and
``EmitFetchError`` — unchanged.

One process drives the mesh, as one JAX controller drives its devices.
A mesh is a tuple of ``torch.device`` and an axis name.  A sharded step
splits the batch axis into equal, contiguous blocks, one per device, as
``P(axis)`` lays them out, and runs the single-device step on each block
on its own device (:func:`dispatch_shards`): every shard's step of a chunk
is enqueued before any result is fetched, so the cards of a mesh work at
the same time, and each block comes back to the host straight from its
own device (:func:`fetch_shards`), in batch order.  A *virtual* mesh
repeats one device, ``Mesh((dev,) * n)``: the counterpart of JAX's
virtual CPU devices, it runs every sharded path on one card or the CPU.
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..ops.roi_stats_kernel import (
    fret_tile_stats_packed, fret_tile_stats_packed_plain,
)
from ..ops.tile_stats_kernel import tile_stats_packed, tile_stats_packed_plain


class Mesh:
    """A 1-D device mesh: *devices* in shard order and the axis' name,
    with JAX's ``shape`` and ``axis_names`` for the callers that read
    them.  A device may repeat (a virtual mesh)."""

    def __init__(self, devices, axis_name: str = "batch"):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None and torch.cuda.is_available():
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)
        self.axis_name = axis_name

    @property
    def axis_names(self):
        return (self.axis_name,)

    @property
    def shape(self):
        return {self.axis_name: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              device="cuda") -> Mesh:
    """1-D mesh over the first *n_devices* (default: all) devices of
    *device*'s kind; the CPU is one device.  Raises ``ValueError`` when
    fewer are present: it never builds a smaller mesh and never falls back
    to the CPU."""
    from ..device import resolve_device

    kind = resolve_device(torch.device(device).type).type
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if kind == "cuda" else [torch.device("cpu")])
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devs):
        raise ValueError(
            f"make_mesh: {n} {kind} devices requested but {len(devs)} present")
    return Mesh(devs[:n], axis)


def round_batch_to_mesh(batch_size: int, mesh) -> int:
    """Round a runner's chunk size so every mesh-sharded dispatch divides
    evenly over the mesh's devices (short trailing chunks pad with
    valid=False lanes instead).  No-op for single-device runs."""
    if mesh is None:
        return batch_size
    n_dev = len(mesh.devices)
    batch_size = max(batch_size, n_dev)
    return batch_size - batch_size % n_dev


def shard_bounds(mesh: Mesh, batch: int):
    """[(lo, hi)] of each shard's contiguous block of a *batch*-long axis."""
    n = len(mesh.devices)
    if batch % n:
        raise ValueError(f"a batch of {batch} does not divide over the {n} "
                         "shards of the mesh")
    b = batch // n
    return [(i * b, (i + 1) * b) for i in range(n)]


def side_streams(mesh: Mesh) -> dict:
    """One side stream per distinct CUDA device of *mesh*."""
    return {d: torch.cuda.Stream(d) for d in mesh.devices if d.type == "cuda"}


def _tree_map(fn, x):
    """*fn* over the tensors of a tensor, a dict or a tuple/list of them."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return type(x)(_tree_map(fn, v) for v in x)


def _tree_cat(blocks):
    """Concatenate the shards' host trees along the batch axis."""
    first = blocks[0]
    if len(blocks) == 1:
        return first
    if isinstance(first, torch.Tensor):
        return torch.cat(blocks)
    if isinstance(first, dict):
        return {k: _tree_cat([b[k] for b in blocks]) for k in first}
    return type(first)(_tree_cat([b[i] for b in blocks])
                       for i in range(len(first)))


def to_shard(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on *dev*: non-blocking onto a
    card (stream-ordered; asynchronous from page-locked memory), blocking
    onto the host; u16 travels as int16 storage."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device == dev:
        return x
    u16 = x.dtype == torch.uint16
    out = (x.view(torch.int16) if u16 else x).to(dev, non_blocking=dev.type == "cuda")
    return out.view(torch.uint16) if u16 else out


def dispatch_shards(mesh: Mesh, run_block: Callable, batch: int, *,
                    staging=None, streams: Optional[dict] = None) -> list:
    """Enqueue every shard's step of one chunk, fetching nothing.

    ``run_block(dev, lo, hi)`` moves lanes ``lo:hi`` of the chunk to
    *dev* and returns the step's output there (a tensor, or a dict or
    tuple of them); it runs with *dev* current and, on a card, on the
    device's side stream from *streams* (default: its current stream).
    Each shard's output starts its copy to the host at once, into
    page-locked buffers (of the *staging* pool when given), and a CUDA
    event marks it done.  Returns ``[(host tree, event or None)]`` in
    shard order, for :func:`fetch_shards`."""
    parts = []
    for dev, (lo, hi) in zip(mesh.devices, shard_bounds(mesh, batch)):
        if dev.type != "cuda":
            parts.append((run_block(dev, lo, hi), None))
            continue
        stream = (streams or {}).get(dev) or torch.cuda.current_stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = run_block(dev, lo, hi)

            def to_host(x):
                host = (staging.get(tuple(x.shape), x.dtype) if staging is not None
                        else torch.empty(x.shape, dtype=x.dtype, pin_memory=True))
                host.copy_(x, non_blocking=True)
                return host

            host = _tree_map(to_host, out)
            done = torch.cuda.Event()
            done.record(stream)
        parts.append((host, done))
    return parts


def fetch_block(host, done):
    """One shard's host tree, once its copy has landed."""
    if done is not None:
        done.synchronize()
    return host


def fetch_shards(parts):
    """The shards' results of :func:`dispatch_shards` on the host, in
    batch order: each block read straight from its own device's copy."""
    return _tree_cat([fetch_block(host, done) for host, done in parts])


def run_sharded(mesh: Mesh, step: Callable, *args, **kwargs):
    """``step(*blocks, **kwargs)`` on each shard's block of every argument
    (numpy arrays or tensors, split along the batch axis and moved to the
    shard's device), all shards enqueued before any is fetched; the
    results on the host, in batch order."""
    def block(dev, lo, hi):
        return step(*(to_shard(a[lo:hi], dev) for a in args), **kwargs)

    return fetch_shards(dispatch_shards(mesh, block, len(args[0])))


def batched_intensity_step(
    imgs,                    # (B, C, H, W) raw u8 / u16 / float
    polys,                   # (B, N, V, 2) float32
    roi_valid,               # (B, N) bool
    p1000s,                  # (B, C) int
    *,
    bg_mode: str = "percentile",
    bg_scope: str = "full",
    clip_neg: bool = True,
    bg_stride: int = 4,
):
    """The whole batch through ``pipelines.intensity.intensity_step``
    (the production program, frame by frame, where JAX vmaps it): (stats
    {field: (B, C, N)}, area (B, N), bgs (B, C))."""
    from ..pipelines.intensity import intensity_step

    outs = [intensity_step(imgs[b], polys[b], roi_valid[b],
                           [int(p) for p in p1000s[b]], bg_mode=bg_mode,
                           bg_scope=bg_scope, clip_neg=clip_neg,
                           bg_stride=bg_stride)[:3]
            for b in range(len(imgs))]
    return _stack_outputs(outs)


def _stack_outputs(outs):
    """[(stats, area, bgs)] per frame -> the batch's (stats, area, bgs)."""
    stats = {f: torch.stack([o[0][f] for o in outs]) for f in outs[0][0]}
    return (stats, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def sharded_intensity_step(mesh: Mesh, *, bg_mode: str = "percentile",
                           bg_scope: str = "full", clip_neg: bool = True,
                           bg_stride: int = 4) -> Callable:
    """:func:`batched_intensity_step` with its batch axis split over
    *mesh* (batch size a multiple of the mesh size); the results on the
    host."""
    def run(imgs, polys, roi_valid, p1000s):
        return run_sharded(mesh, batched_intensity_step, imgs, polys, roi_valid,
                           p1000s, bg_mode=bg_mode, bg_scope=bg_scope,
                           clip_neg=clip_neg, bg_stride=bg_stride)

    return run


def batched_intensity_step_tiled(
    imgs,                    # (B, C, H, W) raw u16 / f32
    local_polys,             # (B, N, V, 2) tile-local
    offsets,                 # (B, N, 2)
    roi_valid,               # (B, N)
    p1000s,                  # (B, C)
    *,
    tile: int,
    bg_mode: str = "percentile",
    clip_neg: bool = True,
    bg_stride: int = 4,
):
    """The whole batch through ``pipelines.intensity.intensity_step_tiled``,
    frame by frame: (stats {field: (B, C, N)}, area (B, N), bgs (B, C))."""
    from ..pipelines.intensity import intensity_step_tiled

    outs = [intensity_step_tiled(imgs[b], local_polys[b], offsets[b],
                                 roi_valid[b], [int(p) for p in p1000s[b]],
                                 tile=tile, bg_mode=bg_mode, clip_neg=clip_neg,
                                 bg_stride=bg_stride)[:3]
            for b in range(len(imgs))]
    return _stack_outputs(outs)


def sharded_batched_intensity_tiled(mesh: Mesh, *, tile: int,
                                    bg_mode="percentile", clip_neg=True,
                                    bg_stride=4) -> Callable:
    """:func:`batched_intensity_step_tiled` with its batch axis split over
    *mesh* (batch size a multiple of the mesh size)."""
    def run(imgs, local_polys, offsets, roi_valid, p1000s):
        return run_sharded(mesh, batched_intensity_step_tiled, imgs, local_polys,
                           offsets, roi_valid, p1000s, tile=tile, bg_mode=bg_mode,
                           clip_neg=clip_neg, bg_stride=bg_stride)

    return run


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


def sharded_batched_tile_stats(mesh: Mesh, *, clip_neg=True) -> Callable:
    """:func:`batched_tile_stats_step` with the batch axis split over
    *mesh*: one kernel launch per shard, on the shard's device; the packed
    (B, 10, C, N) result on the host."""
    def run(tiles, local_polys, roi_valid, bgs):
        return run_sharded(mesh, batched_tile_stats_step, tiles, local_polys,
                           roi_valid, bgs, clip_neg=clip_neg)

    return run


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
