"""Port: the pure-Python streaming protocol (parallel.runner) keeps the
JAX package's behaviour — the protocol tests of test_batched_runner.py,
run against the port's stream_batches / PrefetchLoader — and the batched
tile step on CPU tensors takes the plain version."""

import threading
import time

import numpy as np
import torch

from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
from imageprocess_tpu_torch.parallel.runner import (
    EmitFetchError, PrefetchLoader, batched_tile_stats_step, make_autoscaler,
    stream_batches,
)


def test_stream_batches_callable_size():
    """stream_batches re-reads a callable batch size at chunk boundaries."""
    sizes = {"bs": 2}
    chunks, emitted = [], []
    stream_batches(
        list(range(10)), lambda: sizes["bs"],
        classify=lambda x: ("batch", x),
        dispatch=lambda c: (chunks.append(list(c)), c)[1],
        emit=lambda rec: (emitted.extend(rec),
                          sizes.__setitem__("bs", sizes["bs"] * 2)),
        serial=lambda e: emitted.append(e),
        on_error=lambda e: None,
    )
    assert emitted == list(range(10))
    assert chunks[0] == [0, 1]
    assert len(chunks[1]) >= 2
    assert max(len(c) for c in chunks) > 2


def test_stream_batches_two_in_flight_ordered():
    """At most TWO dispatched chunks pending, emitted strictly in dispatch
    order, every pending chunk drained before a serial key."""
    events = []
    outstanding = {"now": 0, "max": 0}

    def dispatch(entries):
        outstanding["now"] += 1
        outstanding["max"] = max(outstanding["max"], outstanding["now"])
        events.append(("d", list(entries)))
        return list(entries)

    def emit(rec):
        outstanding["now"] -= 1
        events.append(("e", rec))

    items = list(range(8)) + [99] + list(range(8, 12))
    stream_batches(
        items, 2,
        classify=lambda x: ("serial", x) if x == 99 else ("batch", x),
        dispatch=dispatch, emit=emit,
        serial=lambda e: events.append(("s", e)),
        on_error=lambda e: None,
    )
    assert outstanding["now"] == 0
    assert outstanding["max"] == 2
    emitted = [rec for kind, rec in events if kind == "e"]
    assert emitted == [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11]]
    s_at = events.index(("s", 99))
    assert [k for k, _ in events[:s_at]].count("e") == 4


def test_prefetch_loader_abandons_queued_work_on_early_exit():
    """Breaking out of iteration must not block on — or execute — the
    queued decodes."""
    started = []
    lock = threading.Lock()

    def load(i):
        with lock:
            started.append(i)
        time.sleep(0.05)
        return i

    loader = PrefetchLoader(load, list(range(32)), workers=2, ahead=16)
    for item in loader:
        assert item == 0
        break
    time.sleep(0.3)
    assert len(started) < 16


def test_prefetch_loader_yields_load_errors_in_order():
    def load(i):
        if i == 3:
            raise ValueError("corrupt frame")
        return i * 10

    out = list(PrefetchLoader(load, list(range(6)), workers=3, ahead=4))
    assert [o for o in out if not hasattr(o, "error")] == [0, 10, 20, 40, 50]
    errs = [o for o in out if hasattr(o, "error")]
    assert len(errs) == 1 and errs[0].item == 3
    assert isinstance(errs[0].error, ValueError)


def test_stream_batches_dispatch_and_fetch_failures_go_serial():
    """A dispatch failure, or an EmitFetchError, degrades the chunk to the
    serial path; a serial failure is logged through on_error."""
    emitted, serialed, errors = [], [], []
    calls = {"dispatch": 0}

    def dispatch(chunk):
        calls["dispatch"] += 1
        if calls["dispatch"] == 2:
            raise RuntimeError("device fell over")
        return ("rec", list(chunk))

    def emit(rec):
        _, chunk = rec
        if 8 in chunk:
            raise EmitFetchError("fetch failed")
        emitted.extend(chunk)

    def serial(entry):
        if entry == 9:
            raise RuntimeError("serial also failed")
        serialed.append(entry)

    stream_batches(
        list(range(12)), 2, lambda x: ("batch", x), dispatch, emit, serial,
        lambda err: errors.append((err.item, str(err.error))),
    )
    seen = sorted(emitted + serialed + [e[0] for e in errors])
    assert seen == list(range(12))
    assert serialed and emitted
    assert 2 in serialed and 3 in serialed
    assert 8 in serialed
    assert [e[0] for e in errors] == [9]


def test_stream_batches_partial_emit_not_rerun():
    """An emit failure after side effects began is not re-run serially;
    the chunk's keys are logged through on_error."""
    emitted, serialed, errors = [], [], []

    def emit(rec):
        _, chunk = rec
        emitted.extend(chunk)
        if 2 in chunk:
            raise RuntimeError("run-log write failed mid-emit")

    stream_batches(
        list(range(6)), 2, lambda x: ("batch", x),
        lambda chunk: ("rec", list(chunk)), emit,
        serialed.append,
        lambda err: errors.append(err.item),
    )
    assert emitted == [0, 1, 2, 3, 4, 5]
    assert serialed == []
    assert errors == [2, 3]


def test_stream_batches_cancel_drops_undispatched():
    """On cancel the in-flight chunk drains but buffered entries are not
    dispatched; returns True."""
    dispatched, emitted = [], []
    state = {"seen": 0}

    def cancel():
        return state["seen"] >= 5

    def classify(x):
        state["seen"] += 1
        return ("batch", x)

    cancelled = stream_batches(
        iter(range(10)), 3, classify,
        lambda c: (dispatched.append(list(c)), list(c))[1],
        lambda rec: emitted.extend(rec),
        lambda e: emitted.append(e),
        lambda err: None,
        cancel=cancel,
    )
    assert cancelled is True
    assert dispatched == [[0, 1, 2]]
    assert emitted == [0, 1, 2]


def test_make_autoscaler_doubles_up_to_cap():
    class Loader:
        ready = 0

    loader = Loader()
    cur, grow = make_autoscaler(loader, 4, cap=16)
    grow()
    assert cur() == 4          # queue empty: decode-bound, no growth
    loader.ready = 6
    grow()
    assert cur() == 8
    loader.ready = 100
    grow()
    grow()
    assert cur() == 16         # capped


def test_batched_step_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    tiles = torch.from_numpy(rng.integers(0, 4000, (2, 3, 2, 32, 32))
                             .astype(np.uint16))
    sq = np.array([[4.5, 4.5], [25.5, 5.5], [26.5, 27.5], [3.5, 24.5]],
                  np.float32)
    lp = torch.from_numpy(np.broadcast_to(sq, (2, 3, 4, 2)).copy())
    valid = torch.tensor([[True, True, False], [True, True, True]])
    bgs = torch.tensor([[10.0, 20.0], [0.0, 5.5]])
    before = dict(tsk.launches)
    got = batched_tile_stats_step(tiles, lp, valid, bgs, clip_neg=False)
    want = tsk.tile_stats_packed_plain(tiles, lp, valid, bgs, clip_neg=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert tsk.launches == before
    assert got.shape == (2, 10, 2, 3)
