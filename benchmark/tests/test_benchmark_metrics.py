"""The arithmetic of the metric readers and of the yardstick."""

import math

import numpy as np
import pytest

from benchmark import profiling, spec, work

from .conftest import REPO


def read(name, rec):
    return spec.module(spec.bench_dir(REPO), "metrics", name).read(rec)


def test_rate_is_over_the_whole_window():
    rec = {"units_ok": 9, "pixels_per_unit": 16 * 2 * 1536 * 2048, "window_s": 10.0}
    assert read("mpix_s", rec) == pytest.approx(9 * 100663296 / 10.0 / 1e6)


def test_p90_is_over_every_unit_of_the_window():
    lat = [0.001 * ((i * 37) % 101 + 1) for i in range(150)]
    assert read("experiment_p90_ms", {"latency_s": lat}) == pytest.approx(
        np.percentile(lat, 90) * 1e3)
    assert read("experiment_p90_ms", {"latency_s": [0.25]}) == pytest.approx(250.0)
    assert read("experiment_p90_ms", {"latency_s": []}) is None


def test_union_counts_overlaps_once_and_gaps_are_the_rest():
    spans = [(0, 10), (5, 15), (20, 30), (29, 31)]
    assert profiling.union(spans) == 26
    assert profiling.idle_gaps(spans, 0, 40) == [(15, 20), (31, 40)]
    assert profiling.idle_gaps(spans, -5, 12) == [(-5, 0)]


def test_idle_and_launches():
    rec = {"kernels": [("k", 0, 2)] * 32, "copies": [], "busy_s": 0.25, "traced_s": 1.0,
           "keys_per_unit": 16, "calls": 2}
    assert read("idle_pct", rec) == pytest.approx(75.0)
    assert read("launches_per_key", rec) == pytest.approx(1.0)
    assert read("idle_pct", {"kernels": [], "copies": []}) is None


def test_phase_shares():
    rec = {"phase_s": {"load_wait": 0.3, "emit": 0.1, "xls": 0.2}, "traced_s": 1.5}
    assert read("decode_wait_pct", rec) == pytest.approx(20.0)
    assert read("emit_pct", rec) == pytest.approx(20.0)
    assert read("decode_wait_pct", {"phase_s": {}, "traced_s": 1.0}) is None


@pytest.mark.parametrize("config,per_px_bytes,out,ops", [
    ("intensity", 4, 80, 14), ("fret", 4, 120, 22)])
def test_step_work_counts_pixels_channels_and_rows(config, per_px_bytes, out, ops):
    cfg = spec.load_json(f"{REPO}/benchmark/configs/{config}.json")
    areas = [1000, 2500, 7]
    w = work.tables_work(areas, cfg["work"], len(cfg["input_channels"]))
    assert w["bytes"] == 3507 * per_px_bytes + 3 * out
    assert w["ops"] == 3507 * ops


def test_roofline_is_least_time_over_kernel_union():
    pk = work.peak("NVIDIA H100 80GB HBM3")
    assert pk == {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13}
    rec = {"kernels": [("a", 0.0, 100.0), ("b", 50.0, 150.0)], "peak": pk, "calls": 2,
           "work": {"bytes": 3.35e6, "ops": 0.0}}
    # least 2 x 1 us over a union of 150 us
    assert read("step_roofline", rec) == pytest.approx(100.0 * 2e-6 / 150e-6)
    rec["work"] = {"bytes": 0.0, "ops": 6.7e7}           # the operations bound it
    assert read("step_roofline", rec) == pytest.approx(100.0 * 2e-6 / 150e-6)
    assert read("step_roofline", dict(rec, peak=None)) is None
    assert work.least_seconds(1.0, 0.0, pk) == pytest.approx(1 / 3.35e12)
    assert not math.isnan(work.least_seconds(0.0, 0.0, pk))
