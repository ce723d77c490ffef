"""The readers of the runners' own spans: ``untraced_pct``,
``load_ms_per_key`` and ``decode_mpix_s``: their arithmetic, nothing to
read without their phases, and a traced CPU run of the tiny cell in which
all three read a number."""

import json
import os

import pytest

from benchmark import harness, spec

from .conftest import REPO, make_root

NEW = ("untraced_pct", "load_ms_per_key", "decode_mpix_s")


def read(name, rec):
    return spec.module(spec.bench_dir(REPO), "metrics", name).read(rec)


def test_the_arithmetic_of_the_span_readers():
    rec = {"phase_s": {"plan": 0.05, "load_wait": 0.4, "emit": 0.2, "xls": 0.25,
                       "ld_decode": 2.0, "ld_bg": 0.3, "ld_roi": 0.1},
           "traced_s": 1.0, "keys_per_unit": 16, "calls": 3,
           "pixels_per_unit": 16 * 2 * 1536 * 2048}
    assert read("untraced_pct", rec) == pytest.approx(10.0)
    assert read("load_ms_per_key", rec) == pytest.approx(1000.0 * 2.4 / 48)
    assert read("decode_mpix_s", rec) == pytest.approx(3 * 100663296 / 1e6 / 2.0)


@pytest.mark.parametrize("phases", [{}, {"ld_decode": 1.0, "ld_bg": 0.5}, {"load_wait": 0.3},
                                    {"load_wait": 0.3, "ld_decode": 0.0}])
def test_without_their_phases_the_span_readers_read_nothing(phases):
    rec = {"phase_s": phases, "traced_s": 1.0, "keys_per_unit": 16, "calls": 3,
           "pixels_per_unit": 100}
    main = any(not k.startswith("ld_") for k in phases)
    loads = any(k.startswith("ld_") for k in phases)
    assert (read("untraced_pct", rec) is None) == (not main)
    assert (read("load_ms_per_key", rec) is None) == (not loads)
    assert (read("decode_mpix_s", rec) is None) == (not phases.get("ld_decode"))
    assert all(read(m, {"traced_s": 1.0}) is None for m in NEW)


def test_a_traced_cpu_run_of_the_tiny_cell_reads_all_three(tmp_path):
    root = make_root(str(tmp_path))
    path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(path)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("intensity.tiny")
    with open(path, "w") as f:
        json.dump(bench, f)
    res = harness.run_cell(root, "intensity.tiny", 43, 0.2, True, device="cpu")
    assert res["correct"], res["_stderr"]
    got = {m: res["metrics"][m]["value"] for m in NEW}
    assert 0.0 <= got["untraced_pct"] <= 100.0, got
    assert got["load_ms_per_key"] > 0 and got["decode_mpix_s"] > 0, got
