"""Cells, mixes, generators and metrics are found by name: a new one is a
new file and a new entry, with no edit to a file that is there."""

import json
import os

import pytest

from benchmark import harness, spec

from .conftest import REPO, TINY, make_root


def test_the_committed_cells_resolve():
    bench = spec.load_json(os.path.join(REPO, "BENCHMARK.json"))
    assert bench["paths"] == ["benchmark"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], REPO)
        assert cell.traffic["runner"] in cell.config["entries"]
        assert cell.end_to_end and cell.per_layer
        assert {"setup_s", "mpix_s"} <= {m["name"] for m in cell.end_to_end}
        bdir = spec.bench_dir(REPO)
        spec.module(bdir, "generators", cell.traffic["generator"])
        spec.module(bdir, "adapters", cell.config["adapter"])
        spec.module(bdir, "reference", cell.config["reference"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.module(bdir, "metrics", m["name"]).read)


def test_new_traffic_and_metric_files_are_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    before = {p: open(p, "rb").read() for p in _files(os.path.join(root, "benchmark"))}
    with open(os.path.join(root, "benchmark", "traffic", "tiny_lzw.json"), "w") as f:
        json.dump(dict(TINY, params=dict(TINY["params"], frame=dict(
            TINY["params"]["frame"], compression="lzw"))), f)
    with open(os.path.join(root, "benchmark", "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(rec):\n    return rec['attempted'] / rec['window_s']\n")
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["workloads"].append({"name": "intensity.tiny_lzw", "config": "intensity",
                               "traffic": "tiny_lzw", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["intensity.tiny_lzw"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res = harness.run_cell(root, "intensity.tiny_lzw", 5, 0.5, False, device="cpu")
    assert res["correct"], res["_stderr"]
    assert res["metrics"]["calls_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"mpix_s", "setup_s", "calls_per_s"}
    for p, data in before.items():          # nothing that was there changed
        assert open(p, "rb").read() == data, p


def test_a_cell_reports_only_the_metrics_listed_for_it(tiny_root):
    for name in ("intensity.bcc18", "fret.bcc18"):
        cell = spec.cell(name, tiny_root)
        assert {m["name"] for m in cell.per_layer} == {
            "decode_wait_pct", "emit_pct", "step_roofline", "launches_per_key", "idle_pct",
            "experiment_p90_ms"}
        assert {m["name"] for m in cell.end_to_end} == {"mpix_s", "setup_s"}
    serial = spec.cell("intensity.tiny_serial", tiny_root)   # listed for no metric
    assert serial.per_layer == [] and {m["name"] for m in serial.end_to_end} == {
        "mpix_s", "setup_s"}


def test_an_unknown_name_is_refused(tiny_root):
    with pytest.raises(KeyError):
        spec.cell("intensity.nothing", tiny_root)
    with pytest.raises(FileNotFoundError):
        spec.module(spec.bench_dir(tiny_root), "metrics", "no_such_metric")


def _files(top):
    for d, _, names in os.walk(top):
        for n in names:
            if "__pycache__" not in d:
                yield os.path.join(d, n)


def _listed_for(root, cell, metric):
    path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(path)
    for m in bench["per_layer"]:
        if m["name"] == metric:
            m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)


def test_a_listed_metric_that_reads_nothing_fails_the_run(tmp_path):
    """On the CPU the profiler sees no kernels: a cell that lists
    ``launches_per_key`` then fails instead of leaving it out."""
    root = make_root(str(tmp_path))
    _listed_for(root, "intensity.tiny", "decode_wait_pct")
    res = harness.run_cell(root, "intensity.tiny", 41, 0.2, True, device="cpu")
    assert res["metrics"]["decode_wait_pct"]["value"] > 0
    _listed_for(root, "intensity.tiny", "launches_per_key")
    with pytest.raises(RuntimeError, match="launches_per_key"):
        harness.run_cell(root, "intensity.tiny", 41, 0.2, True, device="cpu")


def test_a_program_without_the_phase_hook_fails_the_traced_run(tiny_root, monkeypatch):
    from imageprocess_tpu_torch import timing

    monkeypatch.delattr(timing.HostPhases, "_span")
    with pytest.raises(RuntimeError, match="_span"):
        harness.run_cell(tiny_root, "intensity.tiny", 42, 0.2, True, device="cpu")
