"""Fixtures of the benchmark's CPU tests: a copy of the checkout's
benchmark files with a tiny traffic mix and its cells, so that a whole run
goes through on the CPU in seconds."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {
    "unit": "experiment", "generator": "tiff_experiment", "runner": "batched",
    "trace_calls": 2,
    "params": {
        "frame": {"shape": [160, 224], "channels": [2, 3], "stages": 3, "compression": "none",
                  "background": {"mean": 120, "sd": 15},
                  "bodies": {"amplitude": [800, 3000], "sigma": 0.6}},
        "rois": {"count": 10, "cols": 4, "origin": [28, 28], "pitch": [56, 52], "jitter": 4,
                 "radius": [16, 24], "vertices": [12, 40], "harmonics": [2, 3],
                 "wobble": 0.03, "per_stage": True, "shuffle": True,
                 "shapes_seed": 3}}}
TINY_CELLS = {"intensity.tiny": ("intensity", "tiny"), "fret.tiny": ("fret", "tiny"),
              "intensity.tiny_serial": ("intensity", "tiny_serial")}


def make_root(dest: str) -> str:
    """A checkout-like root: BENCHMARK.json and benchmark/ copied, with the
    tiny mixes and their cells added; the port is imported from REPO."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    for name, runner in (("tiny", "batched"), ("tiny_serial", "serial")):
        with open(os.path.join(dest, "benchmark", "traffic", name + ".json"), "w") as f:
            json.dump(dict(TINY, runner=runner, trace_window=runner == "serial"), f)
    for cell, (config, traffic) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "CPU test"})
    with open(os.path.join(dest, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench_root")))
