"""Find what a cell is made of by the names ``BENCHMARK.json`` gives.

A cell (``workloads`` entry) names a configuration (its ``file``) and a
traffic mix (``<bench>/traffic/<name>.json``).  The configuration names
its adapter (``<bench>/adapters/<name>.py``) and its reference
(``<bench>/reference/<name>.py``); the traffic names its generator
(``<bench>/generators/<name>.py``); each metric is a reader
(``<bench>/metrics/<name>.py``).  A later cell, mix, generator or metric
is a new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PACKAGE = os.path.basename(BENCH_DIR)


def load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def module(bench_dir: str, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py`` loaded by its path, as a module of
    the package ``benchmark.<kind>`` (so it may import its siblings).  It
    is kept in ``sys.modules``, and loaded once per path, so that worker
    processes can be handed its functions by name."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r}: {path}")
    parent = f"{PACKAGE}.{kind}"
    importlib.import_module(parent)
    mod_name = f"{parent}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell(workload: str, root: str = ROOT) -> Cell:
    """The cell *workload* of ``<root>/BENCHMARK.json``, with its
    configuration and traffic read and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    bench_dir = os.path.join(root, bench["paths"][0])
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=c["name"],
                config=load_json(os.path.join(root, c["file"])),
                traffic_name=w["traffic"],
                traffic=load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
                end_to_end=e2e, per_layer=layer)


def bench_dir(root: str = ROOT) -> str:
    return os.path.join(root, load_json(os.path.join(root, "BENCHMARK.json"))["paths"][0])
