"""One run of one cell: set-up, the measured window (or, with ``trace``,
a fixed count of profiled calls), the check against the reference, and
the result line's fields.

Set-up is everything before the window: imports, the kernel libraries,
the experiment (written anew from the seed in every run), and one warm-up
call.  The window calls the cell's unit again and again
until ``seconds`` have passed and the call in flight has ended.  A traced
run profiles the traffic's ``trace_calls`` calls; where the traffic says
``trace_window``, after a window of its own whose latencies per-layer
readers may read.  After it
the device's peak memory is read, the program's state is let go, and the
reference recomputes the tables from the generated files.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import time

from . import profiling, spec, work
from .reference import compare, xlsx

WORK_DIR = ".benchmark_work"   # under the checkout; listed in .gitignore
BANNED = ("jax", "jaxlib", "flax", "imageprocess_tpu")
SAMPLED_CALLS = 3              # window calls whose rows are compared in full


def banned_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    BANNED, compared whole: ``imageprocess_tpu_torch`` is not
    ``imageprocess_tpu``."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def rows_ok(rows, expected: int) -> bool:
    return isinstance(rows, list) and len(rows) == expected


def run_window(drv, seconds: float, seed: int, sync) -> dict:
    """Calls until *seconds* have passed; every call's wall time, the
    failures, and the rows of SAMPLED_CALLS calls drawn from *seed*
    (reservoir sampling, so any call of the window may be drawn)."""
    rng = random.Random(seed)
    lat, sample, failed, errors = [], [], 0, []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while True:
        t0 = time.perf_counter()
        try:
            rows = drv.call()
        except Exception as e:  # noqa: BLE001 -- counted and reported
            rows = e
        sync()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        i = len(lat) - 1
        if not rows_ok(rows, drv.rows_expected):
            failed += 1
            errors.append(repr(rows)[:300] if isinstance(rows, Exception)
                          else f"call {i}: {len(rows)} rows, want {drv.rows_expected}")
        elif i < SAMPLED_CALLS:
            sample.append(rows)
        else:
            j = rng.randrange(i + 1)
            if j < SAMPLED_CALLS:
                sample[j] = rows
        if t1 >= t_end:
            break
    return {"latency_s": lat, "window_s": time.perf_counter() - t_start,
            "sample": sample, "failed": failed, "errors": errors[:5]}


def _tree_bytes(top: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(top)
               for n in names)


def _labelled(label: str, g: dict) -> dict:
    if g["worst"] is not None:
        g["worst"] = (label, *g["worst"])
    return g


def _missing(want: dict) -> dict:
    return {"missing_rows": len(want), "exact_mismatches": 0, "max_rel_gap": 0.0, "worst": None}


def output_gaps(config: dict, out_dir: str, want: dict) -> list:
    """The gaps of the files the last call left in *out_dir*: the CSV, and
    every sheet of the XLSX that the configuration's ``sheets`` names (a
    table of rows per ROI with the fields its patterns select, or a
    ``pivot`` matrix of one field).  A file or sheet that is not there
    misses every row."""
    exact, floats = config["exact_fields"], config["float_fields"]
    csv_path = os.path.join(out_dir, config["csv"])
    parts = [_labelled("csv", compare.gaps(compare.read_csv(csv_path), want, exact, floats))
             if os.path.exists(csv_path) else _missing(want)]
    xlsx_path = os.path.join(out_dir, config["xlsx"])
    book = xlsx.read(xlsx_path) if os.path.exists(xlsx_path) else {}
    for name, sheet in config["sheets"].items():
        if name not in book:
            parts.append(_missing(want))
        elif "pivot" in sheet:
            f = sheet["pivot"]
            got = compare.pivot_table(book[name], f, want)
            parts.append(_labelled(name, compare.gaps(got, want, compare.select(exact, [f]),
                                                      compare.select(floats, [f]))))
        else:
            got = compare.sheet_table(book[name])
            parts.append(_labelled(name, compare.gaps(
                got, want, compare.select(exact, sheet["fields"]),
                compare.select(floats, sheet["fields"]))))
    return parts


def check(config: dict, sample: list, out_dir: str, want: dict, failed: int) -> dict:
    """{name: (value, limit)} of every number the cell compares: the rows
    of the sampled calls, and the CSV and XLSX of the last call."""
    exact, floats = config["exact_fields"], config["float_fields"]
    parts = [_labelled("rows", compare.gaps(compare.table(rows), want, exact, floats))
             for rows in sample]
    parts += output_gaps(config, out_dir, want)
    g = compare.merge(parts)
    lim = config["limits"]
    return {"checks": {"failed_calls": (failed, lim["failed_calls"]),
                       "missing_rows": (g["missing_rows"], lim["missing_rows"]),
                       "exact_mismatches": (g["exact_mismatches"], lim["exact_mismatches"]),
                       "max_rel_gap": (g["max_rel_gap"], lim["max_rel_gap"])},
            "worst": g["worst"], "compared_sets": len(parts)}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None) -> dict:
    """One run; returns the result line's fields plus ``_stderr`` lines."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start and imports": time.perf_counter() - t0}
    cell = spec.cell(workload, root)
    bdir = spec.bench_dir(root)
    work_dir = os.path.join(root, WORK_DIR)
    traffic = cell.traffic
    gen = spec.module(bdir, "generators", traffic["generator"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = time.perf_counter()
    exp = gen.ensure(traffic["params"], seed, os.path.join(work_dir, "data"))
    phases["experiment"] = time.perf_counter() - t
    if cuda:
        t = time.perf_counter()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        phases["device context"] = time.perf_counter() - t
    t = time.perf_counter()
    drv = spec.module(bdir, "adapters", cell.config["adapter"]).Adapter(
        cell.config, traffic, exp, os.path.join(work_dir, "out", workload), device)
    drv.prepare()
    phases["port and libraries"] = time.perf_counter() - t
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    warm = drv.call()
    sync()
    phases["warm-up call"] = time.perf_counter() - t
    if not rows_ok(warm, drv.rows_expected):
        raise RuntimeError(f"warm-up call gave {len(warm)} rows, want {drv.rows_expected}: "
                           f"{list(drv.log_tail)[-5:]}")
    del warm
    setup_s = time.perf_counter() - t0

    rec = {"setup_s": setup_s, "pixels_per_unit": drv.pixels, "keys_per_unit": drv.keys}
    window = not trace or traffic.get("trace_window", False)
    run = run_window(drv, seconds, seed, sync) if window else \
        {"latency_s": [], "window_s": 0.0, "sample": [], "failed": 0, "errors": []}
    rec.update(latency_s=run["latency_s"], window_s=run["window_s"])
    if trace:
        tr = profiling.trace_calls(drv.call, int(traffic.get("trace_calls", 3)), cuda=cuda)
        results = tr.pop("results")
        ok = [r for r in results if rows_ok(r, drv.rows_expected)]
        run["latency_s"] = run["latency_s"] + tr.pop("walls_s")
        run["sample"] += ok
        run["failed"] += len(results) - len(ok)
        run["errors"] += [repr(r)[:300] for r in results if isinstance(r, Exception)]
        rec.update(tr)
        rec["calls"] = len(results)
    rec.update(attempted=len(run["latency_s"]), failed=run["failed"])
    rec["units_ok"] = rec["attempted"] - rec["failed"]
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    out_dir, log_tail = drv.out_dir, list(drv.log_tail)
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = spec.module(bdir, "reference", cell.config["reference"])
    t_ref = time.perf_counter()
    want, areas = ref.rows(exp, cell.config["settings"])
    verdict = check(cell.config, run["sample"], out_dir, want, run["failed"])
    rec["reference_s"] = time.perf_counter() - t_ref
    rec["work"] = work.tables_work(areas, cell.config["work"], len(cell.config["input_channels"]))
    rec["peak"] = work.peak(kind)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.module(bdir, "metrics", m["name"]).read(rec)
        if value is None:
            raise RuntimeError(f"{m['name']}, listed for {workload}, found nothing to read: "
                               "the program no longer gives what its reader reads")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"], dev["window_s"] = rec["busy_s"], rec["traced_s"]
    checks = verdict["checks"]
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    notes = [f"reference {rec['reference_s']:.2f} s over {verdict['compared_sets']} row sets "
             f"(sampled calls, the last CSV and XLSX sheets); widest gap at {verdict['worst']}"]
    lat = sorted(run["latency_s"])
    notes.append(f"calls {len(lat)}: latency min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} "
                 f"max {lat[-1]:.4f} s")
    notes.append(f"set-up {setup_s:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
                 + f"); one call's outputs {_tree_bytes(out_dir)} bytes")
    notes += [f"failed call: {e}" for e in run["errors"]]
    if run["failed"]:
        notes += [f"runner log: {line}" for line in log_tail[-5:]]
    result["_stderr"] = notes + [f"check {k} = {v!r} limit {lim!r}" for k, (v, lim) in checks.items()]
    return result
