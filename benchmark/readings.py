"""The two readings each limit of ``correct`` is set from, at a cell's own
size: the program's (a dozen seeds or more; the lower reading is their
largest) and the control's (the reference in the precision below the
configuration's, put in the program's place; the upper reading is its
smallest).  The benchmark's runs do not run this.

    python3 benchmark/readings.py --workload intensity.bcc18 \
        --seeds 1 2 3 ... --control-seeds 1 2 3

One line per seed and side on stdout: the numbers ``harness.check``
compares, for the program over two calls and the last call's CSV and
XLSX, and for the control over its rows.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 2     # program calls read per seed, besides the last call's CSV


def program_readings(cell, bdir: str, work_dir: str, seed: int, device: str):
    from benchmark import harness, spec

    gen = spec.module(bdir, "generators", cell.traffic["generator"])
    exp = gen.ensure(cell.traffic["params"], seed, os.path.join(work_dir, "data"))
    drv = spec.module(bdir, "adapters", cell.config["adapter"]).Adapter(
        cell.config, cell.traffic, exp, os.path.join(work_dir, "out", cell.name), device)
    drv.prepare()
    rows = [drv.call() for _ in range(CALLS)]
    failed = sum(not harness.rows_ok(r, drv.rows_expected) for r in rows)
    ref = spec.module(bdir, "reference", cell.config["reference"])
    want, _ = ref.rows(exp, cell.config["settings"])
    ok = [r for r in rows if harness.rows_ok(r, drv.rows_expected)]
    return exp, want, harness.check(cell.config, ok, drv.out_dir, want, failed)


def control_readings(cell, bdir: str, exp: dict, want: dict):
    """The bf16 control's rows through the same comparison (no calls, no
    CSV)."""
    from benchmark import spec
    from benchmark.reference import compare

    ref = spec.module(bdir, "reference", cell.config["reference"])
    got, _ = ref.rows(exp, cell.config["settings"], precision="bf16")
    g = compare.gaps(got, want, cell.config["exact_fields"], cell.config["float_fields"])
    lim = cell.config["limits"]
    return {"checks": {k: (g[k], lim[k]) for k in ("missing_rows", "exact_mismatches",
                                                     "max_rel_gap")},
            "worst": g["worst"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path[0] = ROOT
    from benchmark import harness, spec

    cell = spec.cell(args.workload, ROOT)
    bdir = spec.bench_dir(ROOT)
    work_dir = os.path.join(ROOT, harness.WORK_DIR)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        exp, want, prog = program_readings(cell, bdir, work_dir, seed, "cuda")
        line = {"workload": args.workload, "seed": seed, "side": "program",
                **{k: v for k, (v, _) in prog["checks"].items()}, "worst": prog["worst"]}
        print(json.dumps(line, default=str), flush=True)
        if seed in args.control_seeds:
            ctl = control_readings(cell, bdir, exp, want)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": "control_bf16",
                              **{k: v for k, (v, _) in ctl["checks"].items()},
                              "worst": ctl["worst"]}, default=str), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
