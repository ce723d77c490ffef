"""Run one cell of the benchmark of ``imageprocess_tpu_torch`` on this
machine's card(s) and print its result as the last line of stdout.

    python3 benchmark/run.py --workload intensity.bcc18 --seed 7 \
        --seconds 51 --trace 0

``--trace 0`` measures the end-to-end metrics over a window of
``--seconds``; ``--trace 1`` profiles the traffic's fixed count of calls
and reports the per-layer metrics.  Without as many CUDA cards as the cell
asks for, or if JAX or the JAX package was loaded, it exits non-zero and
prints no result.  Generated experiments and outputs stay under
``.benchmark_work/``, the kernel libraries in the port's ``_build/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[0] = ROOT  # the checkout, not benchmark/: the package imports as benchmark.*
    from benchmark import harness, spec

    chips = spec.cell(args.workload, ROOT).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"need {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    banned = harness.banned_modules()
    if banned:
        print(f"JAX or the JAX package was loaded: {banned}", file=sys.stderr)
        return 3
    for line in result.pop("_stderr"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
