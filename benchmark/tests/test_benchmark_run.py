"""The result line, the check for JAX, and the refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

from .conftest import REPO


def test_untraced_line_has_the_contracts_keys(tiny_root):
    res = harness.run_cell(tiny_root, "intensity.tiny", 31, 0.5, False, device="cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-2:] == ["checks", "_stderr"]
    assert set(res["metrics"]) == {"mpix_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    assert res["_stderr"][-len(res["checks"]):] == [
        f"check {k} = {v['value']!r} limit {v['limit']!r}" for k, v in res["checks"].items()]
    json.dumps({k: v for k, v in res.items() if k != "_stderr"})


def test_traced_line_has_busy_window_and_breakdown(tiny_root):
    res = harness.run_cell(tiny_root, "intensity.tiny", 32, 0.5, True, device="cpu")
    assert res["correct"] and res["attempted"] == 2
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_a_traced_run_with_a_window_checks_both(tiny_root):
    """``trace_window``: the window's calls, then the profiled ones; all of
    them are attempted and their rows sampled."""
    res = harness.run_cell(tiny_root, "intensity.tiny_serial", 35, 0.3, True, device="cpu")
    assert res["correct"] and res["attempted"] > 2
    assert res["device"]["window_s"] > 0


def test_jax_check_compares_whole_top_level_names():
    names = ["jax.numpy", "imageprocess_tpu.ops", "imageprocess_tpu_torch.ops", "jaxlib",
             "flax.linen", "jaxtyping", "imageprocess_tpu", "numpy"]
    assert harness.banned_modules(names) == [
        "flax.linen", "imageprocess_tpu", "imageprocess_tpu.ops", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from benchmark import harness\n"
            "r = harness.run_cell(%r, 'fret.tiny', 33, 0.2, False, device='cpu')\n"
            "assert r['correct'], r['_stderr']\n"
            "print(harness.banned_modules())\n") % (tiny_root, REPO, tiny_root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, os.path.join(REPO, "benchmark", "run.py"),
                          "--workload", "intensity.bcc18", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for trace in (False, True):
        res = harness.run_cell(tiny_root, "intensity.tiny", 34, 1.0, trace, device="cuda")
        assert res["correct"], res["_stderr"]
        assert res["device"]["platform"] == "gpu"
