"""The segmentation cell on the CPU at a tiny size: the ``cpsam``
configuration and ``confluent`` traffic cut to a 64 x 96 frame, 2 stages,
64 probes and a Cellpose-SAM of width 64 in 2 blocks (tables of 27 and
127 rows), run through the harness as the chip runs ``seg.confluent``.

The tiny cell's limit (3.5e-3) lies between the program's readings
(9.1e-4 to 1.31e-3 over six seeds, these two among them) and the float8
control's (9.7e-3 to 1.50e-2), each set by ``prob``."""

import json
import os

import pytest

from benchmark import harness, spec
from benchmark.reference import compare

from .conftest import make_root

SEED = 2 ** 40 + 17
LIMIT = 3.5e-3


@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    root = make_root(str(tmp_path_factory.mktemp("seg_root")))
    bdir = os.path.join(root, "benchmark")
    cfg = spec.load_json(os.path.join(bdir, "configs", "cpsam.json"))
    cfg["model"] = dict(cfg["model"], width=64, depth=2, heads=4, mlp_dim=256, tile=32,
                        neck_dim=32, global_blocks=[1])
    cfg["settings"] = dict(cfg["settings"], tile=32, overlap=8, heads=4)
    cfg["limits"] = dict(cfg["limits"], max_rel_gap=LIMIT)
    with open(os.path.join(bdir, "configs", "cpsam_tiny.json"), "w") as f:
        json.dump(cfg, f)
    tr = spec.load_json(os.path.join(bdir, "traffic", "confluent.json"))
    p = tr["params"]
    p["frame"] = dict(p["frame"], shape=[64, 96], stages=2)
    p["rois"] = dict(p["rois"], count=6, cols=3, origin=[16, 16], pitch=[32, 32], jitter=2,
                     radius=[6, 10], vertices=[8, 12])
    p["probes"] = 64
    p["weights"] = dict(p["weights"], config="cpsam_tiny")
    with open(os.path.join(bdir, "traffic", "tiny_seg.json"), "w") as f:
        json.dump(tr, f)
    path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(path)
    bench["configs"].append({"name": "cpsam_tiny", "source": "CPU test", "reduced": [],
                             "file": "benchmark/configs/cpsam_tiny.json", "why": "CPU test"})
    bench["workloads"].append({"name": "seg.tiny", "config": "cpsam_tiny",
                               "traffic": "tiny_seg", "chips": 1, "why": "CPU test"})
    for m in bench["per_layer"]:
        if m["name"] in ("seg_host_pct", "untraced_pct"):
            m["workloads"].append("seg.tiny")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_the_seg_cell_is_correct_and_reports_its_metrics(seg_root):
    res = harness.run_cell(seg_root, "seg.tiny", SEED, 0.3, False, device="cpu")
    assert res["correct"], res["_stderr"]
    assert set(res["metrics"]) == {"mpix_s", "setup_s"}
    assert res["checks"]["max_rel_gap"]["value"] > 0
    traced = harness.run_cell(seg_root, "seg.tiny", SEED + 1, 0.3, True, device="cpu")
    assert traced["correct"], traced["_stderr"]
    assert set(traced["metrics"]) == {"seg_host_pct", "untraced_pct"}
    assert 0 < traced["metrics"]["seg_host_pct"]["value"] < 100
    assert 0 <= traced["metrics"]["untraced_pct"]["value"] < 100


def test_the_float8_control_fails_the_limit(seg_root):
    cell = spec.cell("seg.tiny", seg_root)
    bdir = spec.bench_dir(seg_root)
    exp = spec.module(bdir, "generators", "seg_experiment").ensure(
        cell.traffic["params"], SEED, os.path.join(seg_root, harness.WORK_DIR, "data"))
    ref = spec.module(bdir, "reference", "cpsam")
    want, areas = ref.rows(exp, cell.config["settings"])
    assert len(want) == 2 * 64
    ys, xs = (len(range(0, 64 - 32 + 1, 16)), len(range(0, 96 - 32 + 1, 16)))
    assert areas == [16] * (2 * ys * xs)          # every tile forwarded, 4 x 4 tokens
    got, _ = ref.rows(exp, cell.config["settings"], precision="bf16")
    g = compare.gaps(got, want, [], cell.config["float_fields"])
    assert g["max_rel_gap"] > LIMIT


def test_a_program_without_frame_maps_fails_the_cell(seg_root, monkeypatch):
    from imageprocess_tpu_torch.segment import cellseg

    monkeypatch.delattr(cellseg, "frame_maps")
    with pytest.raises(AttributeError, match="frame_maps"):
        harness.run_cell(seg_root, "seg.tiny", SEED, 0.3, False, device="cpu")
