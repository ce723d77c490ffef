"""What decides ``correct``: the reference against the port's CPU rows,
the control that has to fail, and faults planted under the timed path
that have to turn ``correct`` false."""

import pytest
import torch

from benchmark import harness, readings, spec


@pytest.mark.parametrize("cell", ["intensity.tiny", "fret.tiny", "intensity.tiny_serial"])
def test_reference_matches_the_ports_cpu_rows(tiny_root, cell):
    c = spec.cell(cell, tiny_root)
    _, _, prog = readings.program_readings(
        c, spec.bench_dir(tiny_root), f"{tiny_root}/.benchmark_work", 11, "cpu")
    checks = prog["checks"]
    assert checks["failed_calls"][0] == 0
    assert checks["missing_rows"][0] == 0
    assert checks["exact_mismatches"][0] == 0
    assert checks["max_rel_gap"][0] < 1e-6, prog["worst"]


@pytest.mark.parametrize("cell", ["intensity.tiny", "fret.tiny"])
def test_the_bf16_control_fails_the_limit(tiny_root, cell):
    c = spec.cell(cell, tiny_root)
    exp, want, _ = readings.program_readings(
        c, spec.bench_dir(tiny_root), f"{tiny_root}/.benchmark_work", 12, "cpu")
    ctl = readings.control_readings(c, spec.bench_dir(tiny_root), exp, want)
    gap, limit = ctl["checks"]["max_rel_gap"]
    assert gap > 3 * limit, ctl["worst"]


# ---------------------------------------------------------------- faults

def _unchanged(out):
    return torch.zeros_like(out)


def _half(out):
    """Half of the ROI lanes left out, their rows taken from the rest."""
    n = out.shape[-1]
    out = out.clone()
    out[..., n // 2:] = out[..., : n - n // 2]
    return out


def _altered(out):
    out = out.clone()
    out[0, 0, 0, 0] *= 1.001          # one mean, off by a thousandth
    return out


FAULTS = {"state_unchanged": _unchanged, "half_left_out": _half, "answer_altered": _altered}


def _patch_batched(monkeypatch, name, fault):
    from imageprocess_tpu_torch.parallel import runner

    real = getattr(runner, name)
    monkeypatch.setattr(runner, name, lambda *a, **k: fault(real(*a, **k)))


def _patch_serial(monkeypatch, fault):
    from imageprocess_tpu_torch.pipelines import intensity

    real = intensity.intensity_step_tiled

    def step(*a, **k):
        stats, area, bgs, imgs = real(*a, **k)
        packed = torch.stack([stats[f] for f in stats])[None]     # (1, F, C, N)
        packed = fault(packed)[0]
        return {f: packed[i] for i, f in enumerate(stats)}, area, bgs, imgs

    monkeypatch.setattr(intensity, "intensity_step_tiled", step)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell,step", [
    ("intensity.tiny", "batched_tile_stats_step"),
    ("fret.tiny", "batched_fret_tile_stats_step"),
    ("intensity.tiny_serial", None)])
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, monkeypatch, cell, step, fault):
    if step is None:
        _patch_serial(monkeypatch, FAULTS[fault])
    else:
        _patch_batched(monkeypatch, step, FAULTS[fault])
    res = harness.run_cell(tiny_root, cell, 21, 0.3, False, device="cpu")
    assert res["correct"] is False, res["_stderr"]


def test_the_same_run_without_a_fault_is_correct(tiny_root):
    res = harness.run_cell(tiny_root, "intensity.tiny", 21, 0.3, False, device="cpu")
    assert res["correct"] is True, res["_stderr"]


# ------------------------------------------------------ the report's files

def _drop(sheets, name):
    sheets.pop(name)


def _blank(sheets, name):
    """Every value of the sheet past its header and first column emptied."""
    rows = list(sheets[name])
    sheets[name] = rows[:1] + [r[:1] + [None] * (len(r) - 1) for r in rows[1:]]


def _nudge(sheets, name):
    """The first float of the sheet's first data row off by a thousandth."""
    rows = [list(r) for r in sheets[name]]
    j = min(j for j, v in enumerate(rows[1]) if type(v) is float)
    rows[1][j] *= 1.001
    sheets[name] = rows


def _truncate(sheets, name):
    sheets[name] = list(sheets[name])[:-1]


SHEET_FAULTS = {"dropped": _drop, "blanked": _blank, "altered": _nudge,
                "truncated": _truncate}


@pytest.mark.parametrize("fault", sorted(SHEET_FAULTS))
@pytest.mark.parametrize("cell,sheet", [
    ("fret.tiny", "ratio_mean_matrix"), ("fret.tiny", "ratio_median_matrix"),
    ("fret.tiny", "per_ROI"), ("intensity.tiny", "ch3"), ("intensity.tiny", "per_ROI")])
def test_a_fault_in_the_xlsx_is_not_correct(tiny_root, monkeypatch, cell, sheet, fault):
    """The rows and the CSV stay right; one sheet of the workbook the
    call writes is dropped, emptied, cut short or altered in one value."""
    from imageprocess_tpu_torch.report import xlsxlite

    real = xlsxlite.write_xlsx

    def write(path, sheets):
        sheets = dict(sheets)
        SHEET_FAULTS[fault](sheets, sheet)
        real(path, sheets)

    monkeypatch.setattr(xlsxlite, "write_xlsx", write)
    res = harness.run_cell(tiny_root, cell, 22, 0.3, False, device="cpu")
    assert res["correct"] is False, res["_stderr"]


def test_the_xlsx_reader_reads_the_ports_workbook(tmp_path):
    """The plain reader against the port's own reader on one workbook: both
    see the same sheets and cells."""
    from imageprocess_tpu_torch.report import xlsxlite

    from benchmark.reference import xlsx

    sheets = {"per_ROI": [["stage", "roi", "x", "flag", "txt"],
                          ["S01", 1, 0.1 + 0.2, True, "a<b & c"],
                          ["S02", 30, -1e-300, False, " lead"]],
              "wide": [["time_idx"] + [f"s1c{i}" for i in range(1, 1031)],
                       [0] + [float(i) / 7 for i in range(1, 1031)]]}
    path = str(tmp_path / "book.xlsx")
    xlsxlite.write_xlsx(path, sheets)
    got = xlsx.read(path)
    assert list(got) == ["per_ROI", "wide"]
    assert got["per_ROI"] == [["stage", "roi", "x", "flag", "txt"],
                              ["S01", 1.0, 0.1 + 0.2, True, "a<b & c"],
                              ["S02", 30.0, -1e-300, False, " lead"]]
    assert got["wide"][1][1030] == 1030 / 7
    assert got["wide"][0][1030] == "s1c1030"
