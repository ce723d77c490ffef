"""The intensity, FRET and rim-FRET reports without pandas.

Port of ``imageprocess_tpu/report/excel.py::save_intensity_excel``,
``save_fret_excel`` and ``save_nesprin2_excel``: the same
``fluor_intensity_perROI.{xlsx,csv}``, ``fret_ratio_perROI.{xlsx,csv}`` and
``nesprin2_fret_perROI.{xlsx,csv}`` files, columns, column order, derived
columns (``stage_idx``, ``time_idx``, ``roi_lab``, ``roi_id``) and sheets,
written with ``xlsxlite.write_xlsx`` and the stdlib ``csv`` module.
Cells are formatted as ``DataFrame.to_csv`` formats them: missing values and
NaN as empty fields, floats by their shortest repr, and the ints of a
numeric column that also has missing values or floats as floats.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Tuple

from ..core import naming
from . import xlsxlite

BASE_COLS = ("stage", "time", "roi", "area_px",
             "bg_mode", "bg_scope", "clip_neg", "bg_stride")
FRET_COLS = ("stage", "time", "roi", "area_px", "ratio_mean", "ratio_median",
             "ratio_std", "ratio_p5", "ratio_p95", "donor_mean", "donor_median",
             "yfret_mean", "yfret_median", "eps", "p", "ratio_mode", "bg_mode")
N2_COLS = ("stage", "time", "roi", "area_px", "ratio_mode",
           "ratio_mean", "ratio_median", "ratio_std", "ratio_p5", "ratio_p95",
           "ratio_FoverD_mean", "ratio_DoverF_mean", "donor_mean", "fret_mean",
           "eps", "p", "donor_p", "fret_p", "bg_scope", "bg_mode", "clip_neg",
           "sat_filter_on", "sat_threshold", "clip_ratio_on", "clip_ratio_max")
_CH_MEAN = re.compile(r"ch(\d+)_mean")


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _int_of(pattern: str, s: str) -> int:
    return int(re.search(pattern, s).group(1))


def intensity_table(rows_all: List[dict]) -> Tuple[List[str], List[list]]:
    """(columns, rows) of the per-ROI table: the reference's base columns,
    the per-channel columns in natural order, then the derived columns."""
    if not rows_all:
        return [], []
    seen: Dict[str, None] = {}
    for r in rows_all:
        seen.update(dict.fromkeys(r))
    dyn = sorted((c for c in seen if c not in BASE_COLS), key=naming.natural_key)
    cols = list(BASE_COLS) + dyn
    timed = any(r.get("time") is not None for r in rows_all)
    table = []
    for r in rows_all:
        stage_idx = _int_of(r"S(\d+)", r["stage"])
        time_idx = _int_of(r"t(\d+)", r.get("time") or "t0") if timed else 0
        table.append([r.get(c) for c in cols] + [
            stage_idx, time_idx, f"s{stage_idx}c{r['roi']}",
            f"{r['stage']}_roi{r['roi']}"])
    return cols + ["stage_idx", "time_idx", "roi_lab", "roi_id"], table


def _csv_cells(columns: List[str], table: List[list]) -> List[list]:
    """Cells formatted as pandas writes them."""
    as_float = set()
    for j in range(len(columns)):
        vals = [row[j] for row in table]
        if any(_missing(v) or isinstance(v, float) for v in vals) and all(
                _missing(v) or (isinstance(v, (int, float))
                                and not isinstance(v, bool))
                for v in vals):
            as_float.add(j)
    out = []
    for row in table:
        cells = []
        for j, v in enumerate(row):
            if _missing(v):
                cells.append("")
            elif isinstance(v, float) or j in as_float:
                cells.append(repr(float(v)))
            else:
                cells.append(str(v))
        out.append(cells)
    return out


def _pivot(columns: List[str], table: List[list], value: str) -> List[list]:
    """``DataFrame.pivot(index="time_idx", columns="roi_lab", values=value)
    .sort_index()`` as sheet rows: header ["time_idx", labels...], then one
    row per time; missing cells NaN, duplicate entries raise as pandas
    does."""
    col = {c: j for j, c in enumerate(columns)}
    times = sorted({row[col["time_idx"]] for row in table})
    labs = sorted({row[col["roi_lab"]] for row in table})
    cell: Dict[Tuple[int, str], object] = {}
    for row in table:
        key = (row[col["time_idx"]], row[col["roi_lab"]])
        if key in cell:
            raise ValueError("Index contains duplicate entries, cannot reshape")
        cell[key] = row[col[value]]
    return [["time_idx"] + labs] + [
        [ti] + [cell.get((ti, lab), float("nan")) for lab in labs]
        for ti in times]


def _write_csv(path: str, columns: List[str], table: List[list]) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(_csv_cells(columns, table))


def save_intensity_excel(rows_all: List[dict], keymap: Dict, xls_dir: str) -> None:
    """``fluor_intensity_perROI.{xlsx,csv}`` with per-channel sheets
    (non-timelapse) or time x roi pivot matrices (timelapse)."""
    columns, table = intensity_table(rows_all)
    if not table:
        return
    col = {c: j for j, c in enumerate(columns)}
    ch_list = sorted({int(m.group(1)) for c in columns
                      if (m := _CH_MEAN.match(c))})
    sheets = {"per_ROI": [columns] + [list(row) for row in table]}
    is_tl = any(k[1] is not None for k in keymap.keys())
    if not is_tl:
        order = sorted(table, key=lambda row: (row[col["stage"]],
                                               row[col["roi"]]))
        for ch in ch_list:
            keep = ["stage", "roi", "roi_id", "area_px"] + [
                c for c in columns if c.startswith(f"ch{ch}_")]
            sheets[f"ch{ch}"] = [["No."] + keep] + [
                [i] + [row[col[c]] for c in keep]
                for i, row in enumerate(order, 1)]
    else:
        for ch in ch_list:
            for stat in ("mean", "median"):
                sheets[f"ch{ch}_{stat}_matrix"] = _pivot(columns, table,
                                                         f"ch{ch}_{stat}")
    xlsxlite.write_xlsx(os.path.join(xls_dir, "fluor_intensity_perROI.xlsx"),
                        sheets)
    _write_csv(os.path.join(xls_dir, "fluor_intensity_perROI.csv"), columns,
               table)


def fret_table(rows_all: List[dict], timelapse: bool) -> Tuple[List[str], List[list]]:
    """(columns, rows) of the FRET per-ROI table: the reference's column
    subset in its order, then ``time_idx``, ``stage_idx`` and ``roi_lab``."""
    if not rows_all:
        return [], []
    present = set().union(*rows_all)
    cols = [c for c in FRET_COLS if c in present]
    table = []
    for r in rows_all:
        time_idx = _int_of(r"t(\d+)", r["time"]) if timelapse else 0
        stage_idx = _int_of(r"S(\d+)", r["stage"])
        table.append([r.get(c) for c in cols] + [
            time_idx, stage_idx, f"s{stage_idx}c{r['roi']}"])
    return cols + ["time_idx", "stage_idx", "roi_lab"], table


def save_fret_excel(rows_all: List[dict], xls_dir: str, timelapse: bool) -> None:
    """``fret_ratio_perROI.{xlsx,csv}`` with the reference's column
    subset/order and the ratio mean/median time x roi matrices."""
    columns, table = fret_table(rows_all, timelapse)
    if not table:
        return
    os.makedirs(xls_dir, exist_ok=True)
    xlsxlite.write_xlsx(os.path.join(xls_dir, "fret_ratio_perROI.xlsx"), {
        "per_ROI": [columns] + [list(row) for row in table],
        "ratio_mean_matrix": _pivot(columns, table, "ratio_mean"),
        "ratio_median_matrix": _pivot(columns, table, "ratio_median"),
    })
    _write_csv(os.path.join(xls_dir, "fret_ratio_perROI.csv"), columns, table)


def nesprin2_table(rows_all: List[dict], timelapse: bool) -> Tuple[List[str], List[list]]:
    """(columns, rows) of the rim-FRET per-ROI table: the reference's
    column subset in its order, then ``stage_idx``, ``time_idx`` and
    ``roi_lab``."""
    if not rows_all:
        return [], []
    present = set().union(*rows_all)
    cols = [c for c in N2_COLS if c in present]
    table = []
    for r in rows_all:
        stage_idx = _int_of(r"S(\d+)", r["stage"])
        time_idx = _int_of(r"t(\d+)", r["time"]) if timelapse else 0
        table.append([r.get(c) for c in cols] + [
            stage_idx, time_idx, f"s{stage_idx}c{r['roi']}"])
    return cols + ["stage_idx", "time_idx", "roi_lab"], table


def save_nesprin2_excel(rows_all: List[dict], xls_dir: str, timelapse: bool) -> None:
    """``nesprin2_fret_perROI.{csv,xlsx}`` with the reference's column
    subset/order and the ratio mean/median time x roi matrices
    (the Nesprin2 FRET script, :1287-1326)."""
    columns, table = nesprin2_table(rows_all, timelapse)
    if not table:
        return
    os.makedirs(xls_dir, exist_ok=True)
    _write_csv(os.path.join(xls_dir, "nesprin2_fret_perROI.csv"), columns, table)
    xlsxlite.write_xlsx(os.path.join(xls_dir, "nesprin2_fret_perROI.xlsx"), {
        "per_ROI": [columns] + [list(row) for row in table],
        "ratio_mean_matrix": _pivot(columns, table, "ratio_mean"),
        "ratio_median_matrix": _pivot(columns, table, "ratio_median"),
    })
