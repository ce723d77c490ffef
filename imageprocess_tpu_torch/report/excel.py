"""The intensity, FRET and rim-FRET reports without pandas.

Port of ``imageprocess_tpu/report/excel.py::save_intensity_excel``,
``save_fret_excel`` and ``save_nesprin2_excel``: the same
``fluor_intensity_perROI.{xlsx,csv}``, ``fret_ratio_perROI.{xlsx,csv}`` and
``nesprin2_fret_perROI.{xlsx,csv}`` files, columns, column order, derived
columns (``stage_idx``, ``time_idx``, ``roi_lab``, ``roi_id``) and sheets,
written with ``xlsxlite.write_xlsx`` and the stdlib ``csv`` module.  Each
cell's text is made once, for every sheet and the CSV (``_Report``).
Cells are formatted as ``DataFrame.to_csv`` formats them: missing values and
NaN as empty fields, floats by their shortest repr, and the ints of a
numeric column that also has missing values or floats as floats.
"""

from __future__ import annotations

import contextlib
import csv
import math
import os
import re
from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple

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
# what the save_* functions count: cell texts made, cells and CSV fields
# that reuse one, and kilobytes of sheets deflated off the calling thread
XLS_COUNTERS = ("xls_cells_made", "xls_cells_reused", "xls_threaded_kb")


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _int_of(pattern: str, s: str) -> int:
    return int(re.search(pattern, s).group(1))


def _indices(pattern: str, names: List[str]) -> Dict[str, int]:
    """``_int_of(pattern, name)`` of each distinct name."""
    return {n: _int_of(pattern, n) for n in set(names)}


def intensity_table(rows_all: List[dict]) -> Tuple[List[str], List[list]]:
    """(columns, rows) of the per-ROI table: the reference's base columns,
    the per-channel columns in natural order, then the derived columns."""
    if not rows_all:
        return [], []
    seen = dict.fromkeys(chain.from_iterable(rows_all))
    dyn = sorted((c for c in seen if c not in BASE_COLS), key=naming.natural_key)
    cols = list(BASE_COLS) + dyn
    timed = any(r.get("time") is not None for r in rows_all)
    stages = _indices(r"S(\d+)", [r["stage"] for r in rows_all])
    times = _indices(r"t(\d+)", [r.get("time") or "t0" for r in rows_all]) if timed else None
    table = []
    for r in rows_all:
        stage_idx = stages[r["stage"]]
        row = list(map(r.get, cols))
        row += (stage_idx, times[r.get("time") or "t0"] if timed else 0,
                f"s{stage_idx}c{r['roi']}", f"{r['stage']}_roi{r['roi']}")
        table.append(row)
    return cols + ["stage_idx", "time_idx", "roi_lab", "roi_id"], table


def _csv_fields(values: Sequence, cells: Optional[xlsxlite.Column] = None) -> List[str]:
    """One column's CSV fields as pandas writes them; where they are the
    texts of the column's worksheet *cells*, that same list."""
    types = set(map(type, values))
    if cells is not None:
        if cells.numbers and (types == {float} or types == {int}):
            return cells.texts          # finite floats, or ints alone: repr both ways
        if types == {type(None)} or (types == {str} and cells.texts == list(values)):
            return cells.texts          # no cells; strings with nothing to escape
    as_float = (any(_missing(v) or isinstance(v, float) for v in values)
                and all(_missing(v) or (isinstance(v, (int, float))
                                        and not isinstance(v, bool))
                        for v in values))
    return ["" if _missing(v) else repr(float(v)) if as_float or isinstance(v, float)
            else str(v) for v in values]


def _write_fields(path: str, columns: Sequence[str], fields: List[List[str]],
                  n_rows: int) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*fields) if fields else [()] * n_rows)


def _write_csv(path: str, columns: List[str], table: List[list]) -> None:
    """*table* (rows as long as *columns*) as pandas' ``to_csv`` writes it."""
    _write_fields(path, columns, [_csv_fields(v) for v in zip(*table)], len(table))


class _Report:
    """The cell texts of one table, each made once (``xlsxlite.Column``)
    and shared by its worksheets and its CSV; ``made`` and ``reused``
    count the texts made and the cells and fields that reuse one.

    Each sheet is an ``xlsxlite.Member``, deflating on a thread of its own
    from the moment it is made when it is large; the CSV is written
    meanwhile (``save``)."""

    def __init__(self, columns: List[str], table: List[list]):
        self.columns, self.table = columns, table
        self.col = {c: j for j, c in enumerate(columns)}
        self.values = list(zip(*table))
        self.cells = [xlsxlite.Column.of(v) for v in self.values]
        self.made = len(table) * len(self.values)
        self.reused = 0

    def _sheet(self, header: List[str], cells, order, rows) -> xlsxlite.Member:
        self.made += len(header)
        return xlsxlite.Member(xlsxlite.sheet_xml(header, cells, order), rows)

    def per_roi(self) -> xlsxlite.Member:
        """The whole table under its header."""
        return self._sheet(self.columns, self.cells, range(len(self.table)),
                           lambda: [self.columns] + [list(r) for r in self.table])

    def listing(self, keep: List[str], order: List[int]) -> xlsxlite.Member:
        """The *keep* columns of the table rows *order*, after a "No."
        column that numbers them from 1."""
        no = [0] * len(self.table)
        for k, i in enumerate(order, 1):
            no[i] = k
        self.made += len(order)
        self.reused += len(order) * len(keep)
        cells = [xlsxlite.Column.of(no)] + [self.cells[self.col[c]] for c in keep]
        return self._sheet(["No."] + keep, cells, order, lambda: [["No."] + keep] + [
            [k] + [self.table[i][self.col[c]] for c in keep] for k, i in enumerate(order, 1)])

    def pivot(self, value: str) -> xlsxlite.Member:
        """``DataFrame.pivot(index="time_idx", columns="roi_lab",
        values=value).sort_index()`` as a sheet: a header of "time_idx" and
        the labels (the ``roi_lab`` column's texts), then a row a time of
        the *value* column's cells (none where a label has no row at that
        time); duplicate entries raise as pandas does."""
        t, lab, v = self.col["time_idx"], self.col["roi_lab"], self.col[value]
        at: Dict[int, Dict[str, int]] = {}      # time -> label -> table row
        first: Dict[str, int] = {}
        for i, row in enumerate(self.table):
            by_lab = at.setdefault(row[t], {})
            if row[lab] in by_lab:
                raise ValueError("Index contains duplicate entries, cannot reshape")
            by_lab[row[lab]] = i
            first.setdefault(row[lab], i)
        times, labs = sorted(at), sorted(first)
        cells = [[at[ti].get(lb) for lb in labs] for ti in times]
        self.made += 1 + len(times)
        self.reused += len(labs) + len(self.table)
        nan = float("nan")
        return xlsxlite.Member(
            xlsxlite.pivot_xml("time_idx", self.cells[lab], [first[lb] for lb in labs],
                               times, self.cells[v], cells),
            lambda: [["time_idx"] + labs] + [
                [ti] + [nan if i is None else self.table[i][v] for i in idx]
                for ti, idx in zip(times, cells)])

    def write_csv(self, path: str) -> None:
        """The CSV, its fields made now: the first sheet deflates already."""
        fields = [_csv_fields(v, c) for v, c in zip(self.values, self.cells)]
        shared = sum(f is c.texts for f, c in zip(fields, self.cells))
        self.made += len(self.table) * (len(fields) - shared)
        self.reused += len(self.table) * shared + len(self.columns)
        _write_fields(path, self.columns, fields, len(self.table))

    def save(self, xls_dir: str, stem: str,
             sheets: Dict[str, xlsxlite.Member]) -> Dict[str, int]:
        """``stem.csv`` and ``stem.xlsx`` in *xls_dir*: the CSV goes to a
        temporary file while the sheets deflate, and takes its name only
        once the workbook has, so a failure leaves neither new.  Returns
        the ``XLS_COUNTERS``."""
        os.makedirs(xls_dir, exist_ok=True)
        path = os.path.join(xls_dir, stem + ".csv")
        tmp = path + ".tmp"
        try:
            self.write_csv(tmp)
            xlsxlite.write_xlsx(os.path.join(xls_dir, stem + ".xlsx"), sheets)
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
        threaded = sum(len(m.data) for m in sheets.values() if m.threaded)
        return dict(zip(XLS_COUNTERS, (self.made, self.reused, round(threaded / 1024))))


def save_intensity_excel(rows_all: List[dict], keymap: Dict, xls_dir: str) -> Dict[str, int]:
    """``fluor_intensity_perROI.{xlsx,csv}`` with per-channel sheets
    (non-timelapse) or time x roi pivot matrices (timelapse).  Returns the
    writer's counts (``_Report.save``); {} without rows."""
    columns, table = intensity_table(rows_all)
    if not table:
        return {}
    rep = _Report(columns, table)
    col = rep.col
    ch_list = sorted({int(m.group(1)) for c in columns
                      if (m := _CH_MEAN.match(c))})
    sheets = {"per_ROI": rep.per_roi()}
    is_tl = any(k[1] is not None for k in keymap.keys())
    if not is_tl:
        order = sorted(range(len(table)), key=lambda i: (table[i][col["stage"]],
                                                         table[i][col["roi"]]))
        for ch in ch_list:
            keep = ["stage", "roi", "roi_id", "area_px"] + [
                c for c in columns if c.startswith(f"ch{ch}_")]
            sheets[f"ch{ch}"] = rep.listing(keep, order)
    else:
        for ch in ch_list:
            for stat in ("mean", "median"):
                sheets[f"ch{ch}_{stat}_matrix"] = rep.pivot(f"ch{ch}_{stat}")
    return rep.save(xls_dir, "fluor_intensity_perROI", sheets)


def fret_table(rows_all: List[dict], timelapse: bool) -> Tuple[List[str], List[list]]:
    """(columns, rows) of the FRET per-ROI table: the reference's column
    subset in its order, then ``time_idx``, ``stage_idx`` and ``roi_lab``."""
    if not rows_all:
        return [], []
    present = set().union(*rows_all)
    cols = [c for c in FRET_COLS if c in present]
    stages = _indices(r"S(\d+)", [r["stage"] for r in rows_all])
    times = _indices(r"t(\d+)", [r["time"] for r in rows_all]) if timelapse else None
    table = []
    for r in rows_all:
        stage_idx = stages[r["stage"]]
        row = list(map(r.get, cols))
        row += (times[r["time"]] if timelapse else 0, stage_idx, f"s{stage_idx}c{r['roi']}")
        table.append(row)
    return cols + ["time_idx", "stage_idx", "roi_lab"], table


def save_fret_excel(rows_all: List[dict], xls_dir: str, timelapse: bool) -> Dict[str, int]:
    """``fret_ratio_perROI.{xlsx,csv}`` with the reference's column
    subset/order and the ratio mean/median time x roi matrices.  Returns
    the writer's counts; {} without rows."""
    columns, table = fret_table(rows_all, timelapse)
    if not table:
        return {}
    rep = _Report(columns, table)
    sheets = {"per_ROI": rep.per_roi(), "ratio_mean_matrix": rep.pivot("ratio_mean"),
              "ratio_median_matrix": rep.pivot("ratio_median")}
    return rep.save(xls_dir, "fret_ratio_perROI", sheets)


def nesprin2_table(rows_all: List[dict], timelapse: bool) -> Tuple[List[str], List[list]]:
    """(columns, rows) of the rim-FRET per-ROI table: the reference's
    column subset in its order, then ``stage_idx``, ``time_idx`` and
    ``roi_lab``."""
    if not rows_all:
        return [], []
    present = set().union(*rows_all)
    cols = [c for c in N2_COLS if c in present]
    stages = _indices(r"S(\d+)", [r["stage"] for r in rows_all])
    times = _indices(r"t(\d+)", [r["time"] for r in rows_all]) if timelapse else None
    table = []
    for r in rows_all:
        stage_idx = stages[r["stage"]]
        row = list(map(r.get, cols))
        row += (stage_idx, times[r["time"]] if timelapse else 0, f"s{stage_idx}c{r['roi']}")
        table.append(row)
    return cols + ["stage_idx", "time_idx", "roi_lab"], table


def save_nesprin2_excel(rows_all: List[dict], xls_dir: str, timelapse: bool) -> Dict[str, int]:
    """``nesprin2_fret_perROI.{csv,xlsx}`` with the reference's column
    subset/order and the ratio mean/median time x roi matrices
    (the Nesprin2 FRET script, :1287-1326).  Returns the writer's counts;
    {} without rows."""
    columns, table = nesprin2_table(rows_all, timelapse)
    if not table:
        return {}
    rep = _Report(columns, table)
    sheets = {"per_ROI": rep.per_roi(), "ratio_mean_matrix": rep.pivot("ratio_mean"),
              "ratio_median_matrix": rep.pivot("ratio_median")}
    return rep.save(xls_dir, "nesprin2_fret_perROI", sheets)
