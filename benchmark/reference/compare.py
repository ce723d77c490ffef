"""The comparison that decides ``correct``: the program's rows against the
reference's, field by field."""

from __future__ import annotations

import csv
import math
import re

import numpy as np


def table(rows) -> dict:
    """{(stage, roi): row} of the program's row dicts."""
    return {(r["stage"], int(r["roi"])): r for r in rows}


def read_csv(path: str) -> dict:
    """The program's CSV as {(stage, roi): {column: text}}."""
    with open(path, newline="", encoding="utf-8") as f:
        return {(r["stage"], int(float(r["roi"]))): r for r in csv.DictReader(f)}


def sheet_table(rows) -> dict:
    """A sheet with a header row and one row per ROI (``stage`` and
    ``roi`` columns) as {(stage, roi): {column: value}}."""
    if not rows or "stage" not in rows[0] or "roi" not in rows[0]:
        return {}
    head = rows[0]
    out = {}
    for r in rows[1:]:
        d = dict(zip(head, r))
        try:
            out[(d["stage"], int(float(d["roi"])))] = d
        except (TypeError, ValueError):
            out[("unreadable", len(out))] = d
    return out


def pivot_label(stage: str, roi: int) -> str:
    """The reference's pivot column of a ROI: ``s{stage number}c{roi}``."""
    return f"s{int(re.search(r'[0-9]+', stage).group())}c{roi}"


def pivot_table(rows, value: str, keys) -> dict:
    """A ``time_idx`` x ``s{stage}c{roi}`` matrix of one experiment without
    times (one data row, time 0) as {(stage, roi): {value: cell}}.  A column
    the reference does not know is kept under its own label, so that it
    counts as a row too many; another shape reads as no rows."""
    if len(rows) != 2 or not rows[0] or rows[0][0] != "time_idx" or _num(rows[1][0]) != 0:
        return {}
    key_of = {pivot_label(s, r): (s, r) for s, r in keys}
    row = list(rows[1]) + [None] * (len(rows[0]) - len(rows[1]))
    return {key_of.get(h, h): {value: v} for h, v in zip(rows[0][1:], row[1:])}


def select(fields, patterns) -> list:
    """The *fields* a sheet holds: each pattern is a field's name, a prefix
    ending in ``_``, or ``*`` for every field."""
    return [f for f in fields if any(p == "*" or p == f or (p.endswith("_") and f.startswith(p))
                                     for p in patterns)]


def _num(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def gaps(got: dict, want: dict, exact_fields, float_fields) -> dict:
    """``missing_rows``: reference rows the program lacks plus rows it has
    that the reference does not; ``exact_mismatches``: values of
    *exact_fields* (counts) that differ; ``max_rel_gap``: the widest
    |got - want| / max(|want|, floor) over *float_fields*, where a field's
    floor is a thousandth of its median |want| (so a statistic that is 0 in
    the reference is held to its column's scale); a missing or non-finite
    value counts as inf.  ``worst`` names that value."""
    floors = {}
    for f in float_fields:
        col = np.abs(np.array([w[f] for w in want.values()], np.float64))
        floors[f] = max(1e-3 * float(np.median(col)) if col.size else 0.0, 1e-30)
    missing = len(set(got) - set(want))
    exact, worst, where = 0, 0.0, None
    for k, w in want.items():
        g = got.get(k)
        if g is None:
            missing += 1
            continue
        for f in exact_fields:
            if _num(g.get(f)) != float(w[f]):
                exact += 1
        for f in float_fields:
            a, b = _num(g.get(f)), float(w[f])
            gap = abs(a - b) / max(abs(b), floors[f]) if math.isfinite(a) else math.inf
            if gap > worst or where is None:
                worst, where = gap, (k, f, a, b)
    return {"missing_rows": missing, "exact_mismatches": exact,
            "max_rel_gap": worst, "worst": where}


def merge(parts) -> dict:
    """The totals and the widest gap of several :func:`gaps` results."""
    out = {"missing_rows": 0, "exact_mismatches": 0, "max_rel_gap": 0.0, "worst": None}
    for p in parts:
        out["missing_rows"] += p["missing_rows"]
        out["exact_mismatches"] += p["exact_mismatches"]
        if p["max_rel_gap"] >= out["max_rel_gap"]:
            out["max_rel_gap"], out["worst"] = p["max_rel_gap"], p["worst"]
    return out
