"""The port's report writers (``report/excel.py``, ``report/xlsxlite.py``)
byte for byte against the JAX package's: the same rows give the same CSV
bytes and the same XLSX member bytes.  The rows hold NaN, +-inf, numpy
scalars, bools, ints in a float column, missing cells, strings that need
escaping or ``xml:space="preserve"``, and a pivot sheet past column 1024.

Where the port's writers already differed from the JAX package's before
they were rewritten, the port is held to its own earlier bytes, kept in
``data/report_bytes.json`` (its ``_made_by`` says from which commit).

Also: an error on a deflate thread surfaces from the writer and leaves no
file behind; the archive is laid out as ``zipfile`` lays it out, and one
that needs ZIP64 records is written by ``zipfile``; the writers count the
cell texts they make and reuse."""

import hashlib
import json
import os
import sys
import threading
import time
import zipfile

import numpy as np
import pytest

from imageprocess_tpu.report import excel as jexcel
from imageprocess_tpu_torch.report import excel as texcel
from imageprocess_tpu_torch.report import xlsxlite as txlsx

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "report_bytes.json")
NAN, INF = float("nan"), float("inf")
ODD = ['a<b&"c"\x08', " lead", "trail ", "한국어", "x,y", 'q"uote', "line\nbreak"]


def _intensity_rows(timelapse: bool):
    rows = []
    times = ("t00", "t01", "t02") if timelapse else (None,)
    k = 0
    for s in (1, 2, 10):
        for t_code in times:
            for roi in (1, 2):
                if timelapse and (s, t_code, roi) == (2, "t01", 2):
                    continue            # a pivot cell with no row
                row = {"stage": f"S{s:02d}", "time": t_code, "roi": roi,
                       "area_px": np.int64(900 + k) if k % 3 == 0 else 900 + k,
                       "bg_mode": "percentile", "bg_scope": " full" if k == 1 else "full",
                       "clip_neg": [True, False, np.bool_(True)][k % 3], "bg_stride": 4}
                for ch in (2, 3):
                    if ch == 3 and k == 4:
                        continue        # a key without its channel: missing cells
                    row.update({
                        f"ch{ch}_mean": [12.5 + k / 7, NAN, INF, -INF][k % 4] if k < 8 else 0.1 * k,
                        f"ch{ch}_median": np.float64(3.25 * k) if k % 2 else float(k),
                        f"ch{ch}_std": 1e-300 * k,
                        f"ch{ch}_npx": 100 + k,
                        f"ch{ch}_bg": 101.0 + k,
                        f"ch{ch}_p": 1 if k == 2 else 1.0,      # an int in a float column
                        f"ch{ch}_color": ODD[k % len(ODD)]})
                rows.append(row)
                k += 1
    return rows


def _fret_rows(n2: bool, timelapse: bool, wide: bool = False):
    rows = []
    times = ("t00", "t03") if timelapse else (None,)
    n_roi = 1030 if wide else 3
    k = 0
    for s in ((1,) if wide else (1, 2)):
        for t_code in times:
            for roi in range(1, n_roi + 1):
                exotic = not wide or roi <= 8
                row = {"stage": f"S{s:02d}", "time": t_code, "roi": roi,
                       "area_px": 500 + k,
                       "ratio_mean": ([NAN, INF, 0.25, -INF][k % 4] if exotic else 1.0 + roi / 3),
                       "ratio_median": np.float64(k / 9) if exotic else roi / 7,
                       "ratio_std": 0.5, "ratio_p5": 0.1 * k, "ratio_p95": 2.0,
                       "donor_mean": 300.0 + k, "eps": 5 if k % 2 else 5.0,
                       "p": 1.0, "ratio_mode": "FRET/Donor" if k % 3 else " FRET ",
                       "bg_mode": ODD[k % len(ODD)] if exotic else "percentile",
                       "bg_scope": "full", "clip_neg": bool(k % 2)}
                if n2:
                    row.update({"ratio_FoverD_mean": 1.5, "ratio_DoverF_mean": 0.75,
                                "fret_mean": 200.0 + k, "donor_p": 1.0, "fret_p": 1.0,
                                "sat_filter_on": np.bool_(k % 2), "sat_threshold": 65535,
                                "clip_ratio_on": False, "clip_ratio_max": 10.0})
                else:
                    row.update({"donor_median": 299.5, "yfret_mean": 150.0 + k,
                                "yfret_median": None if k == 1 else 149.0})
                rows.append(row)
                k += 1
    return rows


def _plain_intensity_rows(stages=16, rois=18):
    """Rows as the batched runner makes them: nothing to escape or quote."""
    return [{"stage": f"S{s:02d}", "time": None, "roi": roi, "area_px": 900 + roi,
             "bg_mode": "percentile", "bg_scope": "full", "clip_neg": True, "bg_stride": 4,
             **{f"ch{ch}_{f}": roi / 7 + s * ch for ch in (2, 3)
                for f in ("mean", "median", "std", "bg")},
             **{f"ch{ch}_npx": 900 + roi for ch in (2, 3)},
             **{f"ch{ch}_color": "Grayscale" for ch in (2, 3)}}
            for s in range(1, stages + 1) for roi in range(1, rois + 1)]


def _plain_fret_rows():
    return [{"stage": f"S{s:02d}", "time": None, "roi": roi, "area_px": 500 + roi,
             **{k: roi / 9 + s for k in ("ratio_mean", "ratio_median", "ratio_std", "donor_mean",
                                         "yfret_mean", "eps")},
             "p": 1.0, "ratio_mode": "FRET/Donor", "bg_mode": "percentile"}
            for s in range(1, 4) for roi in range(1, 7)]


def _keymap(rows):
    return {(r["stage"], r["time"]): None for r in rows}


CASES = {
    "intensity": lambda: ("fluor_intensity_perROI", lambda m, d: m.save_intensity_excel(
        _intensity_rows(False), _keymap(_intensity_rows(False)), d)),
    "intensity_timelapse": lambda: ("fluor_intensity_perROI", lambda m, d: m.save_intensity_excel(
        _intensity_rows(True), _keymap(_intensity_rows(True)), d)),
    "intensity_plain": lambda: ("fluor_intensity_perROI", lambda m, d: m.save_intensity_excel(
        _plain_intensity_rows(3, 4), _keymap(_plain_intensity_rows(3, 4)), d)),
    "fret_plain": lambda: ("fret_ratio_perROI", lambda m, d: m.save_fret_excel(
        _plain_fret_rows(), d, False)),
    "fret": lambda: ("fret_ratio_perROI", lambda m, d: m.save_fret_excel(
        _fret_rows(False, False), d, False)),
    "fret_timelapse": lambda: ("fret_ratio_perROI", lambda m, d: m.save_fret_excel(
        _fret_rows(False, True), d, True)),
    "fret_wide": lambda: ("fret_ratio_perROI", lambda m, d: m.save_fret_excel(
        _fret_rows(False, False, wide=True), d, False)),
    "nesprin2": lambda: ("nesprin2_fret_perROI", lambda m, d: m.save_nesprin2_excel(
        _fret_rows(True, False), d, False)),
    "nesprin2_timelapse": lambda: ("nesprin2_fret_perROI", lambda m, d: m.save_nesprin2_excel(
        _fret_rows(True, True), d, True)),
}


def _files(stem, save, module, out):
    os.makedirs(out, exist_ok=True)
    save(module, str(out))
    with open(os.path.join(out, stem + ".csv"), "rb") as f:
        files = {"csv": f.read()}
    with zipfile.ZipFile(os.path.join(out, stem + ".xlsx")) as z:
        files.update({n: z.read(n) for n in z.namelist()})
    return files


def _digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("case", list(CASES))
def test_report_bytes_equal_jax(case, tmp_path):
    stem, save = CASES[case]()
    port = _files(stem, save, texcel, tmp_path / "port")
    jax = _files(stem, save, jexcel, tmp_path / "jax")
    with open(DATA) as f:
        earlier = json.load(f).get(case, {})
    assert list(port) == list(jax)
    for name in port:
        want = earlier.get(name, _digest(jax[name]))
        assert _digest(port[name]) == want, name


@pytest.mark.parametrize("case", ["intensity", "intensity_timelapse", "fret_wide"])
def test_a_sheet_made_ahead_iterates_as_the_rows_it_shows(case, tmp_path, monkeypatch):
    """A sheet ``save_*`` makes ahead (an ``xlsxlite.Member``) gives back
    rows of values that the plain writer turns into the same XML, so
    that a caller that edits the rows of ``write_xlsx``'s sheets sees
    them."""
    stem, save = CASES[case]()
    seen = {}
    real = txlsx.write_xlsx

    def write(path, sheets):
        seen.update(sheets)
        real(path, sheets)

    monkeypatch.setattr(txlsx, "write_xlsx", write)
    save(texcel, str(tmp_path))
    assert seen and all(isinstance(m, txlsx.Member) for m in seen.values())
    for name, member in seen.items():
        assert txlsx._sheet_xml(list(member)).encode() == member.data, name


def _book():
    wide = [["time_idx"] + [f"s1c{i}" for i in range(1, 1031)],
            [0] + [i / 7 for i in range(1, 1031)]]
    return {"per_ROI": [["stage", "x", "n", "note"]] + [
        [f"S{i:02d}", i / 3, i, " pad" if i % 5 == 0 else "a&b"] for i in range(1, 1500)],
        "wide": wide, "empty": [], "ragged": [[1], [], [2.5, None, "x"]]}


def test_the_archive_equals_zipfiles_byte_for_byte(tmp_path, monkeypatch):
    """At one clock reading the whole file, headers and central directory
    too, is the one the JAX package writes with ``zipfile``; a sheet of
    ``THREADED`` bytes or more was deflated on a thread."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    book = _book()
    sizes = {n: len(txlsx._sheet_xml(rows).encode()) for n, rows in book.items()}
    assert sizes["per_ROI"] >= txlsx.THREADED > sizes["ragged"]
    a, b = str(tmp_path / "port.xlsx"), str(tmp_path / "jax.xlsx")
    txlsx.write_xlsx(a, book)
    from imageprocess_tpu.report import xlsxlite as jxlsx
    jxlsx.write_xlsx(b, book)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert sorted(os.listdir(tmp_path)) == ["jax.xlsx", "port.xlsx"]


def test_an_archive_that_needs_zip64_is_written_by_zipfile(tmp_path, monkeypatch):
    """Past the limit of plain ZIP records the archive is written by
    ``zipfile`` from the members' bytes: at one clock reading, the file
    the JAX package writes."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    monkeypatch.setattr(txlsx, "_LIMIT", 4096)
    laid = []
    real = txlsx._zip_bytes
    monkeypatch.setattr(txlsx, "_zip_bytes", lambda members: laid.append(real(members)) or laid[-1])
    book = _book()
    a, b = str(tmp_path / "port.xlsx"), str(tmp_path / "jax.xlsx")
    txlsx.write_xlsx(a, book)
    from imageprocess_tpu.report import xlsxlite as jxlsx
    jxlsx.write_xlsx(b, book)
    assert laid == [None]
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert sorted(os.listdir(tmp_path)) == ["jax.xlsx", "port.xlsx"]


@pytest.mark.parametrize("threaded", [True, False])
def test_an_error_deflating_a_member_surfaces_and_leaves_no_file(threaded, tmp_path, monkeypatch):
    """A member that cannot be deflated, on a thread of its own or inline:
    the error comes out of ``save_intensity_excel``, neither the workbook
    nor the CSV (nor their temporary files) is left, and the next call
    writes both."""
    monkeypatch.setattr(txlsx, "THREADED", 0 if threaded else 1 << 40)
    real = txlsx._deflate

    def deflate(data):
        if b"<worksheet" in data:
            raise OSError("member not writable")
        return real(data)

    monkeypatch.setattr(txlsx, "_deflate", deflate)
    rows = _intensity_rows(False)
    path = tmp_path / "fluor_intensity_perROI.xlsx"
    with pytest.raises(OSError, match="member not writable"):
        texcel.save_intensity_excel(rows, _keymap(rows), str(tmp_path))
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(txlsx, "_deflate", real)
    texcel.save_intensity_excel(rows, _keymap(rows), str(tmp_path))
    assert list(txlsx.read_xlsx(str(path))) == ["per_ROI", "ch2", "ch3"]
    assert sorted(os.listdir(tmp_path)) == ["fluor_intensity_perROI.csv", path.name]


def test_the_writer_counts_texts_made_and_reused(tmp_path):
    """Each cell's text is made once: the channel sheets and the CSV
    reuse the per_ROI sheet's; only sheets of ``THREADED`` bytes or more
    count as deflated off the calling thread."""
    rows = _plain_intensity_rows()
    counts = texcel.save_intensity_excel(rows, _keymap(rows), str(tmp_path))
    assert list(counts) == list(texcel.XLS_COUNTERS)
    made, reused, kb = counts.values()
    n, m = len(rows), len(texcel.intensity_table(rows)[0])
    assert n * m < made < 1.2 * n * m
    assert reused > 1.5 * made
    with zipfile.ZipFile(tmp_path / "fluor_intensity_perROI.xlsx") as z:
        sizes = [z.getinfo(f"xl/worksheets/sheet{i}.xml").file_size for i in (1, 2, 3)]
    assert kb == round(sum(s for s in sizes if s >= txlsx.THREADED) / 1024) > 0


def test_column_references_past_any_table():
    from imageprocess_tpu.report.xlsxlite import _col_ref
    refs = txlsx._col_refs(20000)
    assert refs[:3] == ["A", "B", "C"] and refs[25:28] == ["Z", "AA", "AB"]
    assert refs[701:703] == ["ZZ", "AAA"] and refs[2000] == "BXY"
    assert all(refs[i] == _col_ref(i) for i in (1023, 1024, 16383, 18277, 18278, 19999))


def test_writers_on_many_threads_each_write_their_own_workbook(tmp_path, monkeypatch):
    """Sixteen threads write a workbook each at once, every member on a
    deflate thread of its own and the interpreter switching threads as
    often as it can: each file holds its own sheet."""
    monkeypatch.setattr(txlsx, "THREADED", 0)
    books = [{"s": [["k", "v"]] + [[i, j / 3] for j in range(200)]} for i in range(16)]
    paths = [str(tmp_path / f"{i}.xlsx") for i in range(16)]
    threads = [threading.Thread(target=txlsx.write_xlsx, args=(p, b))
               for p, b in zip(paths, books)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    for p, b in zip(paths, books):
        with zipfile.ZipFile(p) as z:
            assert z.read("xl/worksheets/sheet1.xml") == txlsx._sheet_xml(b["s"]).encode()
