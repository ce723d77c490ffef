"""Port parity: the focal-adhesion workload
(``imageprocess_tpu_torch.pipelines.fa``) against the JAX package on the
CPU, on the same synthetic frames and ROI files (the shapes of
``tests/test_fa.py``, so JAX compiles each program once).

Bars.  Global statistics (mean, deviation, threshold): 1e-6 relative (the
port accumulates the two sums in float64, XLA in float32 in its own
order); bg is an order statistic of the same sample: 1e-6 too.  The
per-cell chain with the threshold passed in, and end to end on u16 frames
(integer pixels against a non-integer threshold): rows, cells, categories,
areas and label images equal; means and centroids 1e-5 relative (float64
accumulation rounded once against sequential float32 sums).  The port's
batched runner against its serial runner: every cell of every CSV equal."""

import csv
import math
import os

import numpy as np
import pytest
import torch

from imageprocess_tpu.core import roiio, tiffio

try:  # needs pandas, which a machine with a card may lack: there only the
    from imageprocess_tpu.pipelines import fa as jfa  # ``cuda`` test runs
except ImportError:
    jfa = None
from imageprocess_tpu_torch.pipelines import fa as tfa
from imageprocess_tpu_torch.report.xlsxlite import read_xlsx

CFG = dict(channel=0, alpha=2.0, min_area_um=0.5, max_area_um=5.0)
QUIET = dict(log=lambda *_: None)


def _synthetic_cell_image(seed=0, shape=(256, 320)):
    """The frame of tests/test_fa.py: bright FA-like blobs inside a cell
    polygon."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = rng.normal(500, 30, shape)
    yy, xx = np.mgrid[0:H, 0:W]
    for cy, cx in [(60, 80), (90, 150), (150, 200), (180, 90), (120, 250),
                   (70, 220), (160, 150)]:
        r = rng.integers(3, 8)
        img += 4000.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    poly = np.array([[30, 30], [300, 40], [290, 200], [150, 240], [40, 210]],
                    float)  # [x, y]
    return img.astype(np.float32), [poly]


# two cells that fit a 160-px tile (the one polygon of tests/test_fa.py is
# wider than the frame's short side, so it never reaches the batched step)
CELLS = [np.array([[40.5, 35.5], [180.5, 40.5], [175.5, 115.5], [45.5, 110.5]]),
         np.array([[130.5, 100.5], [270.5, 105.5], [265.5, 225.5], [135.5, 220.5]])]


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """Five u16 stages (the frames of tests/test_fa.py) with two cells
    each."""
    root = tmp_path_factory.mktemp("fa")
    img_dir, roi_dir = root / "imgs", root / "roi"
    img_dir.mkdir()
    roi_dir.mkdir()
    for s in range(1, 6):
        img, _ = _synthetic_cell_image(s)
        tiffio.write_tiff16(str(img_dir / f"S{s:02d}_0.tif"), img.astype(np.uint16))
        roiio.save_roi_bundle(str(roi_dir / f"S{s:02d}.json"), f"S{s:02d}",
                              img.shape, CELLS)
    return img_dir, roi_dir


@pytest.fixture(scope="module")
def runs(experiment, tmp_path_factory):
    """The JAX serial run and the port's serial and batched runs."""
    img_dir, roi_dir = experiment
    out = tmp_path_factory.mktemp("fa_out")
    args = (str(img_dir), str(roi_dir))
    j = jfa.run_fa_batch(*args, str(out / "j"), jfa.FaConfig(**CFG), **QUIET)
    t1 = tfa.run_fa_batch(*args, str(out / "t1"), tfa.FaConfig(**CFG),
                          device="cpu", **QUIET)
    chunks, real = [], tfa.fa_batched_step
    tfa.fa_batched_step = lambda imgs, *a, **k: (
        chunks.append(tuple(imgs.shape)), real(imgs, *a, **k))[1]
    try:
        t2 = tfa.run_fa_batched(*args, str(out / "t2"), tfa.FaConfig(**CFG),
                                batch_size=2, device="cpu", **QUIET)
    finally:
        tfa.fa_batched_step = real
    # every stage went through the batched step: chunks of 2, 2 and 1 frames
    assert chunks == [(2, 256, 320), (2, 256, 320), (1, 256, 320)]
    return out, j, t1, t2


def _read_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.reader(f))


def _cells_close(a: str, b: str, rtol: float) -> bool:
    if a == b:
        return True
    try:
        x, y = float(a), float(b)
    except ValueError:
        return False
    return "." in a and "." in b and abs(x - y) <= rtol * max(abs(y), 1e-9)


def _assert_csv_match(tpath, jpath, rtol=1e-5):
    t, j = _read_csv(tpath), _read_csv(jpath)
    assert t[0] == j[0] == tfa.FA_CSV_COLS
    assert len(t) == len(j) > 1
    for rt, rj in zip(t[1:], j[1:]):
        for name, a, b in zip(t[0], rt, rj):
            if name in ("File", "Cell_ID", "Category", "Area_px",
                        "Close_Radius_Setting", "Subtract_BG_Setting"):
                assert a == b, (name, a, b)
            else:
                assert _cells_close(a, b, rtol), (name, a, b)


def test_config_and_columns_match_jax():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jfa.FaConfig)}
    assert {f.name: f.default for f in dataclasses.fields(tfa.FaConfig)} == jf
    assert tfa.FA_CSV_COLS == jfa.FA_CSV_COLS
    for kw in ({}, {"px_size": 0.223, "min_area_um": 0.7}):
        assert tfa.FaConfig(**kw).min_px == jfa.FaConfig(**kw).min_px
        assert tfa.FaConfig(**kw).max_px == jfa.FaConfig(**kw).max_px


def _frames():
    img, _ = _synthetic_cell_image(3)
    with_nan = img.copy()
    with_nan[::7, ::5] = np.nan
    with_nan[40, :] = np.inf
    return {"u16": img.astype(np.uint16), "float32": img, "float32_nan": with_nan,
            "u8": (img / 20).clip(0, 255).astype(np.uint8)}


@pytest.mark.parametrize("kind", sorted(_frames()))
def test_global_stats_match_jax(kind):
    img = _frames()[kind]
    want = [float(v) for v in jfa.fa_global_stats(img)]
    got = [float(v) for v in tfa.fa_global_stats(img, "cpu")]
    for name, g, w in zip(("mean", "std", "bg"), got, want):
        assert abs(g - w) <= 1e-6 * abs(w), (name, g, w)
    # float64 numpy: the port's sums are rounded once
    fin = np.isfinite(img.astype(np.float32))
    x = img.astype(np.float64)[fin]
    assert abs(got[0] - x.mean()) <= 2e-7 * abs(x.mean())
    assert abs(got[1] - x.std()) <= 1e-6 * x.std()
    sample = img[::10, ::10].astype(np.float64)
    assert abs(got[2] - np.percentile(sample[np.isfinite(sample)], 1.0)) \
        <= 1e-6 * abs(got[2])


def test_global_stats_of_a_stack_equal_each_frame():
    """A chunk's statistics do not depend on how many frames it holds."""
    frames = np.stack([_synthetic_cell_image(s)[0] for s in (0, 1, 2)])
    frames[1, 5, 5] = np.nan
    m, s, bg = tfa._global_stats_body(torch.from_numpy(frames))
    assert m.shape == s.shape == bg.shape == (3,)
    for i in range(3):
        one = tfa._global_stats_body(torch.from_numpy(frames[i]))
        assert [float(v) for v in one] == [float(m[i]), float(s[i]), float(bg[i])]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("close_radius", [0, 1, 2])
def test_analyze_image_matches_jax(seed, close_radius):
    """The per-cell chain with the statistics passed in: the same threshold
    reaches both, so the masks, labels and rows are the same."""
    img, rois = _synthetic_cell_image(seed)
    rois = rois + [np.array([[200.5, 150.5], [310.5, 160.5], [305.5, 250.5],
                             [210.5, 240.5]])]
    kw = dict(alpha=2.0, min_area_um=0.5, max_area_um=5.0,
              close_radius=close_radius, px_size=0.112)
    stats = tuple(float(v) for v in jfa.fa_global_stats(img))
    jrows, jthr, jbg, jex = jfa.analyze_image(img, rois, jfa.FaConfig(**kw), stats=stats)
    trows, tthr, tbg, tex = tfa.analyze_image(img, rois, tfa.FaConfig(**kw),
                                              stats=stats, device="cpu")
    assert (tthr, tbg) == (jthr, jbg)
    assert tex["tile"] == jex["tile"]
    assert np.array_equal(tex["offsets"], jex["offsets"])
    assert tex["labels"].dtype == np.int32
    assert np.array_equal(tex["labels"], np.asarray(jex["labels"]))
    assert len(trows) == len(jrows) > 0
    assert {r["cell"] for r in trows} == {1, 2}
    for a, b in zip(trows, jrows):
        assert list(a) == list(b)
        for k in ("cell", "label", "category", "area", "bg_level"):
            assert a[k] == b[k], k
        for k in ("mean_int_raw", "mean_int_corr", "int_den_raw", "int_den_corr"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), k
        for x, y in zip(a["centroid"], b["centroid"]):
            assert abs(x - y) <= 1e-5 * abs(y)
    # end to end (the port's own statistics): the same rows on this frame
    own, thr, bg, _ = tfa.analyze_image(img, rois, tfa.FaConfig(**kw), device="cpu")
    assert abs(thr - jthr) <= 1e-6 * jthr and abs(bg - jbg) <= 1e-6 * abs(jbg)
    assert [(r["cell"], r["area"]) for r in own] == [(r["cell"], r["area"])
                                                     for r in jrows]


def test_overflow_raises_and_no_rois_give_no_rows():
    img, rois = _synthetic_cell_image(0)
    cfg = tfa.FaConfig(alpha=2.0, min_area_um=0.5, max_area_um=5.0,
                       max_fa_per_cell=2)
    with pytest.raises(ValueError, match="max_fa_per_cell=2"):
        tfa.analyze_image(img, rois, cfg, device="cpu")
    rows, thr, bg, extras = tfa.analyze_image(img, [], cfg, device="cpu")
    assert rows == [] and extras == {} and math.isfinite(thr) and math.isfinite(bg)


def test_roi_larger_than_the_frame_takes_the_largest_tile():
    """choose_tile gives None for an ROI wider than the short side: the
    tile is then min(H, W), as in the JAX function."""
    img, _ = _synthetic_cell_image(1)
    roi = [np.array([[2.5, 2.5], [317.5, 2.5], [317.5, 253.5], [2.5, 253.5]])]
    kw = dict(alpha=2.0, min_area_um=0.5, max_area_um=5.0)
    stats = tuple(float(v) for v in jfa.fa_global_stats(img))
    jrows, _, _, jex = jfa.analyze_image(img, roi, jfa.FaConfig(**kw), stats=stats)
    trows, _, _, tex = tfa.analyze_image(img, roi, tfa.FaConfig(**kw), stats=stats,
                                         device="cpu")
    assert tex["tile"] == jex["tile"] == 256
    assert np.array_equal(tex["labels"], np.asarray(jex["labels"]))
    assert [r["area"] for r in trows] == [r["area"] for r in jrows]


def test_batched_step_layout_matches_jax():
    """fa_batched_step's flat (B, K) array, field by field, against the JAX
    step on the same chunk; unpack_fa_flat splits both the same way."""
    import jax.numpy as jnp

    from imageprocess_tpu_torch.ops.roistats import (
        choose_tile, pad_local_polys, tile_offsets,
    )

    frames, lps, offs, vals = [], [], [], []
    for s in (1, 2):
        img, rois = _synthetic_cell_image(s)[0], CELLS
        frames.append(img.astype(np.uint16))
        tile = choose_tile(rois, *img.shape, margin=2)
        o = tile_offsets(rois, *img.shape, tile, margin=2)
        lp, op, valid = pad_local_polys(rois, o, 8, 32)
        lps.append(lp), offs.append(op), vals.append(valid)
    frames, lps, offs, vals = (np.stack(a) for a in (frames, lps, offs, vals))
    cfg = tfa.FaConfig(**CFG)
    kw = dict(tile=tile, close_radius=1, max_labels=16, do_remove_small=True)
    want = np.asarray(jfa.fa_batched_step(
        jnp.asarray(frames), jnp.asarray(lps), jnp.asarray(offs), jnp.asarray(vals),
        jnp.float32(cfg.alpha), jnp.float32(cfg.min_px), **kw))
    got = tfa.fa_batched_step(
        torch.from_numpy(frames), torch.from_numpy(lps), torch.from_numpy(offs),
        torch.from_numpy(vals), cfg.alpha, cfg.min_px, **kw).numpy()
    assert got.shape == want.shape == (2, 5 * 8 * 16 + 5) and got.dtype == np.float32
    gp, gn, gs, go = tfa.unpack_fa_flat(got, 8, 16)
    wp, wn, ws, wo = jfa.unpack_fa_flat(want, 8, 16)
    assert np.array_equal(gn, wn) and gn[:, :2].min() > 0 and not gn[:, 2:].any()
    assert np.array_equal(go, wo) and not go.any()
    assert np.array_equal(gp["area"], wp["area"])
    for f in ("mean", "centroid_r", "centroid_c"):
        np.testing.assert_allclose(gp[f], wp[f], rtol=1e-5, atol=0, err_msg=f)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)


def test_runs_match_jax_and_each_other(runs):
    out, j, t1, t2 = runs
    assert sorted(t1) == sorted(t2) == sorted(j) == [f"S{s:02d}" for s in range(1, 6)]
    assert t1 == t2                       # batched == serial, every value
    for tag, rows in t1.items():
        assert all(list(r) == tfa.FA_CSV_COLS for r in rows)
        assert len(rows) == len(j[tag])
        name = os.path.join("individual_results", f"{tag}_results.csv")
        assert (out / "t1" / name).read_bytes() == (out / "t2" / name).read_bytes()
        _assert_csv_match(out / "t1" / name, out / "j" / name)
        # the returned rows are the CSV's
        back = tfa.read_fa_csv(str(out / "t1" / name))[1]
        assert back == [[r[c] for c in tfa.FA_CSV_COLS] for r in rows]
        assert {r["Category"] for r in rows} <= {"OK", "Large", "Small"}
        assert rows[0]["Area_px"] == float(j[tag]["Area_px"].iloc[0])


def _sorted_all_data(sheet):
    head, body = sheet[0], sheet[1:]
    keyed = [(row[head.index("File")], row[head.index("Cell_ID")], i, row)
             for i, row in enumerate(body)]
    by_file = {}
    for f, c, i, row in keyed:       # row order inside a file is kept
        by_file.setdefault(f, []).append(row)
    return head, [row for f in sorted(by_file) for row in by_file[f]]


def test_master_workbook_matches_jax(runs):
    out, *_ = runs
    sheets = {k: read_xlsx(str(out / k / "FA_Results_Master.xlsx"))
              for k in ("j", "t1", "t2")}
    assert list(sheets["t1"]) == list(sheets["j"]) == [
        "File_Summary", "Cell_Summary", "All_Data"]
    for name in ("File_Summary", "Cell_Summary"):
        assert sheets["t1"][name] == sheets["t2"][name] == sheets["j"][name]
    assert sheets["t1"]["File_Summary"][0][:4] == ["File", "OK", "Large", "Small"]
    jh, jb = _sorted_all_data(sheets["j"]["All_Data"])
    for side in ("t1", "t2"):
        th, tb = _sorted_all_data(sheets[side]["All_Data"])
        assert th == jh and len(tb) == len(jb) > 20
        for rt, rj in zip(tb, jb):
            for name, a, b in zip(th, rt, rj):
                if isinstance(b, float) and not float(b).is_integer():
                    assert abs(a - b) <= 1e-5 * abs(b), name
                else:
                    assert a == b and type(a) is type(b), (name, a, b)


def test_merge_report_rounds_and_counts(tmp_path):
    """Three files with uneven categories: counts per file and per cell,
    the averages rounded half to even as ``DataFrame.round(2)`` does."""
    indiv = tmp_path / "individual_results"
    indiv.mkdir()
    cfg = tfa.FaConfig(**CFG)
    cats = {"S01": [(1, 200.0)] * 3 + [(2, 10.0)] * 2 + [(3, 900.0)] * 2,
            "S02": [(1, 200.0)], "S03": [(1, 10.0), (2, 10.0), (4, 200.0)]}
    results = {}
    for tag, fas in cats.items():
        tfa._write_stage(str(indiv), tag, tfa._fa_file_rows(
            tag, ((c, a, 1000.0) for c, a in fas), 1200.0, 400.0, cfg), results)
    import pandas as pd

    jfull = jfa.merge_fa_report(str(tmp_path), "j.xlsx", **QUIET)
    tfull = tfa.merge_fa_report(str(tmp_path), "t.xlsx", **QUIET)
    assert isinstance(jfull, pd.DataFrame) and len(tfull) == len(jfull) + 1
    sj, st = read_xlsx(str(tmp_path / "j.xlsx")), read_xlsx(str(tmp_path / "t.xlsx"))
    assert st["File_Summary"] == sj["File_Summary"]
    assert st["Cell_Summary"] == sj["Cell_Summary"]
    assert st["File_Summary"][1] == ["S01", 3, 2, 2, 7, 3, 2.33, 1]
    assert tfa.merge_fa_report(str(tmp_path / "nothing"), **QUIET) is None


def test_save_ok_only(experiment, tmp_path):
    img_dir, roi_dir = experiment
    kw = dict(CFG, max_area_um=3.0, save_ok_only=True)   # 239 px: many are Large
    j = jfa.run_fa_batch(str(img_dir), str(roi_dir), str(tmp_path / "j"),
                         jfa.FaConfig(**kw), **QUIET)
    t = tfa.run_fa_batched(str(img_dir), str(roi_dir), str(tmp_path / "t"),
                           tfa.FaConfig(**kw), batch_size=4, device="cpu", **QUIET)
    assert sorted(t) == sorted(j)
    assert t and all(r["Category"] == "OK" for rows in t.values() for r in rows)
    for tag in t:
        assert [r["Area_px"] for r in t[tag]] == list(j[tag]["Area_px"])
    full = tfa.run_fa_batch(str(img_dir), str(roi_dir), str(tmp_path / "full"),
                            tfa.FaConfig(**dict(kw, save_ok_only=False)),
                            device="cpu", **QUIET)
    assert sum(map(len, full.values())) > sum(map(len, t.values()))


def test_cell_overrides_match_jax():
    img, rois = _synthetic_cell_image(0)
    rois = rois + [rois[0] + np.array([5.0, 5.0])]  # two cells
    base = dict(alpha=2.0, min_area_um=0.5, max_area_um=5.0)
    settings = {1: {"alpha": 6.0, "close_radius": 2, "subtract_bg": False}}
    jr, jt, jbg = jfa.analyze_image_with_overrides(
        img.astype(np.uint16), rois, jfa.FaConfig(**base), cell_settings=settings)
    tr, tt, tbg = tfa.analyze_image_with_overrides(
        img.astype(np.uint16), rois, tfa.FaConfig(**base), cell_settings=settings,
        device="cpu")
    assert sorted(tt) == [0, 1] and tt[1] > tt[0]
    assert abs(tbg - jbg) <= 1e-6 * jbg
    for i in tt:
        assert abs(tt[i] - jt[i]) <= 1e-6 * jt[i]
    assert [(r["cell"], r["category"], r["area"]) for r in tr] == \
        [(r["cell"], r["category"], r["area"]) for r in jr]
    cell2 = [r for r in tr if r["cell"] == 2]
    assert cell2 and all(r["mean_int_corr"] == r["mean_int_raw"] for r in cell2)


def test_restore_cell_settings_round_trip(tmp_path):
    """The settings written by a run come back, ``Subtract_BG_Setting=False``
    included (the column is parsed: ``bool("False")`` is True)."""
    indiv = tmp_path / "individual_results"
    indiv.mkdir()
    results = {}
    rows = []
    for cell, kw in ((1, dict(alpha=2.5, subtract_bg=False, close_radius=0)),
                     (3, dict(alpha=4.0, min_area_um=0.25, max_area_um=12.5))):
        cfg = tfa.FaConfig(**kw)
        rows += tfa._fa_file_rows("S07", [(cell, 150.0, 900.0), (cell, 20.0, 800.0)],
                                  1234.5, 400.25, cfg)
    tfa._write_stage(str(indiv), "S07", rows, results)
    got = tfa.restore_cell_settings(str(tmp_path), "S07")
    assert got == {
        0: {"alpha": 2.5, "min_area_um": 1.5, "max_area_um": 30.0,
            "close_radius": 0, "subtract_bg": False},
        2: {"alpha": 4.0, "min_area_um": 0.25, "max_area_um": 12.5,
            "close_radius": 1, "subtract_bg": True}}
    assert got == jfa.restore_cell_settings(str(tmp_path), "S07")
    assert all(type(v["subtract_bg"]) is bool and type(v["close_radius"]) is int
               for v in got.values())
    assert tfa.restore_cell_settings(str(tmp_path), "S99") == {}
    (indiv / "S08_results.csv").write_text("")
    assert tfa.restore_cell_settings(str(tmp_path), "S08") == {}


@pytest.mark.filterwarnings("ignore:Corrupt EXIF data")
@pytest.mark.parametrize("runner", ["run_fa_batch", "run_fa_batched"])
def test_corrupt_file_is_skipped(tmp_path, runner):
    """One unreadable TIFF and one unreadable JSON log and the run goes
    on; the other stage is written and the master report runs."""
    img, rois = _synthetic_cell_image(0)
    img_dir, roi_dir = tmp_path / "imgs", tmp_path / "roi"
    img_dir.mkdir()
    roi_dir.mkdir()
    (img_dir / "S01_0.tif").write_bytes(b"II*\x00not a real tiff")
    for tag in ("S02", "S03"):
        tiffio.write_tiff16(str(img_dir / f"{tag}_0.tif"), img.astype(np.uint16))
    for tag in ("S01", "S02"):
        roiio.save_roi_bundle(str(roi_dir / f"{tag}.json"), tag, img.shape, rois)
    (roi_dir / "S03.json").write_text("{not json")
    logs = []
    results = getattr(tfa, runner)(str(img_dir), str(roi_dir), str(tmp_path / "out"),
                                   tfa.FaConfig(**CFG), log=logs.append, device="cpu")
    assert set(results) == {"S02"}
    for tag in ("S01", "S03"):
        assert any(tag in s and any(w in s for w in ("Failed", "실패", "ERROR", "오류"))
                   for s in logs), (tag, logs)
    assert (tmp_path / "out" / "individual_results" / "S02_results.csv").exists()
    assert (tmp_path / "out" / "FA_Results_Master.xlsx").exists()


def test_other_frame_shape_takes_the_serial_path_inline(experiment, tmp_path,
                                                        monkeypatch):
    """A stage of another frame shape, one whose ROI outgrows the run's
    tile and one without ROIs: the batched runner analyzes the first two
    per image, in key order, and gives the serial runner's rows."""
    img_dir, roi_dir = experiment
    new_img, new_roi = tmp_path / "imgs", tmp_path / "roi"
    new_img.mkdir()
    new_roi.mkdir()
    for s in (1, 2, 5):
        os.symlink(img_dir / f"S{s:02d}_0.tif", new_img / f"S{s:02d}_0.tif")
        os.symlink(roi_dir / f"S{s:02d}.json", new_roi / f"S{s:02d}.json")
    img, rois = _synthetic_cell_image(3, shape=(200, 336))
    tiffio.write_tiff16(str(new_img / "S03_0.tif"), img.astype(np.uint16))
    roiio.save_roi_bundle(str(new_roi / "S03.json"), "S03", img.shape,
                          [np.clip(c, 0, 195) for c in CELLS])
    img, rois = _synthetic_cell_image(4)
    tiffio.write_tiff16(str(new_img / "S04_0.tif"), img.astype(np.uint16))
    roiio.save_roi_bundle(str(new_roi / "S04.json"), "S04", img.shape,
                          [np.array([[2.5, 2.5], [317.5, 2.5], [317.5, 253.5],
                                     [2.5, 253.5]])])
    tiffio.write_tiff16(str(new_img / "S06_0.tif"), img.astype(np.uint16))
    roiio.save_roi_bundle(str(new_roi / "S06.json"), "S06", img.shape, [])
    serial_calls = []
    real = tfa.analyze_image
    monkeypatch.setattr(tfa, "analyze_image", lambda img, *a, **k: (
        serial_calls.append(img.shape), real(img, *a, **k))[1])
    t2 = tfa.run_fa_batched(str(new_img), str(new_roi), str(tmp_path / "t2"),
                            tfa.FaConfig(**CFG), batch_size=2, device="cpu", **QUIET)
    assert serial_calls == [(200, 336), (256, 320)]
    t1 = tfa.run_fa_batch(str(new_img), str(new_roi), str(tmp_path / "t1"),
                          tfa.FaConfig(**CFG), device="cpu", **QUIET)
    assert list(t2) == ["S01", "S02", "S03", "S04", "S05"]
    assert t1 == t2
    j = jfa.run_fa_batch(str(new_img), str(new_roi), str(tmp_path / "j"),
                         jfa.FaConfig(**CFG), **QUIET)
    for tag in t1:
        name = os.path.join("individual_results", f"{tag}_results.csv")
        _assert_csv_match(tmp_path / "t1" / name, tmp_path / "j" / name)


def test_batched_overflow_skips_the_stage_loudly(experiment, tmp_path):
    img_dir, roi_dir = experiment
    logs = []
    res = tfa.run_fa_batched(str(img_dir), str(roi_dir), str(tmp_path / "o"),
                             tfa.FaConfig(**dict(CFG, max_fa_per_cell=2)),
                             log=logs.append, batch_size=3, device="cpu")
    assert res == {}
    assert sum("max_fa_per_cell=2" in str(s) for s in logs) == 5
    assert not (tmp_path / "o" / "FA_Results_Master.xlsx").exists()


def test_cancel_stops_both_runners(experiment, tmp_path):
    img_dir, roi_dir = experiment
    for runner in (tfa.run_fa_batch, tfa.run_fa_batched):
        calls, logs = [], []
        res = runner(str(img_dir), str(roi_dir), str(tmp_path / runner.__name__),
                     tfa.FaConfig(**dict(CFG, do_master_report=False)),
                     log=logs.append, device="cpu",
                     cancel=lambda: len(calls) >= 2 or calls.append(1))
        assert len(res) <= 2 and tfa.t("cancelled") in logs


@pytest.mark.parametrize("what", ["mesh", "save_fa_figs", "export_fa_crops"])
def test_unported_parts_raise_naming_their_roadmap_item(tmp_path, what):
    args = (str(tmp_path), str(tmp_path), str(tmp_path / "o"), tfa.FaConfig())
    if what == "mesh":
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            tfa.run_fa_batched(*args, mesh=object(), device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="Queue 1 item 14d"):
            getattr(tfa, what)(*args)


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, rois = _synthetic_cell_image(0)
    args = (str(tmp_path), str(tmp_path), str(tmp_path / "o"), tfa.FaConfig())
    for call in (lambda: tfa.run_fa_batch(*args), lambda: tfa.run_fa_batched(*args),
                 lambda: tfa.analyze_image(img, rois, tfa.FaConfig()),
                 lambda: tfa.analyze_image_with_overrides(img, rois, tfa.FaConfig()),
                 lambda: tfa.fa_global_stats(img)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


@pytest.mark.cuda
def test_cuda_fa_runs_match_cpu(experiment, tmp_path):
    """On a card: both runners on the card against the serial runner on the
    CPU (areas, categories and counts equal, floats 1e-5 relative), and the
    batched rows equal to the serial rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    img_dir, roi_dir = experiment
    args = (str(img_dir), str(roi_dir))
    cpu = tfa.run_fa_batch(*args, str(tmp_path / "c"), tfa.FaConfig(**CFG),
                           device="cpu", **QUIET)
    card = tfa.run_fa_batch(*args, str(tmp_path / "g1"), tfa.FaConfig(**CFG),
                            device="cuda", **QUIET)
    batched = tfa.run_fa_batched(*args, str(tmp_path / "g2"), tfa.FaConfig(**CFG),
                                 batch_size=2, device="cuda", **QUIET)
    assert card == batched
    assert sorted(card) == sorted(cpu)
    for tag in cpu:
        assert len(card[tag]) == len(cpu[tag])
        for a, b in zip(card[tag], cpu[tag]):
            for k, v in b.items():
                if isinstance(v, float) and k not in ("Area_px", "Area_um2"):
                    assert abs(a[k] - v) <= 1e-5 * max(abs(v), 1e-9), (tag, k)
                else:
                    assert a[k] == v, (tag, k)
