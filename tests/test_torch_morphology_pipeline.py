"""Port parity of the per-ROI shape-metrics pipeline on the CPU
(``device="cpu"``): ``roi_moments_tiled``, ``morphology_rows`` and
``run_morphology`` with its CSV/XLSX, against the JAX package on the same
numpy-seeded polygons and folders.

Bars: area_px, roi, strings and integer columns exact; the vertex math
(perimeter, hull, solidity's denominator) exact; centroids, second-moment
sums and what derives from them (axes, aspect ratio, orientation,
roundness) within 1e-5 relative -- the sums run in another order; the
reports within 1e-4 relative, strings exact.

The ellipses' vertices are snapped to the half-integer lattice: there the
rasterizer's crossing sums are exact.  On arbitrary float vertices XLA's
CPU compiler contracts them into fused multiply-adds and can flip a pixel
whose centre lies within an ulp of an edge (1 of 1051 on the ellipse of
``test_morphology_rows_match_jax`` unsnapped); the port equals the eager
JAX rasterizer there.
"""

import csv
import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.core import roiio as jroiio
from imageprocess_tpu.core import tiffio as jtiffio
from imageprocess_tpu.ops import roistats as jrs
from imageprocess_tpu.pipelines import morphology as jm
from imageprocess_tpu_torch.geom.rasterize import rasterize_polygons
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
from imageprocess_tpu_torch.pipelines import morphology as tm
from imageprocess_tpu_torch.report import xlsxlite
from test_torch_tiffout import assert_pngs_match

H, W = 160, 224
RTOL = 1e-5
EXACT = ("area_px", "area_um2", "perimeter_px", "perimeter_um", "circularity",
         "solidity")
POLYS = [np.array([[20.5, 20.5], [70.5, 25.5], [65.5, 80.5], [15.5, 75.5]], np.float32),
         np.array([[65.5, 30.5], [120.5, 28.5], [118.5, 78.5], [66.5, 79.5]], np.float32),
         np.array([[150.3, 100.7], [223.9, 104.1], [223.2, 159.4], [160.4, 150.8]],
                  np.float32),
         np.array([[30.2, 100.7], [80.9, 102.1], [54.4, 140.8]], np.float32)]


def _ellipse(cx, cy, a, b, deg, n=40):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    x, y = a * np.cos(th), b * np.sin(th)
    return np.round(np.stack([cx + c * x - s * y, cy + s * x + c * y], 1) * 2) / 2


def _close(a, b, rtol, what):
    if isinstance(b, float) and math.isnan(b):
        assert isinstance(a, float) and math.isnan(a), what
    elif rtol == 0.0:
        assert a == b and type(a) is type(b), (what, a, b)
    else:
        assert abs(a - b) <= rtol * max(abs(b), 1e-9), (what, a, b)


def _assert_metric_rows_match(trows, jrows):
    assert len(trows) == len(jrows)
    for i, (rt, rj) in enumerate(zip(trows, jrows)):
        assert list(rt) == list(rj)
        for col, b in rj.items():
            if col == "orientation_deg" and not math.isnan(b):
                # an axis, not a direction: eigh's sign is free
                d = abs(rt[col] - b) % 180.0
                assert min(d, 180.0 - d) <= 1e-3, (i, col, rt[col], b)
            else:
                _close(rt[col], b, 0.0 if col in EXACT or isinstance(b, (int, str))
                       or b is None else RTOL, (i, col))


def test_config_and_columns_match_jax():
    jf, tf = dataclasses.fields(jm.MorConfig), dataclasses.fields(tm.MorConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    j, p = jm.MorConfig(), tm.MorConfig()
    for f in jf:
        a, b = getattr(p, f.name), getattr(j, f.name)
        assert (a.value == b.value) if f.name == "grammar" else (a == b and type(a) is type(b)), f.name
    assert tm.MOR_COLS == jm.MOR_COLS


@pytest.mark.parametrize("case", ["quads", "ellipses"])
def test_roi_moments_tiled_matches_jax(case):
    polys = POLYS if case == "quads" else [
        _ellipse(60, 50, 40, 15, 30), _ellipse(150, 90, 25, 25, 0),
        _ellipse(200, 140, 30, 10, -60)]
    tile = jrs.choose_tile(polys, H, W)
    offs = jrs.tile_offsets(polys, H, W, tile)
    pv, offs_pad, valid = jrs.pad_local_polys(polys, offs, 8, 64)
    want = jm.roi_moments_tiled(jnp.asarray(pv), jnp.asarray(offs_pad),
                                jnp.asarray(valid), tile)
    got = tm.roi_moments_tiled(torch.from_numpy(pv), torch.from_numpy(offs_pad),
                               torch.from_numpy(valid), tile)
    assert sorted(got) == sorted(want) == sorted(tm.MOMENT_FIELDS)
    masks = rasterize_polygons(torch.from_numpy(pv), (tile, tile)).numpy() & valid[:, None, None]
    n = len(polys)
    for f in tm.MOMENT_FIELDS:
        g, w = got[f].numpy(), np.asarray(want[f])
        assert g.dtype == np.float32 and g.shape == w.shape == (8,)
        if f == "area":
            assert np.array_equal(g, w) and np.array_equal(g, masks.sum((1, 2)))
        else:
            # sxy of a symmetric shape cancels to ~0: bound it by the
            # magnitude of the sums that form it
            scale = np.sqrt(np.asarray(want["sxx"]) * np.asarray(want["syy"])) \
                if f == "sxy" else np.abs(w)
            assert (np.abs(g - w)[:n] <= RTOL * np.maximum(scale[:n], 1e-9)).all(), f
        assert (g[n:] == w[n:]).all()                   # padded lanes
    # against numpy on the masks, in float64
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        assert abs(float(got["yc"][i]) - (ys.mean() + offs[i, 0])) <= 1e-4
        assert abs(float(got["sxx"][i]) - ((xs - xs.mean()) ** 2).sum()) <= \
            1e-5 * ((xs - xs.mean()) ** 2).sum()


def test_morphology_rows_match_jax():
    polys = POLYS + [_ellipse(150, 50, 28, 12, 45)]
    _assert_metric_rows_match(tm.morphology_rows(polys, (H, W), 0.223, device="cpu"),
                              jm.morphology_rows(polys, (H, W), 0.223))


def test_morphology_rows_degenerate_and_single_pixel_match_jax():
    """A zero-area polygon gives the area-0 row with NaN metrics; a
    one-pixel mask gives defined, degenerate metrics."""
    cases = [([np.array([[5.0, 5.0], [5.0, 5.0], [5.0, 5.0]])], (64, 64), 0.2),
             ([np.array([[5.7, 5.7], [6.3, 5.7], [6.0, 6.4]])], (16, 16), 0.25),
             ([np.array([[5.0, 5.0]] * 3), POLYS[3] / 2], (90, 100), 0.5)]
    for polys, shape, px in cases:
        trows = tm.morphology_rows(polys, shape, px, device="cpu")
        _assert_metric_rows_match(trows, jm.morphology_rows(polys, shape, px))
    zero = tm.morphology_rows(*cases[0], device="cpu")[0]
    assert zero["area_px"] == 0 and math.isnan(zero["circularity"])
    one = tm.morphology_rows(*cases[1], device="cpu")[0]
    assert one["area_px"] == 1.0 and one["major_um"] == 0.0 and one["minor_um"] == 0.0
    assert math.isnan(one["aspect_ratio"]) and math.isnan(one["roundness"])
    assert abs(one["centroid_x"] - 6.0) < 1e-6 and abs(one["centroid_y"] - 6.0) < 1e-6


def test_morphology_rows_oversized_roi_matches_jax():
    """An ROI that needs the full frame: one frame-sized tile per ROI."""
    shape = (96, 128)
    big = np.array([[-3, -3], [131, -3], [131, 99], [-3, 99]], float)
    polys = [big, POLYS[3] / 2, _ellipse(64, 48, 60, 40, 10)]
    assert jrs.choose_tile(polys, *shape) is None
    trows = tm.morphology_rows(polys, shape, 0.223, device="cpu")
    _assert_metric_rows_match(trows, jm.morphology_rows(polys, shape, 0.223))
    # the frame-sized tile is square (128 x 128) and is not cut to the
    # frame: the ROI's rows below the 96-row frame count, as in JAX
    assert trows[0]["area_px"] == 100 * 128


@pytest.fixture(scope="module")
def mor_ds(tmp_path_factory):
    """Three stages of channels 1 and 2 plus a channel-less file: S01 four
    ROIs, S02 a degenerate ROI beside a real one, S03 without an ROI
    file."""
    folder = tmp_path_factory.mktemp("mor")
    rng = np.random.default_rng(4)
    for s in (1, 2, 3):
        for ch in (1, 2):
            jtiffio.write_tiff16(str(folder / f"S{s:02d}_{ch}.TIF"),
                                 rng.integers(10, 3000, (H, W)).astype(np.uint16))
    jtiffio.write_tiff16(str(folder / "S04.TIF"),
                         rng.integers(10, 3000, (H, W)).astype(np.uint16))
    rois = {1: POLYS, 2: [np.array([[5.0, 5.0]] * 3), POLYS[0]], 4: [POLYS[1]]}
    for s, polys in rois.items():
        jroiio.save_roi_bundle(str(folder / "roi" / f"S{s:02d}.json"), f"S{s:02d}",
                               (H, W), polys)
    return folder


@pytest.fixture(scope="module")
def mor_tl_ds(tmp_path_factory):
    folder = tmp_path_factory.mktemp("mor_tl")
    rng = np.random.default_rng(7)
    for tp in (1, 0):
        jtiffio.write_tiff16(str(folder / f"S01_t{tp:02d}_1.TIF"),
                             rng.integers(10, 3000, (H, W)).astype(np.uint16))
        jroiio.save_roi_bundle(str(folder / "roi" / f"S01_t{tp:02d}.json"),
                               f"S01_t{tp:02d}", (H, W), POLYS[tp:tp + 2])
    return folder


def _cells_match(a, b):
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except (TypeError, ValueError):
        return False
    return (math.isnan(fa) and math.isnan(fb)) or abs(fa - fb) <= 1e-4 * max(abs(fb), 1e-9)


def _assert_reports_match(dir_t, dir_j, stem="morphology_perROI"):
    with open(os.path.join(dir_t, stem + ".csv"), newline="") as f:
        ct = list(csv.reader(f))
    with open(os.path.join(dir_j, stem + ".csv"), newline="") as f:
        cj = list(csv.reader(f))
    assert ct[0] == cj[0] == tm.MOR_COLS and len(ct) == len(cj) > 1
    orient = cj[0].index("orientation_deg")
    for rt, rj in zip(ct[1:], cj[1:]):
        for k, (a, b) in enumerate(zip(rt, rj)):
            if k == orient and a and b:
                d = abs(float(a) - float(b)) % 180.0
                assert min(d, 180.0 - d) <= 1e-3
            else:
                assert _cells_match(a, b), (cj[0][k], a, b)
    wt = xlsxlite.read_xlsx(os.path.join(dir_t, stem + ".xlsx"))
    wj = xlsxlite.read_xlsx(os.path.join(dir_j, stem + ".xlsx"))
    assert list(wt) == list(wj) == ["per_ROI"]
    assert wt["per_ROI"][0] == wj["per_ROI"][0] and len(wt["per_ROI"]) == len(wj["per_ROI"])
    for rt, rj in zip(wt["per_ROI"][1:], wj["per_ROI"][1:]):
        for k, (a, b) in enumerate(zip(rt, rj)):
            assert k == orient or _cells_match(a, b), (k, a, b)


def _run_both(folder, tmp_path, **kw):
    jlogs, tlogs = [], []
    kw = dict(save_full=False, save_crop=False, **kw)
    jrows = jm.run_morphology(str(folder), jm.MorConfig(**kw),
                              out_root=str(tmp_path / "j"), log=jlogs.append)
    trows = tm.run_morphology(str(folder), tm.MorConfig(**kw),
                              out_root=str(tmp_path / "t"), log=tlogs.append,
                              device="cpu")
    return trows, jrows, tlogs, jlogs


@pytest.mark.parametrize("kw", [{"sel_ch": 2}, {"sel_ch": 1, "include_no_channel": True,
                                                 "px_um": 0.112}],
                         ids=["ch2", "ch1+no-channel"])
def test_run_morphology_matches_jax(mor_ds, tmp_path, kw):
    trows, jrows, tlogs, jlogs = _run_both(mor_ds, tmp_path, **kw)
    assert len(trows) == (6 if kw["sel_ch"] == 2 else 7)
    _assert_metric_rows_match(trows, jrows)
    assert [x.replace(str(tmp_path / "t"), str(tmp_path / "j")) for x in tlogs] == jlogs
    assert {r["channel"] for r in trows} == {kw["sel_ch"]}
    assert [r["area_px"] for r in trows if r["stage"] == "S02"][0] == 0
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")


def test_run_morphology_timelapse_sorts_the_table(mor_tl_ds, tmp_path):
    """Rows come in file order, the table sorted by (stage, time, roi)."""
    trows, jrows, _, _ = _run_both(mor_tl_ds, tmp_path, timelapse=True)
    assert len(trows) == 4 and {r["time"] for r in trows} == {"t00", "t01"}
    _assert_metric_rows_match(trows, jrows)
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")
    with open(tmp_path / "t" / "xls" / "morphology_perROI.csv", newline="") as f:
        times = [row[1] for row in list(csv.reader(f))[1:]]
    assert times == sorted(times)


def test_morphology_table_fills_and_sorts_like_pandas():
    rows = [{"stage": "S02", "time": None, "roi": 2, "area_px": 4.0},
            {"stage": "S01", "time": "t01", "roi": 1, "area_px": 0},
            {"stage": "S01", "time": None, "roi": 1, "area_px": 2.0},
            {"stage": "S01", "time": "t00", "roi": 3, "area_px": 1.0}]
    table = tm.morphology_table(rows)
    assert [(r[0], r[1], r[2]) for r in table] == [
        ("S01", "t00", 3), ("S01", "t01", 1), ("S01", None, 1), ("S02", None, 2)]
    assert all(len(r) == len(tm.MOR_COLS) for r in table)
    assert math.isnan(table[0][tm.MOR_COLS.index("solidity")])


def test_no_results_and_empty_folder(tmp_path, mor_ds):
    logs = []
    assert tm.run_morphology(str(tmp_path), tm.MorConfig(save_full=False, save_crop=False),
                             log=logs.append, device="cpu") == []
    jlogs = []
    assert jm.run_morphology(str(tmp_path), jm.MorConfig(save_full=False, save_crop=False),
                             log=jlogs.append) == []
    assert logs == jlogs and not (tmp_path / "RES_MOR").exists()


@pytest.mark.parametrize("kw", [{}, {"save_crop": False}, {"save_full": False}],
                         ids=["defaults", "save_full", "save_crop"])
def test_image_outputs_raise_before_reading(mor_ds, tmp_path, kw):
    """MorConfig's image defaults: the overlay of each frame and the titled
    crop of each ROI (the degenerate ROI of S02 too), the same files as the
    JAX runner's, byte for byte; the rows are the tables-only rows.  (The
    name is kept from when the overlays raised.)"""
    trows = tm.run_morphology(str(mor_ds), tm.MorConfig(sel_ch=2, do_xls=False, **kw),
                              out_root=str(tmp_path / "t"), log=lambda *_: None,
                              device="cpu")
    jm.run_morphology(str(mor_ds), jm.MorConfig(sel_ch=2, do_xls=False, **kw),
                      out_root=str(tmp_path / "j"), log=lambda *_: None)
    names = assert_pngs_match(tmp_path / "t", tmp_path / "j", frac=0.0,
                              expect=2 * kw.get("save_full", True) + 6 * kw.get("save_crop", True))
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    tables = tm.run_morphology(str(mor_ds), tm.MorConfig(sel_ch=2, do_xls=False,
                                                         save_full=False, save_crop=False),
                               log=lambda *_: None, device="cpu")
    _assert_metric_rows_match(trows, tables)


def test_runner_defaults_to_the_card(mor_ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tm.run_morphology(str(mor_ds), tm.MorConfig(save_full=False, save_crop=False))
    with pytest.raises(RuntimeError, match="is_available"):
        tm.morphology_rows(POLYS, (H, W), 0.223)


def test_cpu_run_launches_no_kernel(mor_ds):
    rsk.reset_launches()
    tsk.reset_launches()
    cfg = tm.MorConfig(sel_ch=2, save_full=False, save_crop=False, do_xls=False)
    assert len(tm.run_morphology(str(mor_ds), cfg, log=lambda *_: None, device="cpu")) == 6
    assert rsk.launches["roistats_f32"] == 0 and tsk.launches["tilestats_u16"] == 0


@pytest.mark.cuda
def test_cuda_rows_match_cpu(mor_ds):
    """On a card: areas exact, the moments within 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = tm.MorConfig(sel_ch=2, save_full=False, save_crop=False, do_xls=False)
    quiet = lambda *_: None  # noqa: E731
    card = tm.run_morphology(str(mor_ds), cfg, log=quiet, device="cuda")
    cpu = tm.run_morphology(str(mor_ds), cfg, log=quiet, device="cpu")
    _assert_metric_rows_match(card, cpu)
