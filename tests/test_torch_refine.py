"""Port parity: ROI refinement (``segment.autoseg``, ``segment.drawer``,
``segment.evalseg``), marching squares, Douglas-Peucker and the ImageJ
``.roi`` codec against the JAX package on the CPU.

Bars, and why:
- host copies (``find_contours``, ``douglas_peucker``, the ImageJ codec,
  ``match_instances``): bit-equal, the same vertices in the same order and
  the same bytes;
- ``segment_inside_polygon`` against JAX's compiled tile program, on
  u16-valued frames with one-decimal vertices: thresholds within 1e-6
  relative (XLA's CPU compiler contracts FMAs in the quantile's
  interpolation and ``m + k*s``, and sums the BND moments in another
  order), polygons equal -- on these frames no pixel lies between two
  thresholds a few ulps apart, and a raster over one-decimal vertices has
  exact crossing sums;
- the drawer bundle: the JSON, the mask TIFF's pixels, the overlay PNG's
  pixels (the same Pillow on both sides) and the zip's entry names and
  bytes equal; never whole zip files, whose entries carry timestamps."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from imageprocess_tpu.core import roiio as jroiio
from imageprocess_tpu.core import tiffio as jtiffio
from imageprocess_tpu.geom import polygon as jpolygon
from imageprocess_tpu.morphology import contours as jcontours
from imageprocess_tpu.segment import autoseg as jautoseg
from imageprocess_tpu.segment import drawer as jdrawer
from imageprocess_tpu.segment import evalseg as jevalseg
from imageprocess_tpu_torch.core import roiio as troiio
from imageprocess_tpu_torch.geom import polygon as tpolygon
from imageprocess_tpu_torch.morphology import contours as tcontours
from imageprocess_tpu_torch.segment import autoseg as tautoseg
from imageprocess_tpu_torch.segment import drawer as tdrawer
from imageprocess_tpu_torch.segment import evalseg as tevalseg

QUIET = dict(log=lambda *_: None)
QUAD = np.array([[70.3, 40.1], [180.2, 45.6], [175.4, 140.3], [65.7, 135.2]])


def _blob_frame(seed=0, shape=(200, 260)):
    """u16-valued float32 frame: noise around 100 and two Gaussian blobs."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = rng.normal(100, 10, shape)
    yy, xx = np.mgrid[0:H, 0:W]
    img += 1000.0 * np.exp(-((yy - 90) ** 2 + (xx - 120) ** 2) / (2 * 25 ** 2))
    img += 800.0 * np.exp(-((yy - 60) ** 2 + (xx - 200) ** 2) / (2 * 12 ** 2))
    img += 600.0 * np.exp(-((yy - 170) ** 2 + (xx - 225) ** 2) / (2 * 14 ** 2))
    return np.clip(np.round(img), 0, 65535).astype(np.float32)


@pytest.fixture(scope="module")
def frame():
    return _blob_frame()


# ------------------------------------------------------------------ host copies


def _contour_inputs():
    rng = np.random.default_rng(3)
    blobs = np.zeros((40, 50))
    blobs[5:15, 5:20] = 1
    blobs[20:35, 25:45] = 1
    blobs[26:30, 30:36] = 0          # a hole
    blobs[0:4, 46:50] = 1            # touching the border
    saddle = np.zeros((6, 6))
    saddle[2, 2] = saddle[3, 3] = 1  # diagonal pair: low-connected saddle
    return {
        "blobs": (blobs, 0.5),
        "saddle": (saddle, 0.5),
        "smooth": (_blob_frame(1, (48, 64)), 400.0),
        "noise": (rng.random((30, 30)), 0.5),
        "flat": (np.ones((5, 5)), 0.5),
        "one_row": (np.ones((1, 8)), 0.5),
    }


@pytest.mark.parametrize("case", sorted(_contour_inputs()))
def test_find_contours_and_areas_bit_equal_jax(case):
    a, level = _contour_inputs()[case]
    got = tcontours.find_contours(a, level)
    want = jcontours.find_contours(a, level)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        xy = np.c_[g[:, 1], g[:, 0]]
        assert tcontours.polygon_area_contour(xy) == jcontours.polygon_area_contour(xy)


@pytest.mark.parametrize("tolerance", [0.0, 0.5, 1.0, 3.0])
def test_douglas_peucker_bit_equal_jax(tolerance):
    rng = np.random.default_rng(7)
    t = np.linspace(0, 2 * np.pi, 90)
    ring = np.c_[40 + 20 * np.cos(t) + rng.normal(0, 0.7, t.size),
                 30 + 12 * np.sin(t) + rng.normal(0, 0.7, t.size)]
    dup = np.r_[ring[:5], ring[:1], ring[:1]]  # zero-length chord
    for pts in (ring, dup, ring[:2]):
        got = tpolygon.douglas_peucker(pts, tolerance)
        assert np.array_equal(got, jpolygon.douglas_peucker(pts, tolerance))


POLYS = [np.array([[10.4, 12.6], [60.2, 15.1], [55.5, 70.9], [12.0, 66.6]]),
         np.array([[300.0, 5.0], [320.0, 5.0], [310.0, 40.0]]),
         np.array([[-3.2, 7.7], [4.4, -2.5], [9.9, 9.9]])]


@pytest.mark.parametrize("name", ["", "roi_1", "Zelle ü", "𝒳"])
def test_imagej_roi_codec_equals_jax(name):
    for p in POLYS:
        blob = troiio.encode_imagej_roi(p, name)
        assert blob == jroiio.encode_imagej_roi(p, name)
        assert np.array_equal(troiio.decode_imagej_roi(blob),
                              jroiio.decode_imagej_roi(blob))
        assert troiio.decode_imagej_roi_name(blob) == name
        assert jroiio.decode_imagej_roi_name(blob) == name


def test_imagej_zip_entries_equal_jax(tmp_path):
    polys = POLYS * 4   # 12 entries: roi_10 sorts after roi_9
    out = {}
    for tag, mod in (("t", troiio), ("j", jroiio)):
        path = str(tmp_path / tag / "S01.zip")
        mod.save_imagej_roi_zip(path, polys, "S01")
        assert os.listdir(tmp_path / tag) == ["S01.zip"]   # no .tmp left
        with zipfile.ZipFile(path) as zf:
            out[tag] = [(i.filename, zf.read(i)) for i in zf.infolist()]
        loaded = troiio.load_imagej_roi_zip(path)
        ref = jroiio.load_imagej_roi_zip(path)
        assert len(loaded) == len(ref) == 12
        assert all(np.array_equal(a, b) for a, b in zip(loaded, ref))
    assert out["t"] == out["j"]
    assert [n for n, _ in out["t"]] == [f"roi_{i}.roi" for i in range(1, 13)]


@pytest.mark.parametrize("poly,match", [
    (np.array([[40000.0, 1.0], [40010.0, 1.0], [40005.0, 9.0]]), "signed-16-bit"),
    (np.array([[-30000.0, 1.0], [30000.0, 1.0], [0.0, 9.0]]), "16-bit limits"),
    (np.c_[np.arange(33000.0) % 50, np.arange(33000.0) // 50], "n=33000"),
])
def test_imagej_range_checks_equal_jax(tmp_path, poly, match):
    for mod in (troiio, jroiio):
        with pytest.raises(ValueError, match=match):
            mod.encode_imagej_roi(poly)
    with pytest.raises(ValueError, match=match):
        troiio.save_imagej_roi_zip(str(tmp_path / "bad.zip"), [POLYS[0], poly])
    assert os.listdir(tmp_path) == []   # neither the zip nor its .tmp


@pytest.mark.parametrize("iou", [0.3, 0.5, 0.9])
def test_match_instances_equal_jax(frame, iou):
    shape = frame.shape
    true = [QUAD, POLYS[0], np.array([[200.5, 150.5], [240.5, 150.5], [220.5, 190.5]])]
    pred = [QUAD + 3.0, POLYS[0] * 1.1, np.array([[5.0, 180.0], [30.0, 180.0], [20.0, 195.0]])]
    got = tevalseg.match_instances(pred, true, shape, iou)
    assert got == jevalseg.match_instances(pred, true, shape, iou)
    assert tevalseg.match_instances([], true, shape, iou) == \
        jevalseg.match_instances([], true, shape, iou)


# ------------------------------------------------------------------ segment_inside_polygon


def _nan_frame():
    img = _blob_frame(2)
    img[80:84, 100:140] = np.nan
    img[10:12, 10:12] = np.inf
    return img


def _flat_frame():
    img = _blob_frame(4)
    img[20:70, 20:90] = 250.0
    return img


def _bar_frame():
    rng = np.random.default_rng(5)
    img = np.round(rng.normal(100, 5, (64, 300)))
    img[25:40, 20:280] += 3000.0
    return img.astype(np.float32)


SEG_CASES = {  # name: (frame, polygon, thr_param, mode, min_area, tolerance)
    "p90": (_blob_frame, QUAD, 90.0, "percentile", 20.0, 0.5),
    "p75": (_blob_frame, QUAD, 75.0, "percentile", 20.0, 0.5),
    "bnd_k2": (_blob_frame, QUAD, 2.0, "bnd", 20.0, 0.5),
    "bnd_upper_case_k1": (_blob_frame, QUAD, 1.0, "BND", 40.0, 1.0),
    "nan_and_inf_p90": (_nan_frame, QUAD, 90.0, "percentile", 20.0, 1.0),
    "nan_and_inf_bnd": (_nan_frame, QUAD, 1.5, "bnd", 20.0, 1.0),
    "flat_bnd_p90_fallback": (_flat_frame, np.array([[25.5, 25.5], [80.5, 25.5],
                                                    [80.5, 60.5], [25.5, 60.5]]),
                              2.0, "bnd", 20.0, 1.0),
    # a bbox at the frame's bottom-right: the tile origin H - ty moves the
    # polygon inside its tile
    "tile_shifted": (_blob_frame, np.array([[185.2, 135.1], [259.0, 140.7],
                                            [255.3, 199.9], [190.1, 195.5]]),
                     80.0, "percentile", 20.0, 1.0),
    # wider than the frame is high: the tile is clamped per axis (300 x 64)
    "elongated": (_bar_frame, np.array([[10.0, 15.0], [290.0, 15.0],
                                        [290.0, 50.0], [10.0, 50.0]]),
                  50.0, "percentile", 100.0, 1.0),
    "outside": (_blob_frame, np.array([[500.0, 500.0], [510.0, 500.0],
                                       [505.0, 510.0]]), 90.0, "percentile", 40.0, 1.0),
    "no_pixel_inside": (_blob_frame, np.array([[10.2, 10.2], [10.8, 10.2],
                                               [10.5, 10.8]]), 90.0, "percentile",
                        40.0, 1.0),
    "below_min_area": (_blob_frame, QUAD, 99.9, "percentile", 5000.0, 1.0),
}


def _seg(mod_fn, case, **kw):
    make, poly, p, mode, min_area, tol = SEG_CASES[case]
    return mod_fn(make(), poly, thr_param=p, min_area=min_area, tolerance=tol,
                  mode=mode, **kw)


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_inside_polygon_matches_jax(case):
    thr, none, best = _seg(tautoseg.segment_inside_polygon, case, device="cpu")
    jthr, _, jbest = _seg(jautoseg.segment_inside_polygon, case)
    assert none is None
    assert (thr is None) == (jthr is None) and (best is None) == (jbest is None)
    if thr is not None:
        assert abs(thr - jthr) <= 1e-6 * abs(jthr), (thr, jthr)
    if best is not None:
        assert best.dtype == jbest.dtype and np.array_equal(best, jbest)
    expect_poly = case not in ("outside", "no_pixel_inside", "below_min_area")
    assert (best is not None) == expect_poly
    assert (thr is None) == (case in ("outside", "no_pixel_inside"))
    if case == "elongated":
        assert best[:, 0].min() < 30 and best[:, 0].max() > 270


def test_segment_inside_polygon_phases_and_rounds():
    """With a PhaseTimer the result is the same, every phase is timed once
    and both CCLs count their rounds."""
    from imageprocess_tpu_torch.timing import PhaseTimer

    timer = PhaseTimer("cpu")
    got = _seg(tautoseg.segment_inside_polygon, "p90", device="cpu", timer=timer)
    want = _seg(tautoseg.segment_inside_polygon, "p90", device="cpu")
    assert got[0] == want[0] and np.array_equal(got[2], want[2])
    assert list(timer.times_ms()) == ["upload", "threshold", "largest_component",
                                      "fill_holes", "fetch", "contours"]
    assert sorted(timer.counts) == ["fill_holes.rounds", "largest_component.rounds"]
    assert min(timer.counts.values()) >= 2


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tautoseg.segment_inside_polygon(_blob_frame(), QUAD),
                 lambda: tdrawer.refine_and_save(str(tmp_path), tdrawer.RefineConfig())):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


@pytest.mark.cuda
def test_cuda_segment_inside_polygon_matches_cpu():
    """On a card: the card's threshold within 1e-5 relative of the CPU's
    (BND sums in another order), polygons equal unless a pixel of the
    polygon lies between the two thresholds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for case in SEG_CASES:
        cpu = _seg(tautoseg.segment_inside_polygon, case, device="cpu")
        card = _seg(tautoseg.segment_inside_polygon, case, device="cuda")
        assert (card[0] is None) == (cpu[0] is None), case
        if cpu[0] is None:
            continue
        assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0]), case
        make = SEG_CASES[case][0]
        lo, hi = sorted((card[0], cpu[0]))
        between = ((make() >= lo) & (make() < hi)).any()
        if not between:
            assert (card[2] is None) == (cpu[2] is None), case
            if cpu[2] is not None:
                assert np.array_equal(card[2], cpu[2]), case


# ------------------------------------------------------------------ drawer bundle


def _bundle_files(roi_dir, base="S01"):
    """(JSON, mask pixels, overlay pixels, zip entries) of a bundle."""
    with open(os.path.join(roi_dir, f"{base}.json"), encoding="utf-8") as f:
        js = json.load(f)
    mask = np.array(Image.open(os.path.join(roi_dir, "mask", f"{base}_mask.tif")))
    overlay = np.array(Image.open(os.path.join(roi_dir, "overlay", f"{base}_overlay.png")))
    with zipfile.ZipFile(os.path.join(roi_dir, "zip", f"{base}.zip")) as zf:
        entries = [(i.filename, zf.read(i)) for i in zf.infolist()]
    return js, mask, overlay, entries


def _assert_bundles_equal(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:3], b[1:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a[3] == b[3]


REFINED = [QUAD, np.array([[200.5, 50.5], [215.5, 48.5], [214.5, 70.5], [199.5, 69.5]]),
           np.array([[5.0, 5.0], [9.0, 5.0]])]   # too short to draw or rasterize


@pytest.mark.parametrize("view,maxpx", [
    (None, 1600),
    ({"p_low": 5.0, "p_high": 95.0, "gamma": 0.7, "invert": True,
      "color_mode": "Magenta"}, 1600),
    ({"p_low": 1.0, "p_high": 99.0, "gamma": 1.0, "invert": False,
      "color_mode": "cyan"}, 128),      # downscaled overlay
])
def test_save_drawer_bundle_equals_jax(tmp_path, monkeypatch, frame, view, maxpx):
    monkeypatch.setattr(tdrawer, "FAST_OVERLAY_MAXPX", maxpx)
    monkeypatch.setattr(jdrawer, "FAST_OVERLAY_MAXPX", maxpx)
    out, logs = {}, {}
    for tag, mod in (("t", tdrawer), ("j", jdrawer)):
        roi_dir = str(tmp_path / tag)
        lines = []
        paths = mod.save_drawer_bundle(roi_dir, "S01", REFINED, frame,
                                       view_params=view, log=lines.append)
        assert all(p is not None and os.path.exists(p) for p in paths)
        out[tag] = _bundle_files(roi_dir)
        logs[tag] = [s.replace(roi_dir, "<dir>") for s in lines]
    _assert_bundles_equal(out["t"], out["j"])
    assert logs["t"] == logs["j"]
    assert set(np.unique(out["t"][1])) == {0, 255}
    if maxpx < max(frame.shape):
        assert max(out["t"][2].shape[:2]) < max(frame.shape)


@pytest.mark.parametrize("fails", ["mask", "overlay", "zip", "json"])
def test_save_drawer_bundle_artifact_isolation(tmp_path, monkeypatch, frame, fails):
    """One failed artifact logs its warning and returns None, the others
    still save; a failed JSON aborts: as the JAX function does."""
    def boom(*a, **k):
        raise RuntimeError(f"{fails} exploded")

    targets = {"mask": "tiffio.write_tiff8", "overlay": "apply_view_and_color",
               "zip": "roiio.save_imagej_roi_zip", "json": "roiio.save_roi_bundle"}
    res = {}
    for tag, mod in (("t", tdrawer), ("j", jdrawer)):
        obj, _, attr = targets[fails].rpartition(".")
        monkeypatch.setattr(getattr(mod, obj) if obj else mod, attr, boom)
        lines = []
        call = lambda: mod.save_drawer_bundle(  # noqa: E731
            str(tmp_path / tag), "S01", REFINED[:2], frame, log=lines.append)
        if fails == "json":
            with pytest.raises(RuntimeError, match="exploded"):
                call()
            res[tag] = lines
            continue
        paths = call()
        assert [p is None for p in paths] == [k == fails for k in
                                              ("json", "mask", "overlay", "zip")]
        assert all(os.path.exists(p) for p in paths if p is not None)
        res[tag] = [s.replace(str(tmp_path / tag), "<dir>") for s in lines]
    assert res["t"] == res["j"]
    if fails != "json":
        assert any("exploded" in s for s in res["t"])


@pytest.mark.parametrize("cfg", [dict(thr_param=90.0, min_area=20.0),
                                 dict(thr_param=2.0, mode="bnd", tolerance=0.5),
                                 dict(thr_param=90.0, channel=2)])
def test_refine_and_save_equals_jax(tmp_path, frame, cfg):
    """One frame with rough polygons (one that refines to nothing keeps
    its rough outline): the written bundle equals JAX's."""
    rough = [QUAD, np.array([[185.2, 135.1], [259.0, 140.7], [255.3, 199.9],
                             [190.1, 195.5]]),
             np.array([[5.5, 180.5], [40.5, 180.5], [22.5, 195.5]])]
    out = {}
    for tag, mod, jmod in (("t", tdrawer, troiio), ("j", jdrawer, jroiio)):
        d = tmp_path / tag
        d.mkdir()
        jtiffio.write_tiff16(str(d / "S01_1.TIF"), frame.astype(np.uint16))
        jmod.save_roi_bundle(str(d / "roi" / "S01.json"), "S01", frame.shape, rough)
        kw = dict(device="cpu") if tag == "t" else {}
        written = mod.refine_and_save(str(d), mod.RefineConfig(**cfg), **QUIET, **kw)
        if cfg.get("channel") == 2:   # the frame is channel 1: nothing refined
            assert written == []
            out[tag] = sorted(os.listdir(d / "roi"))
            continue
        assert written == [str(d / "roi" / "S01.json")]
        out[tag] = _bundle_files(str(d / "roi"))
    if cfg.get("channel") == 2:
        assert out["t"] == out["j"] == ["S01.json"]
        return
    _assert_bundles_equal(out["t"], out["j"])
    polys = out["t"][0]["rois"]
    assert len(polys) == 3 and np.array_equal(polys[2], rough[2])
    assert tpolygon.shoelace_area(np.array(polys[0])) < tpolygon.shoelace_area(QUAD)
