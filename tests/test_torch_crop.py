"""Port parity of the channel cropper (``pipelines.crop``) on the CPU
(``device="cpu"``) against the JAX package on the same numpy-seeded
folders: ``crop_view_tiled`` on the same tiles, and ``run_crop``'s files
-- the same names, raw TIFFs equal, normalized TIFF16 within one count,
PNG pixels within one LUT step (they are equal here) -- plus the crop half
of ``tests/test_crop_ppt.py`` (the normalization against numpy, the ROI
subset) on the port.

The polygons sit on the half-integer lattice, where the rasterizer's
crossing sums are exact (see test_torch_morphology_pipeline.py)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imageprocess_tpu.core import roiio as jroiio
from imageprocess_tpu.core import tiffio as jtiffio
from imageprocess_tpu.pipelines import crop as jc
from imageprocess_tpu_torch.geom.polygon import pad_polygons
from imageprocess_tpu_torch.geom.rasterize import rasterize_polygon_np
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
from imageprocess_tpu_torch.ops.percentile import p1000_of
from imageprocess_tpu_torch.pipelines import crop as tc
from test_torch_tiffout import assert_pngs_match, lut_step

H, W = 300, 400
POLYS = [np.array([[60.5, 50.5], [180.5, 55.5], [170.5, 160.5], [55.5, 150.5]]),
         np.array([[220.5, 180.5], [350.5, 190.5], [340.5, 280.5], [210.5, 270.5]]),
         np.array([[5.5, 250.5], [40.5, 255.5], [20.5, 298.5]])]
# wider than the frame's short side: the crop is cut to the 300-px tile
BIG = np.array([[10.5, 8.5], [390.5, 12.5], [385.5, 292.5], [15.5, 288.5]])
QUIET = dict(log=lambda *_: None)


def _frame(rng, dtype=np.uint16):
    img = rng.integers(50, 4000, (H, W))
    return img.astype(dtype) if dtype != np.float32 else img.astype(np.float32) / 7.0


@pytest.fixture(scope="module")
def crop_ds(tmp_path_factory):
    """Channel 2 frames: S01 three ROIs, S02 the oversized ROI beside one,
    S03 without an ROI file, S04 a float32 frame with NaN; channel 1 of
    S01 for the channel filter; S05 an unreadable file."""
    folder = tmp_path_factory.mktemp("crop")
    rng = np.random.default_rng(0)
    for s in (1, 2, 3):
        jtiffio.write_tiff16(str(folder / f"S{s:02d}_2.TIF"), _frame(rng))
    jtiffio.write_tiff16(str(folder / "S01_1.TIF"), _frame(rng))
    f32 = _frame(rng, np.float32)
    f32[100:110, 100:140] = np.nan
    jtiffio.write_tiff32(str(folder / "S04_2.TIF"), f32)
    (folder / "S05_2.TIF").write_bytes(b"not a tiff")
    for s, rois in ((1, POLYS), (2, [BIG, POLYS[0]]), (4, POLYS[:2]), (5, POLYS[:1])):
        jroiio.save_roi_bundle(str(folder / "roi" / f"S{s:02d}.json"), f"S{s:02d}",
                               (H, W), rois)
    return folder


def _files(root, ext):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(ext))


def _run_both(folder, tmp_path, **kw):
    jlogs, tlogs = [], []
    jw = jc.run_crop(str(folder), str(folder / "roi"), str(tmp_path / "j"),
                     jc.CropConfig(**kw), log=jlogs.append)
    tw = tc.run_crop(str(folder), str(folder / "roi"), str(tmp_path / "t"),
                     tc.CropConfig(**kw), log=tlogs.append, device="cpu")
    return tw, jw, tlogs, jlogs


def _assert_tiffs_match(troot, jroot):
    names = _files(troot, ".tif")
    assert names == _files(jroot, ".tif")
    for name in names:
        t = np.array(Image.open(os.path.join(troot, name)))
        j = np.array(Image.open(os.path.join(jroot, name)))
        assert t.dtype == j.dtype and t.shape == j.shape, name
        if name.startswith("TIFF16"):
            assert np.abs(t.astype(np.int64) - j.astype(np.int64)).max() <= 1, name
        else:
            assert np.array_equal(t, j, equal_nan=t.dtype.kind == "f"), name
    return names


def test_config_matches_jax():
    jf, tf = dataclasses.fields(jc.CropConfig), dataclasses.fields(tc.CropConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for f in jf:
        a, b = getattr(tc.CropConfig(), f.name), getattr(jc.CropConfig(), f.name)
        assert (a.value == b.value) if f.name == "grammar" else a == b, f.name
    assert tc.COLOR_MAP == jc.COLOR_MAP


@pytest.mark.parametrize("kw", [
    dict(),
    dict(gamma=2.0, low_cut=1.0, high_cut=1.0, mask_outside=True, save_tiff16=True,
         save_tiff_raw=True, subset_stage=4),
    dict(color="Green", gamma=0.7, save_tiff16=True, save_tiff_raw=True,
         add_scalebar=True, px_um=0.2, sb_len_um=5.0, fixed_crop=False, png_dpi=60),
    dict(color="Magenta", low_cut=0.0, high_cut=0.0, crop_w=320, crop_h=240, png_dpi=100)],
    ids=["defaults", "gamma-mask-tiffs", "tint-scalebar-free-size", "magenta-minmax"])
def test_run_crop_matches_jax(crop_ds, tmp_path, kw):
    """Every selected frame and ROI: the same written paths in the same
    order, the same files; the oversized ROI of S02 is cut to the tile in
    both (and logs it); S03 (no ROI) and S05 (unreadable) are logged."""
    tw, jw, tlogs, jlogs = _run_both(crop_ds, tmp_path, channel=2, **kw)
    rel = [os.path.relpath(p, tmp_path / "t") for p in tw]
    assert rel == [os.path.relpath(p, tmp_path / "j") for p in jw]
    n_files = 1 + kw.get("save_tiff16", False) + kw.get("save_tiff_raw", False)
    n_rois = 2 if "subset_stage" in kw else 7      # S01 three, S02 two, S04 two
    assert len(rel) == n_rois * n_files
    assert [x.replace(str(tmp_path / "t"), str(tmp_path / "j")) for x in tlogs] == jlogs
    if "subset_stage" not in kw:
        assert tc.t("crop_warn_too_large").format(tag="S02") in tlogs
        assert tc.t("crop_no_roi").format(tag="S03") in tlogs
        assert any("S05" in x for x in tlogs)
    assert_pngs_match(tmp_path / "t", tmp_path / "j", expect=n_rois, frac=0.0,
                      step=lut_step("gray"))
    names = _assert_tiffs_match(tmp_path / "t", tmp_path / "j")
    if kw.get("save_tiff_raw"):
        assert np.array(Image.open(tmp_path / "t" / "TIFF" / "S04_roi1_ch2.tif")).dtype \
            == np.float32 and "TIFF16/S04_roi2_ch2.tif" in names
    else:
        big = np.array(Image.open(tmp_path / "t" / "PNG" / "S02_roi1_ch2.png"))
        assert big.shape[:2] == ((kw.get("crop_h", 500), kw.get("crop_w", 500))
                                 if kw.get("fixed_crop", True) else (288, 384))


def test_cut_crop_with_mask_and_raw_tiff_fails_like_jax(crop_ds, tmp_path):
    """An ROI that outgrows the tile with ``mask_outside`` and the raw
    TIFF: the cut mask does not fit the uncut raw crop, and both packages
    stop the run with the same IndexError (kept as the JAX package has it,
    ROADMAP Queue 3)."""
    kw = dict(channel=2, mask_outside=True, save_tiff_raw=True, subset_stage=2)
    with pytest.raises(IndexError):
        jc.run_crop(str(crop_ds), str(crop_ds / "roi"), str(tmp_path / "j"),
                    jc.CropConfig(**kw), **QUIET)
    with pytest.raises(IndexError):
        tc.run_crop(str(crop_ds), str(crop_ds / "roi"), str(tmp_path / "t"),
                    tc.CropConfig(**kw), device="cpu", **QUIET)
    assert _files(tmp_path / "t", ".png") == _files(tmp_path / "j", ".png")


def test_run_crop_outputs_and_norm_parity(crop_ds, tmp_path):
    """tests/test_crop_ppt.py's numpy replication of the normalization
    (roi_channel_cropper.py:904-936) on the port's files."""
    cfg = tc.CropConfig(channel=2, gamma=2.0, low_cut=1.0, high_cut=1.0,
                        mask_outside=True, save_png=True, save_tiff16=True,
                        save_tiff_raw=True, fixed_crop=False, png_dpi=60,
                        subset_stage=1)
    written = tc.run_crop(str(crop_ds), str(crop_ds / "roi"), str(tmp_path), cfg,
                          device="cpu", **QUIET)
    names = sorted(os.path.basename(w) for w in written)
    assert "S01_roi1_ch2.png" in names and "S01_roi2_ch2.png" in names
    img = np.array(Image.open(crop_ds / "S01_2.TIF"))
    P = POLYS[0]
    pad = max(10, int(0.05 * max(W, H)))
    x0, x1 = max(int(P[:, 0].min()) - pad, 0), min(int(P[:, 0].max()) + pad, W - 1)
    y0, y1 = max(int(P[:, 1].min()) - pad, 0), min(int(P[:, 1].max()) + pad, H - 1)
    crop = img[y0:y1 + 1, x0:x1 + 1].astype(np.float32)
    lo, hi = np.percentile(crop.ravel(), 1.0), np.percentile(crop.ravel(), 99.0)
    local = rasterize_polygon_np(P - [x0, y0], crop.shape)
    norm = np.clip((crop - lo) / (hi - lo), 0, 1) * local
    ref16 = (np.clip(norm ** 0.5, 0, 1) * 65535).astype(np.uint16)
    got16 = np.array(Image.open(tmp_path / "TIFF16" / "S01_roi1_ch2.tif"))
    assert got16.shape == ref16.shape
    assert np.abs(got16.astype(int) - ref16.astype(int)).max() <= 1
    raw = np.array(Image.open(tmp_path / "TIFF" / "S01_roi1_ch2.tif"))
    ref_raw = img[y0:y1 + 1, x0:x1 + 1].copy()
    ref_raw[~local] = 0
    assert np.array_equal(raw, ref_raw)


def test_run_crop_subset_roi(crop_ds, tmp_path):
    cfg = tc.CropConfig(channel=2, save_png=False, save_tiff16=True, subset_stage=1,
                        subset_roi=2, fixed_crop=False)
    written = tc.run_crop(str(crop_ds), str(crop_ds / "roi"), str(tmp_path), cfg,
                          device="cpu", **QUIET)
    assert [os.path.basename(w) for w in written] == ["S01_roi2_ch2.tif"]


@pytest.mark.parametrize("kw,log", [
    (dict(channel=7), "crop_no_channel"), (dict(channel=2, subset_stage=9), "crop_subset_no_match"),
    (dict(channel=2, subset_stage=1, subset_roi=9), "crop_subset_warn")])
def test_run_crop_skips_like_jax(crop_ds, tmp_path, kw, log):
    tw, jw, tlogs, jlogs = _run_both(crop_ds, tmp_path, **kw)
    assert tw == jw == [] and tlogs == jlogs
    assert any(tc.t(log).split("{")[0] in x for x in tlogs)


@pytest.fixture(scope="module")
def timelapse_ds(tmp_path_factory):
    folder = tmp_path_factory.mktemp("crop_tl")
    rng = np.random.default_rng(3)
    for tp in (0, 1, 2):
        jtiffio.write_tiff16(str(folder / f"S01_t{tp:02d}_2.TIF"), _frame(rng))
        jroiio.save_roi_bundle(str(folder / "roi" / f"S01_t{tp:02d}.json"),
                               f"S01_t{tp:02d}", (H, W), POLYS[tp:tp + 2])
    return folder


@pytest.mark.parametrize("kw", [dict(), dict(subset_stage=1, subset_time=1)],
                         ids=["all", "subset-time"])
def test_run_crop_timelapse_names_match_jax(timelapse_ds, tmp_path, kw):
    tw, jw, _, _ = _run_both(timelapse_ds, tmp_path, channel=2, timelapse=True,
                             save_tiff16=True, **kw)
    rel = [os.path.relpath(p, tmp_path / "t") for p in tw]
    assert rel == [os.path.relpath(p, tmp_path / "j") for p in jw]
    assert ("PNG/S01_t01_roi2_ch2.png" in rel) and len(rel) == (4 if kw else 10)
    assert_pngs_match(tmp_path / "t", tmp_path / "j", frac=0.0)
    _assert_tiffs_match(tmp_path / "t", tmp_path / "j")


def _view_inputs(polys, tile, frame):
    pad = max(10, int(0.05 * max(W, H)))
    n = len(polys)
    offs, cstart, csize = (np.zeros((n, 2), np.int32) for _ in range(3))
    locals_ = []
    for i, P in enumerate(polys):
        x0, x1 = max(int(P[:, 0].min()) - pad, 0), min(int(P[:, 0].max()) + pad, W - 1)
        y0, y1 = max(int(P[:, 1].min()) - pad, 0), min(int(P[:, 1].max()) + pad, H - 1)
        oy, ox = min(y0, H - tile), min(x0, W - tile)
        offs[i], cstart[i] = (oy, ox), (y0 - oy, x0 - ox)
        csize[i] = (min(y1 - y0 + 1, tile), min(x1 - x0 + 1, tile))
        locals_.append((P - [ox, oy]).astype(np.float32))
    return frame, pad_polygons(locals_), offs, cstart, csize


@pytest.mark.parametrize("case", ["u16", "float-nan", "flat", "oversized"])
@pytest.mark.parametrize("mask_outside", [False, True], ids=["plain", "mask"])
def test_crop_view_tiled_matches_jax(case, mask_outside):
    """Views, masks and flags on the same tiles: masks and flags equal,
    views within 1e-6 (the division and the power in another order); a
    flat crop has no range and is not ok."""
    rng = np.random.default_rng(11)
    frame = _frame(rng, np.float32 if case == "float-nan" else np.uint16)
    polys = [BIG] if case == "oversized" else POLYS
    if case == "float-nan":
        frame[40:80, 60:200] = np.nan
        frame[200:210, 230:240] = np.inf
    if case == "flat":
        frame[:] = 77
    tile = 300 if case == "oversized" else 256
    args = _view_inputs(polys, tile, frame)
    lo, hi, g = p1000_of(0.5), p1000_of(99.5), 1.6
    jv, jm, jok = (np.asarray(a) for a in jc.crop_view_tiled(
        *(jnp.asarray(a) for a in args), jnp.int32(lo), jnp.int32(hi), jnp.float32(g),
        tile=tile, mask_outside=mask_outside))
    tv, tm, tok = (a.numpy() for a in tc.crop_view_tiled(
        *(torch.from_numpy(np.asarray(a)) for a in args), lo, hi, g, tile=tile,
        mask_outside=mask_outside))
    assert np.array_equal(tm, jm) and np.array_equal(tok, jok)
    assert tok.all() == (case != "flat")
    assert tv.dtype == np.float32 and tv.shape == jv.shape == (len(polys), tile, tile)
    ok = tok.astype(bool)
    assert np.array_equal(np.isnan(tv[ok]), np.isnan(jv[ok]))
    assert np.nanmax(np.abs(tv[ok] - jv[ok]), initial=0.0) <= 1e-6


@pytest.mark.parametrize("boxes,want", [
    ([(0, 0, 90, 100)], 128), ([(0, 0, 129, 20)], 256), ([(0, 0, 20, 250), (0, 0, 5, 5)], 256),
    ([(0, 0, 290, 380)], 300)])
def test_crop_tile_rule(boxes, want):
    """128, doubled while smaller than the largest crop side, clipped to
    the frame's short side."""
    assert tc.crop_tile(boxes, H, W) == want


def test_run_crop_launches_no_kernel_and_defaults_to_the_card(crop_ds, tmp_path, monkeypatch):
    rsk.reset_launches()
    tsk.reset_launches()
    tc.run_crop(str(crop_ds), str(crop_ds / "roi"), str(tmp_path / "o"),
                tc.CropConfig(channel=2, subset_stage=1), device="cpu", **QUIET)
    assert rsk.launches["roistats_f32"] == 0 and tsk.launches["tilestats_u16"] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tc.run_crop(str(crop_ds), str(crop_ds / "roi"), str(tmp_path / "c"),
                    tc.CropConfig(channel=2))


@pytest.mark.cuda
def test_cuda_run_crop_matches_cpu(crop_ds, tmp_path):
    """On a card: the same files as on the CPU (PNGs within one LUT step,
    TIFF16 within one count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = tc.CropConfig(channel=2, gamma=2.0, save_tiff16=True, save_tiff_raw=True)
    for dev in ("cuda", "cpu"):
        tc.run_crop(str(crop_ds), str(crop_ds / "roi"), str(tmp_path / dev), cfg,
                    device=dev, **QUIET)
    assert_pngs_match(tmp_path / "cuda", tmp_path / "cpu", step=lut_step("gray"))
    _assert_tiffs_match(tmp_path / "cuda", tmp_path / "cpu")
