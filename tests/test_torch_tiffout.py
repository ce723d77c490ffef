"""Port parity of the TIFF image outputs (``do_tif=True``) of the intensity,
FRET and rim-FRET runners against the JAX package on the CPU: the same
folders and file names, the float32 TIFFs within 1e-6 (relative to the
pixel, plus 1e-6 of the frame's largest magnitude: a corrected pixel near
zero carries the background's last float32 ulps, see test_torch_serial.py)
with NaN in the same places, the 16-bit previews within one count, and the
rows equal to the tables-only run's.  The batched runners hand such a run
to the serial runner; ``save_raw_crop_tif`` alone writes nothing; a
tables-only run copies no frame back.  With ``do_png`` the PNG outputs
come too, held to JAX's by ``assert_pngs_match`` (its helpers are imported
by the other runner tests)."""

import os

import numpy as np
import pytest
from PIL import Image

from imageprocess_tpu.core import roiio as jroiio
from imageprocess_tpu.core import tiffio as jtiffio
from imageprocess_tpu.pipelines import fret as jfret
from imageprocess_tpu.pipelines import intensity as jint
from imageprocess_tpu.pipelines import nesprin2 as jn2
from imageprocess_tpu_torch.pipelines import fret as tfret
from imageprocess_tpu_torch.pipelines import intensity as tint
from imageprocess_tpu_torch.pipelines import nesprin2 as tn2
from imageprocess_tpu_torch.report import cmaps
from imageprocess_tpu_torch.report import pilcomp as tpil
from imageprocess_tpu_torch.report import render

H, W = 96, 128
POLYS = [np.array([[10.5, 12.5], [60.5, 15.5], [55.5, 70.5], [8.5, 66.5]]),
         np.array([[70.5, 20.5], [120.5, 24.5], [110.5, 80.5]])]
QUIET = dict(log=lambda *_: None)
N2 = dict(donor_ch=1, fret_ch=2, px_um=0.223, rim_um=1.0)


def _frame(rng):
    x = rng.normal(300.0, 40.0, (H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(4):
        cy, cx = rng.integers(10, H - 10), rng.integers(10, W - 10)
        r = rng.integers(6, 18)
        x += 2500.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * r * r))
    return x.clip(0, 65535).astype(np.uint16)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    """Four stages x channels 1, 2: S01 two polygons, S02 one, S03 a PNG
    union mask, S04 no ROI at all."""
    folder = tmp_path_factory.mktemp("tifout")
    rng = np.random.default_rng(17)
    for s in (1, 2, 3, 4):
        for ch in (1, 2):
            jtiffio.write_tiff16(str(folder / f"S{s:02d}_{ch}.TIF"), _frame(rng))
    for s, rois in ((1, POLYS), (2, POLYS[:1])):
        jroiio.save_roi_bundle(str(folder / "roi" / f"S{s:02d}.json"), f"S{s:02d}",
                               (H, W), rois)
    mask = np.zeros((H, W), np.uint8)
    mask[20:60, 30:100] = 255
    Image.fromarray(mask).save(str(folder / "roi" / "S03.png"))
    return folder


def _tiffs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith((".tif", ".tmp")))


def _assert_tiffs_match(troot, jroot, expect):
    names = _tiffs(troot)
    assert names == _tiffs(jroot)
    assert len(names) == expect and not any(n.endswith(".tmp") for n in names)
    for name in names:
        t = np.array(Image.open(os.path.join(troot, name)))
        j = np.array(Image.open(os.path.join(jroot, name)))
        assert t.dtype == j.dtype and t.shape == j.shape == (H, W), name
        if t.dtype == np.float32:
            assert np.array_equal(np.isnan(t), np.isnan(j)), name
            ok = ~np.isnan(j)
            scale = np.abs(j[ok]).max() if ok.any() else 0.0
            err = np.abs(t[ok].astype(np.float64) - j[ok])
            assert (err <= 1e-6 * np.abs(j[ok]) + 1e-6 * scale).all(), (name, err.max())
        else:
            assert t.dtype == np.uint16, name
            assert np.abs(t.astype(np.int64) - j.astype(np.int64)).max() <= 1, name
    return names


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for k, v in rb.items():
            assert ra[k] == v or (v != v and ra[k] != ra[k]), k


@pytest.mark.parametrize("mask_outside", [False, True], ids=["plain", "mask_outside"])
def test_intensity_tiffs_match_jax(ds, tmp_path, mask_outside):
    kw = dict(channels=(1, 2), do_tif=True, tif_mask_outside=mask_outside,
              auto_lo=2.0, auto_hi=98.0)
    jrows = jint.run_intensity(str(ds), jint.IntensityConfig(**kw),
                               out_root=str(tmp_path / "j"), **QUIET)
    trows = tint.run_intensity(str(ds), tint.IntensityConfig(**kw),
                               out_root=str(tmp_path / "t"), device="cpu", **QUIET)
    assert len(trows) == len(jrows) == 4
    # three keys with ROIs (polygons, polygons, PNG mask) x 2 channels x (32, 16 bit)
    names = _assert_tiffs_match(tmp_path / "t", tmp_path / "j", 12)
    assert "TIFF/S03_ch2_bgcorr.tif" in names and \
        "TIFF16/S01_ch1_bgcorr_preview.tif" in names
    bc = np.array(Image.open(tmp_path / "t" / "TIFF" / "S01_ch1_bgcorr.tif"))
    assert (bc >= 0).all() and ((bc[:5] == 0).all() == mask_outside)
    tables = tint.run_intensity(str(ds), tint.IntensityConfig(channels=(1, 2)),
                                out_root=str(tmp_path / "tables"), device="cpu",
                                **QUIET)
    _rows_equal(trows, tables)
    assert _tiffs(tmp_path / "tables") == []


def test_intensity_whole_frame_roi_writes_unmasked_tiffs(ds, tmp_path):
    """``skip_no_roi=False``: S04 is quantified as ROI 0 and has no union,
    so ``tif_mask_outside`` leaves its frames as they are."""
    kw = dict(channels=(1,), do_tif=True, tif_mask_outside=True, skip_no_roi=False,
              subset_stage=4)
    jint.run_intensity(str(ds), jint.IntensityConfig(**kw),
                       out_root=str(tmp_path / "j"), **QUIET)
    trows = tint.run_intensity(str(ds), tint.IntensityConfig(**kw),
                               out_root=str(tmp_path / "t"), device="cpu", **QUIET)
    assert [r["roi"] for r in trows] == [0]
    _assert_tiffs_match(tmp_path / "t", tmp_path / "j", 2)
    assert np.array(Image.open(tmp_path / "t" / "TIFF" / "S04_ch1_bgcorr.tif")).min() == 0


@pytest.mark.parametrize("ratio_mode", ["FRET/Donor", "Donor/FRET"])
def test_fret_tiffs_match_jax(ds, tmp_path, ratio_mode):
    kw = dict(donor_ch=1, acceptor_ch=2, ratio_mode=ratio_mode, do_tif=True)
    jrows = jfret.run_fret(str(ds), jfret.FretConfig(**kw),
                           out_root=str(tmp_path / "j"), **QUIET)
    logs = []
    trows = tfret.run_fret(str(ds), tfret.FretConfig(**kw),
                           out_root=str(tmp_path / "t"), device="cpu", log=logs.append)
    assert len(trows) == len(jrows) == 3
    # RAT 32 + 16 for all four pairs, RAT_ROI_masked 32 + 16 for the two with ROIs
    names = _assert_tiffs_match(tmp_path / "t", tmp_path / "j", 12)
    suffix = "FoverD" if ratio_mode == "FRET/Donor" else "DoverF"
    assert f"RAT/32bit/S04_ratio_{suffix}.tif" in names
    assert f"RAT_ROI_masked/16bit/S02_ratio_{suffix}_preview.tif" in names
    assert not any("RAT_ROI_masked" in n and ("S03" in n or "S04" in n) for n in names)
    assert sum(tfret.t("fret_roi_missing").format(tag=f"S0{s}") in logs
               for s in (3, 4)) == 2
    roi = np.array(Image.open(tmp_path / "t" / "RAT_ROI_masked" / "32bit"
                              / f"S01_ratio_{suffix}.tif"))
    assert np.isnan(roi[0, 0]) and np.isfinite(roi[40, 30])
    tables = tfret.run_fret(str(ds), tfret.FretConfig(**dict(kw, do_tif=False)),
                            out_root=str(tmp_path / "tables"), device="cpu", **QUIET)
    _rows_equal(trows, tables)
    assert _tiffs(tmp_path / "tables") == []


def test_fret_roi_union_scope_tiffs_match_jax(ds, tmp_path):
    """The full-frame step (its own union) instead of the tiled one."""
    kw = dict(donor_ch=1, acceptor_ch=2, do_tif=True, bg_scope="roi_union",
              subset_stage=1)
    jfret.run_fret(str(ds), jfret.FretConfig(**kw), out_root=str(tmp_path / "j"), **QUIET)
    tfret.run_fret(str(ds), tfret.FretConfig(**kw), out_root=str(tmp_path / "t"),
                   device="cpu", **QUIET)
    _assert_tiffs_match(tmp_path / "t", tmp_path / "j", 4)


@pytest.mark.parametrize("ratio_mode", ["FRET/Donor", "Donor/FRET"])
def test_nesprin2_tiffs_match_jax(ds, tmp_path, ratio_mode):
    kw = dict(N2, ratio_mode=ratio_mode, do_tif=True, sat_filter_on=True,
              sat_threshold=2500.0)
    jrows = jn2.run_nesprin2(str(ds), jn2.Nesprin2Config(**kw),
                             out_root=str(tmp_path / "j"), **QUIET)
    trows = tn2.run_nesprin2(str(ds), tn2.Nesprin2Config(**kw),
                             out_root=str(tmp_path / "t"), device="cpu", **QUIET)
    assert len(trows) == len(jrows) == 3
    names = _assert_tiffs_match(tmp_path / "t", tmp_path / "j", 4)
    suffix = "FoverD" if ratio_mode == "FRET/Donor" else "DoverF"
    assert names == sorted(f"TIF/ratio32_{k}/S0{s}_ratio_{k}_{suffix}.tif"
                           for k in ("full", "rim") for s in (1, 2))
    full = np.array(Image.open(tmp_path / "t" / names[0]))
    rim = np.array(Image.open(tmp_path / "t" / names[2]))
    assert np.isnan(full).any()                         # the saturated pixels
    on = np.isfinite(rim)
    assert 0 < on.sum() < on.size // 4 and np.array_equal(rim[on], full[on])
    tables = tn2.run_nesprin2(str(ds), tn2.Nesprin2Config(**dict(kw, do_tif=False)),
                              out_root=str(tmp_path / "tables"), device="cpu", **QUIET)
    _rows_equal(trows, tables)
    assert _tiffs(tmp_path / "tables") == []


def _run(runner, folder, out, **kw):
    """(rows, logs) of one of the six runners with the config options *kw*."""
    mod, cfg = {
        "run_intensity": (tint, lambda: tint.IntensityConfig(channels=(1, 2), **kw)),
        "run_intensity_batched": (tint, lambda: tint.IntensityConfig(channels=(1, 2), **kw)),
        "run_fret": (tfret, lambda: tfret.FretConfig(donor_ch=1, acceptor_ch=2, **kw)),
        "run_fret_batched": (tfret, lambda: tfret.FretConfig(donor_ch=1, acceptor_ch=2, **kw)),
        "run_nesprin2": (tn2, lambda: tn2.Nesprin2Config(**N2, **kw)),
        "run_nesprin2_batched": (tn2, lambda: tn2.Nesprin2Config(**N2, **kw)),
    }[runner]
    logs = []
    rows = getattr(mod, runner)(str(folder), cfg(), out_root=str(out), log=logs.append,
                                device="cpu")
    return rows, logs


@pytest.mark.parametrize("name,note", [("intensity", "int_images_serial"),
                                       ("fret", None),
                                       ("nesprin2", "n2_images_serial")])
def test_batched_runner_hands_over_to_the_serial_one(ds, tmp_path, name, note):
    """With ``do_tif`` the batched runner writes what the serial runner
    writes, rows and files, after the JAX runner's log line (FRET's hands
    over silently there too)."""
    srows, _ = _run(f"run_{name}", ds, tmp_path / "s", do_tif=True)
    brows, logs = _run(f"run_{name}_batched", ds, tmp_path / "b", do_tif=True)
    _rows_equal(brows, srows)
    names = _tiffs(tmp_path / "b")
    assert names and names == _tiffs(tmp_path / "s")
    for n in names:
        assert (tmp_path / "b" / n).read_bytes() == (tmp_path / "s" / n).read_bytes()
    if note is not None:
        assert logs[0] == tint.t(note) or logs[1] == tint.t(note)
    trows, _ = _run(f"run_{name}_batched", ds, tmp_path / "tables")
    _rows_equal(brows, trows)


RUNNERS = ["run_intensity", "run_intensity_batched", "run_fret", "run_fret_batched",
           "run_nesprin2", "run_nesprin2_batched"]


ROIS = {"S01": POLYS, "S02": POLYS[:1]}


def _jax_run(kind, folder, out, **kw):
    """The JAX package's serial runner of workload *kind* (its batched
    runner hands an image run to it, as the port's does)."""
    if kind == "intensity":
        jint.run_intensity(str(folder), jint.IntensityConfig(channels=(1, 2), **kw),
                           out_root=str(out), **QUIET)
    elif kind == "fret":
        jfret.run_fret(str(folder), jfret.FretConfig(donor_ch=1, acceptor_ch=2, **kw),
                       out_root=str(out), **QUIET)
    else:
        jn2.run_nesprin2(str(folder), jn2.Nesprin2Config(**N2, **kw),
                         out_root=str(out), **QUIET)


def _crop_colorbar(name):
    """The crop under the inset colorbar of a FRET or rim-FRET crop PNG of
    *ds* (``PNG_RAT/crop/S01_roi2_FoverD.png``,
    ``PNG/CROP_RATIO/S01_roi1_FoverD_rim.png``); None for the others."""
    if "PNG_RAT/crop" not in name and "CROP_RATIO" not in name:
        return None
    base = os.path.basename(name)
    roi = int(base.split("_roi")[1].split("_")[0])
    return crop_dims(ROIS[base[:3]][roi - 1], W, H)


@pytest.mark.parametrize("runner", RUNNERS)
def test_do_png_still_raises(ds, tmp_path, runner):
    """``do_png`` with ``do_tif``, each runner at its PNG defaults (the FRET
    and rim-FRET crops with their inset colorbar, 500-px crops at dpi
    300): the JAX serial runner's files -- the TIFFs to the bars above, the
    PNGs to ``assert_pngs_match``'s -- and the rows of the tables-only run.
    (The name is kept from when the option raised.)"""
    rows, _ = _run(runner, ds, tmp_path / "t", do_png=True, do_tif=True)
    kind = runner.split("_")[1]
    _jax_run(kind, ds, tmp_path / "j", do_png=True, do_tif=True,
             **({} if kind == "intensity" else {"show_colorbar": False}))
    cmap = {"intensity": "gray", "fret": "jet", "nesprin2": "turbo"}[kind]
    names = assert_pngs_match(
        tmp_path / "t", tmp_path / "j", step=lut_step(cmap, "gray"),
        expect={"intensity": 14, "fret": 7, "nesprin2": 13}[kind],
        colorbar=None if kind == "intensity" else _crop_colorbar)
    assert sum(_crop_colorbar(n) is not None for n in names) == \
        {"intensity": 0, "fret": 3, "nesprin2": 3}[kind]
    _assert_tiffs_match(tmp_path / "t", tmp_path / "j",
                        {"intensity": 12, "fret": 12, "nesprin2": 4}[kind])
    tables, _ = _run(runner, ds, tmp_path / "tables")
    _rows_equal(rows, tables)


@pytest.mark.parametrize("runner", ["run_intensity", "run_intensity_batched"])
def test_save_raw_crop_tif_alone_writes_nothing(ds, tmp_path, runner):
    """The raw crop TIFFs belong to the PNG crops (the JAX writer reaches
    them only with ``do_png``): alone the option gives the tables-only run."""
    rows, logs = _run(runner, ds, tmp_path / "o", save_raw_crop_tif=True)
    plain, _ = _run(runner, ds, tmp_path / "p")
    _rows_equal(rows, plain)
    assert _tiffs(tmp_path / "o") == []
    assert tint.t("int_images_serial") not in logs
    jint.run_intensity(str(ds), jint.IntensityConfig(channels=(1, 2),
                                                     save_raw_crop_tif=True),
                       out_root=str(tmp_path / "j"), **QUIET)
    assert _tiffs(tmp_path / "j") == []


@pytest.mark.parametrize("runner", RUNNERS)
def test_frames_come_back_only_for_the_tiffs(ds, tmp_path, monkeypatch, runner):
    """A tables-only run makes no device-to-host copy of a frame: every
    such copy goes through ``pipelines.intensity.to_host`` (under
    ``frames_on_host``)."""
    calls = []
    real = tint.to_host
    monkeypatch.setattr(tint, "to_host", lambda x, *a: (
        calls.append(tuple(x.shape)), real(x, *a))[1])
    _run(runner, ds, tmp_path / "tables")
    assert calls == []
    _run(runner, ds, tmp_path / "tif", do_tif=True)
    per = {"intensity": [(2, H, W)] * 3, "fret": [(H, W)] * 6,
           "nesprin2": [(H, W)] * 4}[runner.split("_")[1]]
    assert sorted(calls) == sorted(per)


# ------------------------------------------------------------------ PNG outputs
# (the helpers are imported by the other runner tests; no matplotlib here:
# the card machine has none)


def lut_step(*cms) -> int:
    """The largest change of any channel between two neighbouring entries
    of the LUTs of *cms* (names or LUTs): one LUT step."""
    return max(int(np.abs(np.diff(cmaps.lut_u8(c)[:, :3].astype(np.int16), axis=0)).max())
               for c in cms)


def colorbar_rect_px(img_w, img_h, canvas_w, canvas_h):
    """(left, right, top, bottom) of the colorbar's axes in canvas pixels."""
    fx, fy, fw, fh = tpil.colorbar_rect(img_w, img_h)
    return (fx * canvas_w, (fx + fw) * canvas_w,
            (1.0 - fy - fh) * canvas_h, (1.0 - fy) * canvas_h)


def png_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".png"))


def colorbar_zone(img_w, img_h, canvas_w, canvas_h, dpi=300):
    """The canvas box (x0, x1, y0, y1) that the inset colorbar, its ticks and
    its text may cover: from 3 px left of the bar to the canvas's right
    edge, a 10 pt line above and below the bar."""
    left, _, top, bottom = colorbar_rect_px(img_w, img_h, canvas_w, canvas_h)
    pad = 1.2 * 10 * dpi / 72.0
    return (int(left) - 3, canvas_w, max(0, int(top - pad)), int(bottom + pad) + 1)


def crop_dims(P, W, H):
    """(width, height) of the reference crop window of polygon *P*."""
    x0, x1, y0, y1 = render.crop_bbox_poly(np.asarray(P), W, H)
    return x1 - x0 + 1, y1 - y0 + 1


def assert_pngs_match(troot, jroot, step=1, expect=None, colorbar=None, frac=1e-3):
    """The PNG sets under two roots: the same names (*expect* of them when
    given), canvas sizes and decoded RGB pixels, equal except at most *frac*
    of a file's pixels within *step* (one LUT step: the ratio frames of
    the two packages differ by float32 ulps, so a pixel on a LUT boundary
    may move by one entry).  ``colorbar(name)`` gives the (width, height)
    of the image under an inset colorbar in the *troot* file (None for a
    file without one); the JAX package lays that colorbar out with
    matplotlib, which also resamples the image beneath it, so *jroot* then
    holds the same run without the colorbar, :func:`colorbar_zone` is left
    out of the comparison and must hold a drawing (test_torch_render.py
    holds the colorbar to matplotlib's).  Returns the names."""
    names = png_files(troot)
    assert names == png_files(jroot)
    assert names and (expect is None or len(names) == expect), names
    for name in names:
        t = np.array(Image.open(os.path.join(troot, name)).convert("RGB")).astype(np.int16)
        j = np.array(Image.open(os.path.join(jroot, name)).convert("RGB")).astype(np.int16)
        assert t.shape == j.shape, (name, t.shape, j.shape)
        d = np.abs(t - j).max(-1)
        dims = colorbar(name) if colorbar is not None else None
        if dims is not None:
            x0, x1, y0, y1 = colorbar_zone(*dims, t.shape[1], t.shape[0])
            assert (d[y0:y1, x0:x1] > 0).sum() > 20, (name, "no colorbar")
            d[y0:y1, x0:x1] = 0
        assert d.max() <= step and (d > 0).mean() <= frac, (name, d.max(), (d > 0).mean())
    return names
