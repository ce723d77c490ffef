"""Port parity of the serial intensity and FRET runners on the CPU
(``device="cpu"``): their host units (``core.tiffio``, ``core.roiio``'s
mask helpers, ``core.runlog``), their device programs
(``intensity_step``, ``intensity_step_tiled``, ``fret_step``,
``fret_step_tiled``) and ``run_intensity`` / ``run_fret`` end to end,
against the JAX package on the same numpy-seeded inputs.

Bars: masks, area_px, npx and every string and integer column exact;
mean, std and vsum within 1e-5 relative (sums in another order); the
interpolated values -- the quantiles, backgrounds and eps -- within 4
float32 ulps of the largest value the interpolation reads (the ROI's
vmin/vmax, the frame's largest magnitude), and vmin/vmax bit-equal where
the backgrounds are.  Why not bit-equal: XLA's CPU compiler computes the
weight g = rem / 100000 as rem * (1 / 100000), one ulp off the correctly
rounded quotient for about half of all n (even op by op inside vmap), and
contracts lo + g * (hi - lo) and hist-mode's lo + (first + 0.5) * width
into fused multiply-adds; the port and its kernels round each operation,
as the eager JAX functions do (``tests/test_torch_background.py`` holds
those bit-equal).  The order statistics themselves are the same: another
one would be off by a whole gap between two values.  The CSV and XLSX
reports: within 1e-4 relative, strings exact.
"""

import csv
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.core import roiio as jroiio
from imageprocess_tpu.core import runlog as jrunlog
from imageprocess_tpu.core import tiffio as jtiffio
from imageprocess_tpu.geom.polygon import pad_polygons as jpad
from imageprocess_tpu.ops import roistats as jrs
from imageprocess_tpu.pipelines import fret as jfret
from imageprocess_tpu.pipelines import intensity as jint
from imageprocess_tpu_torch.core import roiio as troiio
from imageprocess_tpu_torch.core import runlog as trunlog
from imageprocess_tpu_torch.core import tiffio as ttiffio
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.pipelines import fret as tfret
from imageprocess_tpu_torch.pipelines import intensity as tint
from imageprocess_tpu_torch.report import render as trender
from imageprocess_tpu_torch.report import xlsxlite
from test_torch_tiffout import assert_pngs_match, lut_step

STEP_H, STEP_W = 70, 90
STEP_POLYS = [np.array([[5.5, 6.5], [40.5, 8.5], [36.5, 44.5], [4.5, 40.5]], np.float32),
              np.array([[50, 20], [85, 24], [80, 66], [47, 60]], np.float32),
              np.array([[30.2, 50.7], [60.9, 52.1], [44.4, 68.8]], np.float32)]
M_RTOL = 1e-5


def _close(got, want, rtol, what):
    """Bit-equal for *rtol* 0.0, else within *rtol* relative; NaN where
    NaN."""
    g = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, what
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), what
    g, w = g[~nan].astype(np.float64), w[~nan].astype(np.float64)
    if rtol == 0.0:
        assert np.array_equal(g, w), (what, g, w)
    else:
        err = np.abs(g - w) / np.maximum(np.abs(w), 1e-9)
        assert err.size == 0 or err.max() <= rtol, (what, err.max())


def _interp_close(got, want, scale, what):
    """|got - want| <= 4 float32 ulps of *scale* (broadcasting), NaN where
    NaN."""
    g = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, what
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), what
    bound = 4.0 * np.spacing(np.abs(np.broadcast_to(scale, w.shape))
                             .astype(np.float32)).astype(np.float64)
    bad = ~nan & ~(np.abs(g - w) <= bound)
    assert not bad.any(), (what, g[bad], w[bad])


RATIO_RTOL = 1e-4


def _stats_close(got, want, what, same_input=True, ratio=False):
    """*same_input*: the backgrounds (and eps) came out bit-equal, so the
    corrected frames are the same and vmin/vmax must be too; else they
    move with the background's last ulps and take the interpolation bar,
    and a ratio channel (channel 0 with *ratio*), which divides by
    denominator + eps and so magnifies that shift where the denominator
    nears -eps, is held to RATIO_RTOL."""
    if ratio and not same_input:
        for f in ("mean", "median", "std", "p5", "p95", "vmin", "vmax", "vsum"):
            _close(got[f][0], want[f][0], RATIO_RTOL, f"{what} ratio {f}")
        got = {f: v[1:] for f, v in got.items()}
        want = {f: v[1:] for f, v in want.items()}
    scale = np.fmax(np.abs(np.asarray(want["vmin"])), np.abs(np.asarray(want["vmax"])))
    interp = ("median", "p5", "p95") + (() if same_input else ("vmin", "vmax"))
    for f in ("mean", "median", "std", "p5", "p95", "vmin", "vmax", "vsum", "npx"):
        if f in interp:
            _interp_close(got[f], want[f], scale, f"{what} {f}")
        else:
            _close(got[f], want[f], M_RTOL if f in ("mean", "std", "vsum") else 0.0,
                   f"{what} {f}")


def _same(got, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want))


def _max_abs(*frames):
    return max(float(np.nanmax(np.abs(np.asarray(f, np.float64)))) for f in frames)


def _step_frames(kind, C, seed):
    rng = np.random.default_rng(seed)
    if kind == "u16":
        return rng.integers(10, 3000, (C, STEP_H, STEP_W)).astype(np.uint16)
    if kind == "u8":
        return rng.integers(0, 256, (C, STEP_H, STEP_W)).astype(np.uint8)
    x = rng.normal(500.0, 200.0, (C, STEP_H, STEP_W)).astype(np.float32)
    x[rng.random(x.shape) < 0.03] = np.nan
    return x


def _padded(polys, nb=8, vb=32):
    pv = np.zeros((nb, vb, 2), np.float32)
    pv[:len(polys)] = jpad(polys, vb)
    valid = np.zeros(nb, bool)
    valid[:len(polys)] = True
    return pv, valid


@pytest.mark.parametrize("bg_scope", ["full", "roi_union"])
@pytest.mark.parametrize("bg_mode", ["percentile", "hist-mode", "none"])
def test_intensity_step_matches_jax(bg_mode, bg_scope):
    clip_neg = bg_scope == "full"      # both, over the cases
    kind = {"percentile": "u16", "hist-mode": "f32", "none": "u8"}[bg_mode]
    imgs = _step_frames(kind, 2, 1)
    pv, valid = _padded(STEP_POLYS)
    p1000s = np.array([1000, 2500], np.int32)
    kw = dict(bg_mode=bg_mode, bg_scope=bg_scope, clip_neg=clip_neg, bg_stride=3)
    js, ja, jb, _ = jint.intensity_step(jnp.asarray(imgs), jnp.asarray(pv),
                                          jnp.asarray(valid), jnp.asarray(p1000s),
                                          **kw)
    ts, ta, tb, _ = tint.intensity_step(torch.from_numpy(imgs), torch.from_numpy(pv),
                                          torch.from_numpy(valid), list(p1000s), **kw)
    _close(ta, ja, 0.0, "area_px")
    _interp_close(tb, jb, _max_abs(imgs), "bgs")
    _stats_close(ts, js, "intensity_step", _same(tb, jb))


@pytest.mark.parametrize("bg_scope", ["full", "roi_union"])
def test_intensity_step_masks_and_whole_frame_match_jax(bg_scope):
    """Masks given directly (a PNG union mask; the whole frame as ROI 0)."""
    imgs = _step_frames("u16", 2, 2)
    mask = np.zeros((1, STEP_H, STEP_W), bool)
    mask[0, 10:40, 20:70] = True
    for masks in (mask, np.ones_like(mask)):
        args = (np.zeros((1, 32, 2), np.float32), np.ones(1, bool),
                np.array([1000, 1000], np.int32), masks)
        kw = dict(bg_scope=bg_scope, use_masks=True)
        js, ja, jb, _ = jint.intensity_step(jnp.asarray(imgs),
                                            *(jnp.asarray(a) for a in args), **kw)
        ts, ta, tb, _ = tint.intensity_step(torch.from_numpy(imgs),
                                            *(torch.from_numpy(a) for a in args), **kw)
        _close(ta, ja, 0.0, "area_px")
        _interp_close(tb, jb, _max_abs(imgs), "bgs")
        _stats_close(ts, js, "intensity_step masks", _same(tb, jb))


@pytest.mark.parametrize("clip_neg", [True, False])
@pytest.mark.parametrize("bg_mode", ["percentile", "hist-mode", "none"])
def test_intensity_step_tiled_matches_jax(bg_mode, clip_neg):
    kind = {"percentile": "u16", "hist-mode": "f32", "none": "u8"}[bg_mode]
    imgs = _step_frames(kind, 2, 3)
    tile = jrs.choose_tile(STEP_POLYS, STEP_H, STEP_W)
    offs = jrs.tile_offsets(STEP_POLYS, STEP_H, STEP_W, tile)
    lpv, offs_pad, valid = jrs.pad_local_polys(STEP_POLYS, offs, 8, 32)
    p1000s = np.array([1000, 5000], np.int32)
    kw = dict(tile=tile, bg_mode=bg_mode, clip_neg=clip_neg, bg_stride=4)
    js, ja, jb, _ = jint.intensity_step_tiled(
        jnp.asarray(imgs), jnp.asarray(lpv), jnp.asarray(offs_pad),
        jnp.asarray(valid), jnp.asarray(p1000s), **kw)
    ts, ta, tb, _ = tint.intensity_step_tiled(
        torch.from_numpy(imgs), torch.from_numpy(lpv), torch.from_numpy(offs_pad),
        torch.from_numpy(valid), list(p1000s), **kw)
    _close(ta, ja, 0.0, "area_px")
    _interp_close(tb, jb, _max_abs(imgs), "bgs")
    _stats_close(ts, js, "intensity_step_tiled", _same(tb, jb))
    # the tiled program gives the full-frame program's statistics
    pv, fvalid = _padded(STEP_POLYS)
    fs, fa, _, _ = tint.intensity_step(
        torch.from_numpy(imgs), torch.from_numpy(pv), torch.from_numpy(fvalid),
        list(p1000s), bg_mode=bg_mode, clip_neg=clip_neg, bg_stride=4)
    _close(ta, fa, 0.0, "tiled vs full area")
    _stats_close(ts, fs, "tiled vs full")


@pytest.mark.parametrize("bg_scope", ["full", "roi_union"])
@pytest.mark.parametrize("bg_mode", ["percentile", "hist-mode", "none"])
def test_fret_step_matches_jax(bg_mode, bg_scope):
    # both clip_neg values and both ratio modes, over the cases
    clip_neg, flip = (True, False) if bg_scope == "full" else (False, True)
    D, A = _step_frames("u16", 2, 4)
    pv, valid = _padded(STEP_POLYS)
    sc = (1000, 2000, 1000, 5.0)
    kw = dict(bg_mode=bg_mode, bg_scope=bg_scope, clip_neg=clip_neg, flip=flip)
    jo = jfret.fret_step(jnp.asarray(D), jnp.asarray(A), jnp.asarray(pv),
                         jnp.asarray(valid), jnp.int32(sc[0]), jnp.int32(sc[1]),
                         jnp.int32(sc[2]), jnp.float32(sc[3]), **kw)
    to = tfret.fret_step(torch.from_numpy(D), torch.from_numpy(A),
                         torch.from_numpy(pv), torch.from_numpy(valid), *sc, **kw)
    _close(to[1], jo[1], 0.0, "area")
    _interp_close(to[2][0], jo[2][0], _max_abs(D), "Db")
    _interp_close(to[2][1], jo[2][1], _max_abs(A), "Ab")
    _interp_close(to[2][2], jo[2][2], _max_abs(D, A), "eps")
    _close(to[6], jo[6], 0.0, "union")
    _stats_close(to[0], jo[0], "fret_step", _same(torch.stack(to[2]), np.stack(jo[2])),
                 ratio=True)


@pytest.mark.parametrize("bg_scope", ["full", "roi_union"])
@pytest.mark.parametrize("bg_mode", ["percentile", "hist-mode", "none"])
def test_fret_step_tiled_matches_jax(bg_mode, bg_scope):
    clip_neg, flip = (False, True) if bg_scope == "full" else (True, False)
    D, A = _step_frames("f32" if bg_mode == "hist-mode" else "u16", 2, 5)
    tile = jrs.choose_tile(STEP_POLYS, STEP_H, STEP_W)
    offs = jrs.tile_offsets(STEP_POLYS, STEP_H, STEP_W, tile)
    lpv, offs_pad, lvalid = jrs.pad_local_polys(STEP_POLYS, offs, 8, 32)
    pv, _ = _padded(STEP_POLYS)
    sc = (1000, 2000, 1000, 5.0)
    kw = dict(tile=tile, bg_mode=bg_mode, bg_scope=bg_scope, clip_neg=clip_neg,
              flip=flip)
    jo = jfret.fret_step_tiled(
        jnp.asarray(D), jnp.asarray(A), jnp.asarray(pv), jnp.asarray(lpv),
        jnp.asarray(offs_pad), jnp.asarray(lvalid), jnp.int32(sc[0]),
        jnp.int32(sc[1]), jnp.int32(sc[2]), jnp.float32(sc[3]), **kw)
    to = tfret.fret_step_tiled(
        *(torch.from_numpy(a) for a in (D, A, pv, lpv, offs_pad, lvalid)), *sc, **kw)
    _close(to[1], jo[1], 0.0, "area")
    _interp_close(to[2][0], jo[2][0], _max_abs(D), "Db")
    _interp_close(to[2][1], jo[2][1], _max_abs(A), "Ab")
    _interp_close(to[2][2], jo[2][2], _max_abs(D, A), "eps")
    if bg_scope == "roi_union":
        _close(to[6], jo[6], 0.0, "union")
    else:
        assert to[6] is None        # not rasterized: the tables never read it
    _stats_close(to[0], jo[0], "fret_step_tiled",
                 _same(torch.stack(to[2]), np.stack(jo[2])), ratio=True)


# ------------------------------------------------------------------ host units

def _write_rgb(path, rgb):
    from PIL import Image

    Image.fromarray(rgb).save(str(path), format="TIFF")


@pytest.mark.parametrize("kind", ["u16", "u8", "f32", "rgb"])
def test_tiffio_reads_match_jax(tmp_path, kind):
    """read_tiff / read_2d (dtype kept or cast): the native decoder, or PIL
    for what it does not take (RGB)."""
    rng = np.random.default_rng(2)
    path = tmp_path / f"x_{kind}.tif"
    if kind == "u16":
        jtiffio.write_tiff16(str(path), rng.integers(0, 65536, (33, 47)).astype(np.uint16))
    elif kind == "u8":
        jtiffio.write_tiff8(str(path), rng.integers(0, 256, (33, 47)).astype(np.uint8))
    elif kind == "f32":
        x = rng.normal(0, 100, (33, 47)).astype(np.float32)
        x[3, 4] = np.nan
        jtiffio.write_tiff32(str(path), x)
    else:
        _write_rgb(path, rng.integers(0, 256, (33, 47, 3)).astype(np.uint8))
    got, want = ttiffio.read_tiff(str(path)), jtiffio.read_tiff(str(path))
    assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    for dtype in (None, np.float32):
        got = ttiffio.read_2d(str(path), dtype=dtype)
        want = jtiffio.read_2d(str(path), dtype=dtype)
        assert got.dtype == want.dtype and got.shape == want.shape == (33, 47)
        assert np.array_equal(got, want, equal_nan=True)


def test_squeeze_rules_match_jax():
    rng = np.random.default_rng(3)
    for shape in [(5, 6), (5, 6, 3), (2, 5, 6), (4, 5, 6, 3), (7, 2, 9)]:
        a = rng.integers(0, 100, shape)
        assert np.array_equal(ttiffio.squeeze_first_channel(a),
                              jtiffio.squeeze_first_channel(a))


def test_roiio_mask_helpers_match_jax(tmp_path):
    """load_mask_png cropped and zero-padded to the frame, load_polys_or_mask
    (JSON first, an empty JSON falls to the PNG, nothing), count_rois
    (JSON, PNG, nothing, an unreadable JSON)."""
    from PIL import Image

    rng = np.random.default_rng(4)
    m = (rng.random((40, 50)) < 0.3).astype(np.uint8) * 255
    Image.fromarray(m).save(tmp_path / "a.png")
    for shape in (None, (40, 50), (30, 60), (45, 44)):
        got = troiio.load_mask_png(str(tmp_path / "a.png"), shape)
        want = jroiio.load_mask_png(str(tmp_path / "a.png"), shape)
        assert got.dtype == want.dtype == bool and np.array_equal(got, want)
    jroiio.save_roi_bundle(str(tmp_path / "b.json"), "b", (40, 50),
                           [np.array([[1, 1], [9, 2], [5, 8]], float)])
    jroiio.save_roi_bundle(str(tmp_path / "a.json"), "a", (40, 50), [])
    (tmp_path / "c.json").write_text("{not json")
    for base in ("a", "b", "c", "d"):
        b = str(tmp_path / base)
        assert troiio.count_rois(b) == jroiio.count_rois(b), base
        if base == "c":
            continue
        (tp, tm), (jp, jm) = (troiio.load_polys_or_mask(b, (40, 50)),
                              jroiio.load_polys_or_mask(b, (40, 50)))
        assert (tp is None) == (jp is None) and (tm is None) == (jm is None), base
        if jp is not None:
            assert all(np.array_equal(x, y) for x, y in zip(tp, jp))
        if jm is not None:
            assert np.array_equal(tm, jm)


def test_runlog_matches_jax(tmp_path, monkeypatch):
    """RunLogger's file ([START], the lines, [END]) and Progress's lines on
    the same clock, over more ticks than the ETA's window."""
    clock = iter(np.arange(1000.0, 2000.0, 0.25))
    now = lambda: float(next(clock))  # noqa: E731
    for mod in (trunlog, jrunlog):
        monkeypatch.setattr(mod.time, "time", now)
    out = {}
    for name, mod in (("t", trunlog), ("j", jrunlog)):
        lines = []
        log = mod.RunLogger(str(tmp_path / name), echo=lines.append)
        prog = mod.Progress(20, log=log)
        for n in (2, 1, 3, 1, 2, 1, 1, 2, 1, 3, 1, 2):
            prog.step(n, label="S01")
        log("done", 3)
        log.close()
        with open(log.path, encoding="utf-8") as f:
            text = f.read().splitlines()
        out[name] = (lines, text[1:-1], text[0][:8], text[-1][:6])
    assert out["t"] == out["j"]
    assert out["t"][2:] == ("[START] ", "[END] ") and out["t"][0][-2] == \
        "[100.0%] 20/20 ETA 00:00 S01"


# ------------------------------------------------------------------ end to end

PA = np.array([[20, 20], [70, 25], [65, 80], [15, 75]], float)
PB = np.array([[90, 60], [140, 65], [135, 110], [85, 105]], float)
H, W = 120, 160
FULL_ROI = np.array([[-4, -4], [W + 4, -4], [W + 4, H + 4], [-4, H + 4]], float)
DATA_MAX = 4096.0          # every test frame's values lie below it
MOMENTS = ("_mean", "_std", "_vsum")
INTERP = ("_median", "_p5", "_p95", "_bg")


def _scale(row, col):
    """The largest value a quantile's interpolation reads."""
    if col.startswith("ch") and col.endswith(("_median", "_p5", "_p95")):
        ch = col[:col.index("_")]
        return np.nanmax([abs(row[f"{ch}_vmin"]), abs(row[f"{ch}_vmax"])])
    if col.startswith("ratio_"):
        return 2.0 * np.nanmax([abs(row[c]) for c in
                                ("ratio_median", "ratio_p5", "ratio_p95")])
    return DATA_MAX


def _cell_ok(row_t, row_j, col) -> bool:
    a, b = row_t[col], row_j[col]
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if isinstance(b, float) and (col.endswith(INTERP) or col == "eps"):
        return abs(a - b) <= 4.0 * np.spacing(np.float32(_scale(row_j, col)))
    if isinstance(b, float) and col.endswith(MOMENTS):
        return abs(a - b) <= 1e-5 * max(abs(b), 1e-9)
    if col.endswith(("_vmin", "_vmax")):
        ch = col[:col.index("_")]
        if row_t[f"{ch}_bg"] != row_j[f"{ch}_bg"]:  # moved with the bg's ulps
            return abs(a - b) <= 4.0 * np.spacing(np.float32(_scale(row_j, col)))
    return a == b and type(a) is type(b)


def _assert_rows_match(trows, jrows):
    key = lambda r: (r["stage"], r["time"], r["roi"])  # noqa: E731
    assert [key(r) for r in trows] == [key(r) for r in jrows]
    for rt, rj in zip(trows, jrows):
        assert list(rt) == list(rj)
        for col in rj:
            assert _cell_ok(rt, rj, col), (key(rj), col, rt[col], rj[col])


def _cells_match(a, b):
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except (TypeError, ValueError):
        return False
    return (math.isnan(fa) and math.isnan(fb)) or abs(fa - fb) <= 1e-4 * max(abs(fb), 1e-9)


def _assert_reports_match(dir_t, dir_j, stem):
    with open(os.path.join(dir_t, stem + ".csv"), newline="") as f:
        ct = list(csv.reader(f))
    with open(os.path.join(dir_j, stem + ".csv"), newline="") as f:
        cj = list(csv.reader(f))
    assert ct[0] == cj[0] and len(ct) == len(cj)
    for rt, rj in zip(ct[1:], cj[1:]):
        for col, a, b in zip(cj[0], rt, rj):
            assert _cells_match(a, b), (col, a, b)
    wt = xlsxlite.read_xlsx(os.path.join(dir_t, stem + ".xlsx"))
    wj = xlsxlite.read_xlsx(os.path.join(dir_j, stem + ".xlsx"))
    assert list(wt) == list(wj)
    for name in wj:
        assert wt[name][0] == wj[name][0] and len(wt[name]) == len(wj[name]), name
        for rt, rj in zip(wt[name][1:], wj[name][1:]):
            for col, a, b in zip(wj[name][0], rt, rj):
                assert _cells_match(a, b), (name, col, a, b)


@pytest.fixture(scope="module")
def timelapse_ds(tmp_path_factory):
    """3 timepoints x channels 1, 2 of u16 frames, two ROIs each."""
    folder = tmp_path_factory.mktemp("serial_tl")
    rng = np.random.default_rng(0)
    for t in range(3):
        for ch in (1, 2):
            jtiffio.write_tiff16(str(folder / f"S01_t{t:02d}_{ch}.TIF"),
                                 rng.integers(10, 3000, (H, W)).astype(np.uint16))
        jroiio.save_roi_bundle(str(folder / "roi" / f"S01_t{t:02d}.json"),
                               f"S01_t{t:02d}", (H, W), [PA, PB])
    return folder


@pytest.fixture(scope="module")
def mixed_ds(tmp_path_factory):
    """Eight stages, channels 1 and 2, each taking another path: u16 with
    ROIs; a PNG union mask; no ROI; 8-bit; float32 with NaN; RGB; a
    full-frame ROI beside a small one; another frame shape."""
    from PIL import Image

    folder = tmp_path_factory.mktemp("serial_mixed")
    (folder / "roi").mkdir()
    rng = np.random.default_rng(1)
    plan = {1: ("u16", [PA, PB]), 2: ("u16", "png"), 3: ("u16", None),
            4: ("u8", [PB]), 5: ("f32", [PA, PB]), 6: ("rgb", [PA]),
            7: ("u16", [FULL_ROI, PA]), 8: ("u16w", [PA])}
    for s, (kind, rois) in plan.items():
        shape = (W, H) if kind == "u16w" else (H, W)
        for ch in (1, 2):
            path = str(folder / f"S{s:02d}_{ch}.TIF")
            if kind in ("u16", "u16w"):
                jtiffio.write_tiff16(path, rng.integers(10, 3000, shape).astype(np.uint16))
            elif kind == "u8":
                jtiffio.write_tiff8(path, rng.integers(0, 256, shape).astype(np.uint8))
            elif kind == "f32":
                x = rng.uniform(10.0, 3000.0, shape).astype(np.float32)
                x[rng.random(shape) < 0.03] = np.nan
                jtiffio.write_tiff32(path, x)
            else:
                _write_rgb(path, rng.integers(0, 256, shape + (3,)).astype(np.uint8))
        if rois == "png":
            m = np.zeros(shape, np.uint8)
            m[30:70, 40:100] = 255
            Image.fromarray(m).save(folder / "roi" / f"S{s:02d}.png")
        elif rois is not None:
            jroiio.save_roi_bundle(str(folder / "roi" / f"S{s:02d}.json"),
                                   f"S{s:02d}", shape, rois)
    return folder


def _run_intensity_both(folder, tmp_path, **kw):
    jlogs, tlogs = [], []
    jrows = jint.run_intensity(str(folder), jint.IntensityConfig(**kw),
                               out_root=str(tmp_path / "j"), log=jlogs.append)
    trows = tint.run_intensity(str(folder), tint.IntensityConfig(**kw),
                               out_root=str(tmp_path / "t"), log=tlogs.append,
                               device="cpu")
    return trows, jrows, tlogs, jlogs


def test_run_intensity_timelapse_matches_jax(timelapse_ds, tmp_path):
    """Timelapse pivots: rows, the CSV and the workbook's matrix sheets;
    the port's run log and progress lines."""
    trows, jrows, _, _ = _run_intensity_both(timelapse_ds, tmp_path,
                                             channels=(1, 2), timelapse=True)
    assert len(trows) == 6
    _assert_rows_match(trows, jrows)
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls",
                          "fluor_intensity_perROI")
    lines = []
    tint.run_intensity(str(timelapse_ds), tint.IntensityConfig(
        channels=(1,), timelapse=True, do_xls=False), out_root=str(tmp_path / "rl"),
        log=lines.append, run_log=True, progress=True, device="cpu")
    logs = os.listdir(tmp_path / "rl" / "logs")
    assert len(logs) == 1
    with open(tmp_path / "rl" / "logs" / logs[0], encoding="utf-8") as f:
        text = f.read().splitlines()
    assert text[0].startswith("[START]") and text[-1].startswith("[END]")
    assert any(line.startswith("[100.0%] 6/6") for line in lines)


@pytest.mark.parametrize("kw", [
    {"bg_scope": "roi_union", "per_channel_p": {1: 2.0, 2: 0.5}},
    {"bg_mode": "hist-mode", "bg_stride": 1},
    {"bg_mode": "hist-mode", "bg_scope": "roi_union", "clip_neg": False},
    {"bg_mode": "none", "bg_stride": 3}], ids=["roi_union-p", "hist-mode",
                                               "hist-union-noclip", "none"])
def test_run_intensity_variants_match_jax(timelapse_ds, tmp_path, kw):
    trows, jrows, _, _ = _run_intensity_both(
        timelapse_ds, tmp_path, channels=(1, 2), timelapse=True, do_xls=False, **kw)
    _assert_rows_match(trows, jrows)


def test_run_intensity_subset_and_cancel(timelapse_ds, tmp_path):
    trows, jrows, _, _ = _run_intensity_both(
        timelapse_ds, tmp_path, channels=(1,), timelapse=True, subset_stage=1,
        subset_time=1, do_xls=False)
    assert {r["time"] for r in trows} == {"t01"} and len(trows) == 2
    _assert_rows_match(trows, jrows)

    def cancel_after(n):
        seen = []
        return lambda: len(seen) >= n or seen.append(1)

    cfg = dict(channels=(1,), timelapse=True, do_xls=True)
    logs = []
    trows = tint.run_intensity(str(timelapse_ds), tint.IntensityConfig(**cfg),
                               out_root=str(tmp_path / "c"), log=logs.append,
                               cancel=cancel_after(2), device="cpu")
    jrows = jint.run_intensity(str(timelapse_ds), jint.IntensityConfig(**cfg),
                               out_root=str(tmp_path / "cj"), log=lambda *_: None,
                               cancel=cancel_after(2))
    assert 0 < len(trows) < 6 and any("CANCEL" in str(x).upper() or "취소" in str(x)
                                      for x in logs)
    _assert_rows_match(trows, jrows)
    assert (tmp_path / "c" / "xls" / "fluor_intensity_perROI.csv").exists()


@pytest.mark.parametrize("skip_no_roi", [True, False])
def test_run_intensity_mixed_keys_match_jax(mixed_ds, tmp_path, skip_no_roi):
    """A PNG-mask key (ROI 1 over the mask), the whole-frame ROI 0 (with
    skip_no_roi=False), 8-bit, float32-with-NaN and RGB frames, a full-frame
    ROI and another frame shape; the report as well."""
    trows, jrows, tlogs, jlogs = _run_intensity_both(
        mixed_ds, tmp_path, channels=(1, 2), skip_no_roi=skip_no_roi)
    _assert_rows_match(trows, jrows)
    assert [x.replace(str(tmp_path / "t"), str(tmp_path / "j")) for x in tlogs] == jlogs
    stages = [(r["stage"], r["roi"]) for r in trows]
    assert ("S02", 1) in stages and (("S03", 0) in stages) != skip_no_roi
    assert [s for s, _ in stages].count("S07") == 2
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls",
                          "fluor_intensity_perROI")


def _run_fret_both(folder, tmp_path, **kw):
    jlogs, tlogs = [], []
    jrows = jfret.run_fret(str(folder), jfret.FretConfig(**kw),
                           out_root=str(tmp_path / "j"), log=jlogs.append)
    trows = tfret.run_fret(str(folder), tfret.FretConfig(**kw),
                           out_root=str(tmp_path / "t"), log=tlogs.append,
                           device="cpu")
    return trows, jrows, tlogs, jlogs


@pytest.mark.parametrize("kw", [
    {}, {"bg_mode": "hist-mode"}, {"bg_scope": "roi_union", "bg_mode": "none"}],
    ids=["default", "hist-mode", "roi_union-none"])
def test_run_fret_mixed_pairs_match_jax(mixed_ds, tmp_path, kw):
    """8-bit, float32-with-NaN and RGB pairs, a full-frame ROI, another
    frame shape; the pairs without an ROI file log fret_roi_missing and
    give no rows; the report."""
    trows, jrows, tlogs, jlogs = _run_fret_both(mixed_ds, tmp_path, **kw)
    _assert_rows_match(trows, jrows)
    assert [x.replace(str(tmp_path / "t"), str(tmp_path / "j")) for x in tlogs] == jlogs
    assert sum("S02" in str(x) or "S03" in str(x) for x in tlogs) == 4
    assert {r["stage"] for r in trows} == {f"S{s:02d}" for s in (1, 4, 5, 6, 7, 8)}
    if not kw:
        _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls",
                              "fret_ratio_perROI")


@pytest.mark.parametrize("kw", [
    {"ratio_mode": "Donor/FRET", "per_channel_p": True, "donor_p": 2.0,
     "fret_p": 0.5},
    {"bg_scope": "roi_union", "eps_percentile": 5.0, "eps_abs": 1.0}],
    ids=["DoverF-per-channel-p", "roi_union-eps"])
def test_run_fret_timelapse_matches_jax(timelapse_ds, tmp_path, kw):
    trows, jrows, _, _ = _run_fret_both(timelapse_ds, tmp_path, donor_ch=1,
                                        acceptor_ch=2, timelapse=True, **kw)
    assert len(trows) == 6
    _assert_rows_match(trows, jrows)
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls",
                          "fret_ratio_perROI")


def test_run_fret_subset_and_cancel(timelapse_ds, tmp_path):
    kw = dict(donor_ch=1, acceptor_ch=2, timelapse=True, do_xls=False)
    trows, jrows, _, _ = _run_fret_both(timelapse_ds, tmp_path, subset_stage=1,
                                        subset_time=2, **kw)
    assert len(trows) == 2 and {r["time"] for r in trows} == {"t02"}
    _assert_rows_match(trows, jrows)
    calls = []
    trows = tfret.run_fret(str(timelapse_ds), tfret.FretConfig(**kw),
                           log=lambda *_: None, device="cpu",
                           cancel=lambda: len(calls) >= 1 or calls.append(1))
    assert len(trows) == 2


MIXED_ROIS = {1: [PA, PB], 4: [PB], 5: [PA, PB], 6: [PA], 7: [FULL_ROI, PA], 8: [PA]}


def _mixed_dims(stage: int):
    """(width, height) of stage *stage*'s frames in ``mixed_ds``."""
    return (H, W) if stage == 8 else (W, H)


def _mixed_colorbar(name):
    """The image under the inset colorbar of a PNG of the ``do_png`` runs
    below: the whole frame of an intensity ``PNG/full`` file, the crop of
    a FRET ``PNG_RAT/crop`` file; None for the others."""
    base = os.path.basename(name)
    stage = int(base[1:3])
    fw, fh = _mixed_dims(stage)
    if name.startswith("PNG/full"):
        return fw, fh
    if not name.startswith("PNG_RAT/crop"):
        return None
    roi = int(base.split("_roi")[1].split("_")[0])
    x0, x1, y0, y1 = trender.crop_bbox_poly(MIXED_ROIS[stage][roi - 1], fw, fh)
    return x1 - x0 + 1, y1 - y0 + 1


def _png_options(render, colorbar):
    return dict(
        png_full=render.PanelPngOptions(cmap_on=True, cmap="viridis", colorbar=colorbar,
                                        mask_outside=True, scalebar_um=10.0,
                                        sb_anchor="tl"),
        png_crop=render.PanelPngOptions(mask_outside=True, scalebar_um=5.0, sb_font=8))


@pytest.mark.parametrize("runner", ["intensity", "fret"])
@pytest.mark.parametrize("out", ["do_tif", "do_png"])
def test_image_outputs_raise_before_reading(mixed_ds, tmp_path, runner, out):
    """An empty folder gives no rows and no error.  ``do_png`` on the mixed
    keys (8-bit, float32 with NaN, RGB, a PNG mask, a full-frame ROI,
    another frame shape) writes the JAX runner's PNGs: intensity with a
    colour ramp, masks, scalebars, the inset colorbar on the full frames
    and the raw-value crop TIFFs; FRET at its defaults (the colorbar on
    every crop) with a scalebar.  (The name is kept from when ``do_png``
    raised.)"""
    from imageprocess_tpu.report import render as jrender

    missing = str(tmp_path / "no-such-folder")
    if runner == "intensity":
        assert tint.run_intensity(missing, tint.IntensityConfig(**{out: True}),
                                  log=lambda *_: None, device="cpu") == []
    else:
        assert tfret.run_fret(missing, tfret.FretConfig(**{out: True}),
                              log=lambda *_: None, device="cpu") == []
    if out == "do_tif":
        return
    if runner == "intensity":
        kw = dict(channels=(1, 2), do_png=True, save_raw_crop_tif=True, do_xls=False,
                  channel_colors={1: "Cyan"})
        tint.run_intensity(str(mixed_ds), tint.IntensityConfig(
            **kw, **_png_options(trender, True)), out_root=str(tmp_path / "t"),
            log=lambda *_: None, device="cpu")
        jint.run_intensity(str(mixed_ds), jint.IntensityConfig(
            **kw, **_png_options(jrender, False)), out_root=str(tmp_path / "j"),
            log=lambda *_: None)
        step, expect = lut_step("viridis", "gray", trender.get_cmap_for_color("Cyan")), 34
    else:
        kw = dict(donor_ch=1, acceptor_ch=2, do_png=True, add_scalebar=True, do_xls=False)
        tfret.run_fret(str(mixed_ds), tfret.FretConfig(**kw), out_root=str(tmp_path / "t"),
                       log=lambda *_: None, device="cpu")
        jfret.run_fret(str(mixed_ds), jfret.FretConfig(**kw, show_colorbar=False),
                       out_root=str(tmp_path / "j"), log=lambda *_: None)
        step, expect = lut_step("jet", "gray"), 17
    names = assert_pngs_match(tmp_path / "t", tmp_path / "j", step=step, expect=expect,
                              colorbar=_mixed_colorbar)
    assert sum(_mixed_colorbar(n) is not None for n in names) == \
        (14 if runner == "intensity" else 9)
    tiffs = {side: sorted(os.path.relpath(os.path.join(d, f), tmp_path / side)
                          for d, _, fs in os.walk(tmp_path / side) for f in fs
                          if f.endswith(".tif")) for side in "tj"}
    assert tiffs["t"] == tiffs["j"] and len(tiffs["t"]) == (18 if runner == "intensity" else 0)
    for name in tiffs["t"]:
        a, b = (ttiffio.read_2d(str(tmp_path / side / name), dtype=None) for side in "tj")
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b, equal_nan=True)


def test_serial_runners_default_to_the_card(timelapse_ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tint.run_intensity(str(timelapse_ds), tint.IntensityConfig(channels=(1,)))
    with pytest.raises(RuntimeError, match="is_available"):
        tfret.run_fret(str(timelapse_ds), tfret.FretConfig(timelapse=True))


@pytest.mark.cuda
def test_cuda_serial_runs_match_cpu(mixed_ds, timelapse_ds):
    """On a card: both serial runners on the card (the roistats_f32
    kernel, tiles and full frames) against the same runs on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    for folder, kw in ((mixed_ds, {"skip_no_roi": False}),
                       (timelapse_ds, {"timelapse": True,
                                       "bg_scope": "roi_union"})):
        cfg = tint.IntensityConfig(channels=(1, 2), do_xls=False, **kw)
        rsk.reset_launches()
        card = tint.run_intensity(str(folder), cfg, log=lambda *_: None,
                                  device="cuda")
        assert rsk.launches["roistats_f32"] >= 1
        cpu = tint.run_intensity(str(folder), cfg, log=lambda *_: None,
                                 device="cpu")
        _assert_rows_match(card, cpu)
        fcfg = tfret.FretConfig(donor_ch=1, acceptor_ch=2, do_xls=False,
                                timelapse=kw.get("timelapse", False))
        card = tfret.run_fret(str(folder), fcfg, log=lambda *_: None, device="cuda")
        cpu = tfret.run_fret(str(folder), fcfg, log=lambda *_: None, device="cpu")
        _assert_rows_match(card, cpu)
