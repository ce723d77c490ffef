"""Port parity of the Nesprin-2 rim-FRET pipeline on the CPU
(``device="cpu"``): ``_finite_bg``, the device program ``nesprin2_step``
(tiled and full-frame), the batched step and both runners end to end,
against the JAX package on the same numpy-seeded inputs.

Bars: masks, rim, union, area_px, npx and every string, flag and integer
column exact; mean, std, vsum and the other means within 1e-5 relative
(sums in another order); ``_finite_bg`` against JAX's eager function
bit-equal; backgrounds, eps and the annulus medians within 4 float32 ulps
of the frame's largest value against JAX's compiled programs (XLA's CPU
compiler multiplies by the reciprocal of 100000 and contracts the
interpolation into fused multiply-adds; the order statistics themselves
are the same), the ratio's order statistics within 4 ulps of the largest
value they read when eps and the backgrounds came out bit-equal, else
within 1e-4 relative (the ratio magnifies the last ulps of eps where the
denominator is near zero).  The CSV and XLSX reports: within 1e-4
relative, strings exact.  The port's batched rows equal its serial rows
exactly.
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
from imageprocess_tpu.geom.polygon import pad_polygons as jpad
from imageprocess_tpu.ops import roistats as jrs
from imageprocess_tpu.pipelines import nesprin2 as jn
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.pipelines import nesprin2 as tn
from imageprocess_tpu_torch.report import render as trender
from imageprocess_tpu_torch.report import xlsxlite
from test_torch_tiffout import assert_pngs_match, lut_step

H, W = 160, 224
M_RTOL = 1e-5
RATIO_RTOL = 1e-4
# two ROIs that touch (the union's rim differs from each ROI's own), one on
# the frame's border, one triangle with free-float vertices
POLYS = [np.array([[20.5, 20.5], [70.5, 25.5], [65.5, 80.5], [15.5, 75.5]], np.float32),
         np.array([[65.5, 30.5], [120.5, 28.5], [118.5, 78.5], [66.5, 79.5]], np.float32),
         np.array([[150.3, 100.7], [223.9, 104.1], [223.2, 159.4], [160.4, 150.8]],
                  np.float32),
         np.array([[30.2, 100.7], [80.9, 102.1], [54.4, 140.8]], np.float32)]
# n2_ds's ROI files: S04's frame is (W, H) and its first ROI covers it
N2_FULL = np.array([[-3, -3], [H + 3, -3], [H + 3, W + 3], [-3, W + 3]], float)
N2_ROIS = {1: POLYS, 2: POLYS[:3], 4: [N2_FULL, POLYS[0]]}
NB, VB = 8, 32

CONFIGS = {
    "default": dict(px_um=0.223, rim_um=1.0),
    "qc-annulus": dict(px_um=0.223, rim_um=0.9, sat_filter_on=True,
                       sat_threshold=2500.0, clip_ratio_on=True, clip_ratio_max=1.5,
                       annulus_on=True, ann_in_um=0.9, ann_out_um=1.8),
    "spectral-DoverF": dict(px_um=0.223, rim_um=1.0, use_spectral=True, alpha=0.12,
                            g_factor=1.5, ratio_mode="Donor/FRET",
                            bg_scope="roi_union", clip_neg=False,
                            per_channel_p=True, donor_p=2.0, fret_p=0.5),
    "annulus-scope": dict(px_um=0.223, rim_um=0.45, bg_scope="annulus",
                          bg_mode="hist-mode", ann_in_um=0.5, ann_out_um=1.2),
    "aonly": dict(px_um=0.223, rim_um=1.0, aonly_ch=4, use_spectral=True,
                  alpha=0.1, beta=0.05, g_factor=1.2, eps_percentile=5.0,
                  eps_abs=1.0),
}


def _frame(rng, shape=(H, W)):
    """Noise around 300 with six bright blobs (some pixels above 2500)."""
    h, w = shape
    x = rng.normal(300.0, 40.0, shape)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(6):
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        r = rng.integers(8, 25)
        x += 2500.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * r * r))
    return x.clip(0, 65535).astype(np.uint16)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, what):
    """Bit-equal for *rtol* 0.0, else within *rtol* relative; NaN where
    NaN."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, what
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), what
    g, w = g[~nan], w[~nan]
    if rtol == 0.0:
        assert np.array_equal(g, w), (what, g, w)
    else:
        err = np.abs(g - w) / np.maximum(np.abs(w), 1e-9)
        assert err.size == 0 or err.max() <= rtol, (what, err.max())


def _ulps_close(got, want, scale, what, n=4.0):
    """|got - want| <= n float32 ulps of *scale* (broadcasting), NaN where
    NaN."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, what
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), what
    bound = n * np.spacing(np.abs(np.broadcast_to(scale, w.shape))
                           .astype(np.float32)).astype(np.float64)
    bad = ~nan & ~(np.abs(g - w) <= bound)
    assert not bad.any(), (what, g[bad], w[bad])


def _padded(polys):
    pv = np.zeros((NB, VB, 2), np.float32)
    pv[:len(polys)] = jpad(polys, VB)
    valid = np.zeros(NB, bool)
    valid[:len(polys)] = True
    return pv, valid


# ------------------------------------------------------------------ units

def test_config_matches_jax_field_by_field():
    jf, tf = dataclasses.fields(jn.Nesprin2Config), dataclasses.fields(tn.Nesprin2Config)
    assert [f.name for f in tf] == [f.name for f in jf]
    j, p = jn.Nesprin2Config(), tn.Nesprin2Config()
    for f in jf:
        a, b = getattr(p, f.name), getattr(j, f.name)
        assert (a.value == b.value) if f.name == "grammar" else (a == b and type(a) is type(b)), f.name
    assert tn.RIM_PRESETS == jn.RIM_PRESETS
    for kw in CONFIGS.values():
        j, p = jn.Nesprin2Config(**kw), tn.Nesprin2Config(**kw)
        assert (p.rim_px, p.ann_in_px, p.ann_out_px) == (j.rim_px, j.ann_in_px, j.ann_out_px)
    p = tn.Nesprin2Config(px_um=0.223, annulus_on=True, ann_in_um=2.0, ann_out_um=2.1)
    assert p.ann_out_px == p.ann_in_px + 1


@pytest.mark.parametrize("scope", ["full", "roi_union", "empty"])
@pytest.mark.parametrize("mode", ["percentile", "hist-mode", "none"])
def test_finite_bg_matches_jax_eager(mode, scope):
    """A float frame with NaN and inf, and a raw u16 frame with saturated
    pixels taken out (the port's histogram path) against the JAX function on
    its NaN-marked float cast: bit-equal, 0.0 for an empty scope."""
    rng = np.random.default_rng(3)
    x = rng.normal(400.0, 120.0, (50, 70)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[3, 4], x[5, 6] = np.inf, -np.inf
    raw = _frame(rng, (50, 70))
    sat = raw >= 1500
    assert sat.any()
    marked = np.where(sat, np.nan, raw.astype(np.float32))
    m = None
    if scope == "roi_union":
        m = np.zeros(x.shape, bool)
        m[10:40, 15:60] = True
    elif scope == "empty":
        m = np.zeros(x.shape, bool)
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    for p1000 in (1000, 37500):
        want = jn._finite_bg(jnp.asarray(x), p1000, jm, mode)
        got = tn._finite_bg(torch.from_numpy(x), p1000, tm, mode)
        assert got.dtype == torch.float32 and got.shape == ()
        _close(got, want, 0.0, f"float {mode} {scope} {p1000}")
        want = jn._finite_bg(jnp.asarray(marked), p1000, jm, mode)
        got = tn._finite_bg(torch.from_numpy(raw), p1000, tm, mode,
                            finite=torch.from_numpy(~sat))
        _close(got, want, 0.0, f"u16 {mode} {scope} {p1000}")
        if scope == "empty" or mode == "none":
            assert float(got) == 0.0
    # every pixel non-finite: 0.0, not NaN
    allnan = torch.full((8, 9), float("nan"))
    assert float(tn._finite_bg(allnan, 1000, None, "percentile")) == 0.0


def test_unpack_and_fields_match_jax():
    rng = np.random.default_rng(1)
    flat = rng.normal(size=(3, 15 * NB + 1)).astype(np.float32)
    jc, je = jn.unpack_n2_flat(flat, NB)
    tc, te = tn.unpack_n2_flat(flat, NB)
    assert list(tc) == list(jc) and np.array_equal(te, je)
    assert all(np.array_equal(tc[k], jc[k]) for k in jc)
    assert tuple(tn._N2_STAT_FIELDS) == tuple(jn._N2_STAT_FIELDS)


# ------------------------------------------------------------------ the device program

@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(0)
    return _frame(rng), _frame(rng), rng.normal(200, 30, (H, W)).astype(np.float32)


def _step_both(cfg_kw, tiled, D, A, Aonly, polys=POLYS):
    jc, tc = jn.Nesprin2Config(**cfg_kw), tn.Nesprin2Config(**cfg_kw)
    has_aonly = tc.aonly_ch is not None
    margin = tn._tile_margin(tc)
    tile = jrs.choose_tile(polys, H, W, margin=margin) if tiled else None
    pv, valid = _padded(polys)
    jargs, targs = (None, None), (None, None)
    if tile is not None:
        offs = jrs.tile_offsets(polys, H, W, tile, margin=margin)
        lpv, offp, _ = jrs.pad_local_polys(polys, offs, NB, VB)
        jargs = (jnp.asarray(lpv), jnp.asarray(offp))
        targs = (torch.from_numpy(lpv), torch.from_numpy(offp))
    ao = Aonly if has_aonly else np.zeros((1, 1), np.uint16)
    sc, kw = tn._step_scalars(tc), tn._step_kwargs(tc, has_aonly, tile)
    assert jc.rim_px == kw["rim_px"]
    jo = jn.nesprin2_step(
        jnp.asarray(D), jnp.asarray(A), jnp.asarray(ao), jnp.asarray(pv),
        jnp.asarray(valid), *[jnp.int32(s) for s in sc[:4]],
        *[jnp.float32(s) for s in sc[4:]], *jargs, **kw)
    to = tn.nesprin2_step(
        *(torch.from_numpy(a) for a in (D, A, ao, pv, valid)), *sc, *targs, **kw)
    return to, jo, kw


def _assert_step_matches(to, jo, kw, what):
    (ts, talt, tdon, tfret, tarea, tbn, tbd, teps, tR, tRa, trim, tun, tD, tA) = to
    (js, jalt, jdon, jfret, jarea, jbn, jbd, jeps, jR, jRa, jrim, jun, jD, jA) = jo
    assert np.array_equal(_np(trim), np.asarray(jrim)), f"{what} rim"
    assert np.array_equal(_np(tun), np.asarray(jun)), f"{what} union"
    assert tarea.dtype == torch.int32 and np.array_equal(_np(tarea), np.asarray(jarea))
    assert ts["npx"].dtype == torch.int32
    _close(ts["npx"], js["npx"], 0.0, f"{what} npx")
    top = tuple(float(np.abs(x[np.isfinite(x)]).max(initial=1.0))
                for x in (np.asarray(jD), np.asarray(jA)))
    _ulps_close(teps, jeps, max(top), f"{what} eps")
    _ulps_close(tD, jD, top[0], f"{what} Dcorr")
    # the spectral correction's (A - alpha D) g contracts to FMAs in XLA
    _ulps_close(tA, jA, top[1] + top[0], f"{what} Acorr",
                n=16.0 if kw["use_spectral"] else 4.0)
    _ulps_close(tbn, jbn, max(top), f"{what} bg_n")
    _ulps_close(tbd, jbd, max(top), f"{what} bg_d")
    same = (np.array_equal(_np(teps), np.asarray(jeps))
            and np.array_equal(_np(tD), np.asarray(jD), equal_nan=True)
            and np.array_equal(_np(tA), np.asarray(jA), equal_nan=True)
            and np.array_equal(_np(tbn), np.asarray(jbn))
            and np.array_equal(_np(tbd), np.asarray(jbd)))
    if same and not kw["ann_on"]:
        _close(tR, jR, 0.0, f"{what} R_full")
        _close(tRa, jRa, 0.0, f"{what} R_alt")
    scale = np.fmax(np.abs(np.asarray(js["vmin"])), np.abs(np.asarray(js["vmax"])))
    for f in ("median", "p5", "p95", "vmin", "vmax"):
        if not same:
            _close(ts[f], js[f], RATIO_RTOL, f"{what} {f}")
        elif f in ("vmin", "vmax"):
            _close(ts[f], js[f], 0.0, f"{what} {f}")
        else:
            _ulps_close(ts[f], js[f], scale, f"{what} {f}")
    rt = M_RTOL if same else RATIO_RTOL
    for f in ("mean", "std", "vsum"):
        _close(ts[f], js[f], rt, f"{what} {f}")
    _close(talt, jalt, rt, f"{what} alt_mean")
    _close(tdon, jdon, M_RTOL, f"{what} donor_mean")
    _close(tfret, jfret, rt if kw["use_spectral"] else M_RTOL, f"{what} fret_mean")


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "full-frame"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_nesprin2_step_matches_jax(step_inputs, name, tiled):
    D, A, Aonly = step_inputs
    to, jo, kw = _step_both(CONFIGS[name], tiled, D, A, Aonly)
    _assert_step_matches(to, jo, kw, f"{name} tiled={tiled}")
    ts, tarea = to[0], to[4]
    assert int(tarea[:4].min()) > 0 and int(tarea[4:].max()) == 0
    assert np.isnan(_np(ts["mean"])[4:]).all()          # padded lanes
    if name == "qc-annulus":                            # QC really removes pixels
        assert (_np(ts["npx"])[:4] < _np(tarea)[:4]).all()
        assert (_np(to[5])[:4] > 0).all()               # annulus medians


def test_step_tiled_equals_full_frame(step_inputs):
    """The port's tiled stage gives its full-frame stage's numbers (order
    statistics, areas and annulus medians exactly)."""
    D, A, Aonly = step_inputs
    for name in ("default", "qc-annulus"):
        a, _, _ = _step_both(CONFIGS[name], True, D, A, Aonly)
        b, _, _ = _step_both(CONFIGS[name], False, D, A, Aonly)
        for f in tn.STAT_FIELDS:
            _close(a[0][f], b[0][f], M_RTOL if f in ("mean", "std", "vsum") else 0.0,
                   f"{name} {f}")
        for i in (4, 5, 6):
            _close(a[i], b[i], 0.0, f"{name} output {i}")


def test_step_with_all_pixels_saturated_gives_nan_rows(step_inputs):
    """Nothing finite: backgrounds 0, eps = eps_abs, NaN statistics, the
    areas still the mask's, the annulus medians 0.0."""
    D, A, Aonly = step_inputs
    kw = dict(CONFIGS["qc-annulus"], sat_threshold=0.0)
    to, jo, skw = _step_both(kw, True, D, A, Aonly)
    _assert_step_matches(to, jo, skw, "all saturated")
    assert float(to[7]) == 5.0 and np.isnan(_np(to[0]["mean"])).all()
    assert (_np(to[4])[:4] > 0).all() and (_np(to[5]) == 0).all()


# ------------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def n2_ds(tmp_path_factory):
    """Four stages, channels 1 (donor), 2 (FRET) and 4 (acceptor only):
    S01 four ROIs,
    S02 three, S03 without an ROI file, S04 of another frame shape with an
    ROI that needs the full frame."""
    folder = tmp_path_factory.mktemp("n2")
    rng = np.random.default_rng(5)
    for s in (1, 2, 3, 4):
        shape = (W, H) if s == 4 else (H, W)
        for ch in (1, 2, 4):
            jtiffio.write_tiff16(str(folder / f"S{s:02d}_{ch}.TIF"), _frame(rng, shape))
    for s, rois in N2_ROIS.items():
        jroiio.save_roi_bundle(str(folder / "roi" / f"S{s:02d}.json"), f"S{s:02d}",
                               (W, H) if s == 4 else (H, W), rois)
    return folder


@pytest.fixture(scope="module")
def n2_tl_ds(tmp_path_factory):
    """Two timepoints x channels 1, 2, two ROIs each."""
    folder = tmp_path_factory.mktemp("n2_tl")
    rng = np.random.default_rng(6)
    for tp in range(2):
        for ch in (1, 2):
            jtiffio.write_tiff16(str(folder / f"S01_t{tp:02d}_{ch}.TIF"), _frame(rng))
        jroiio.save_roi_bundle(str(folder / "roi" / f"S01_t{tp:02d}.json"),
                               f"S01_t{tp:02d}", (H, W), POLYS[:2])
    return folder


INTERP_COLS = ("ratio_median", "ratio_p5", "ratio_p95")
MEAN_COLS = ("ratio_mean", "ratio_std", "ratio_FoverD_mean", "ratio_DoverF_mean",
             "donor_mean", "fret_mean")


def _assert_rows_match(trows, jrows, spectral=False):
    """*spectral*: the corrected FRET frame differs from XLA's by its FMA
    contraction, and goes negative, so the ratios take the looser bar."""
    key = lambda r: (r["stage"], r["time"], r["roi"])  # noqa: E731
    assert [key(r) for r in trows] == [key(r) for r in jrows]
    for rt, rj in zip(trows, jrows):
        assert list(rt) == list(rj)
        same_eps = rt["eps"] == rj["eps"]
        for col, b in rj.items():
            a = rt[col]
            where = (key(rj), col, a, b)
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a), where
            elif col == "eps":
                assert abs(a - b) <= 4.0 * np.spacing(np.float32(4096.0)), where
            elif col in INTERP_COLS + MEAN_COLS:
                tight = same_eps and col in MEAN_COLS and not (
                    spectral and col != "donor_mean")
                rt_ = M_RTOL if tight else RATIO_RTOL
                assert abs(a - b) <= rt_ * max(abs(b), 1e-9), where
            else:
                assert a == b and type(a) is type(b), where


def _cells_match(a, b):
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except (TypeError, ValueError):
        return False
    return (math.isnan(fa) and math.isnan(fb)) or abs(fa - fb) <= 1e-4 * max(abs(fb), 1e-9)


def _assert_reports_match(dir_t, dir_j, stem="nesprin2_fret_perROI"):
    with open(os.path.join(dir_t, stem + ".csv"), newline="") as f:
        ct = list(csv.reader(f))
    with open(os.path.join(dir_j, stem + ".csv"), newline="") as f:
        cj = list(csv.reader(f))
    assert ct[0] == cj[0] and len(ct) == len(cj) > 1
    for rt, rj in zip(ct[1:], cj[1:]):
        for col, a, b in zip(cj[0], rt, rj):
            assert _cells_match(a, b), (col, a, b)
    wt = xlsxlite.read_xlsx(os.path.join(dir_t, stem + ".xlsx"))
    wj = xlsxlite.read_xlsx(os.path.join(dir_j, stem + ".xlsx"))
    assert list(wt) == list(wj) == ["per_ROI", "ratio_mean_matrix", "ratio_median_matrix"]
    for name in wj:
        assert wt[name][0] == wj[name][0] and len(wt[name]) == len(wj[name]), name
        for rt, rj in zip(wt[name][1:], wj[name][1:]):
            for col, a, b in zip(wj[name][0], rt, rj):
                assert _cells_match(a, b), (name, col, a, b)


def _run_both(runner, folder, tmp_path, **kw):
    jlogs, tlogs = [], []
    extra = {"batch_size": 2} if runner == "run_nesprin2_batched" else {}
    jrows = getattr(jn, runner)(str(folder), jn.Nesprin2Config(**kw),
                                out_root=str(tmp_path / "j"), log=jlogs.append, **extra)
    trows = getattr(tn, runner)(str(folder), tn.Nesprin2Config(**kw),
                                out_root=str(tmp_path / "t"), log=tlogs.append,
                                device="cpu", **extra)
    return trows, jrows, tlogs, jlogs


@pytest.mark.parametrize("name", ["default", "qc-annulus", "aonly"])
def test_run_nesprin2_matches_jax(n2_ds, tmp_path, name):
    """Rows, logs and the report; S03 warns and gives no rows; S04 (another
    shape, an ROI that needs the full frame) takes the full-frame stage."""
    trows, jrows, tlogs, jlogs = _run_both("run_nesprin2", n2_ds, tmp_path,
                                           donor_ch=1, fret_ch=2, **CONFIGS[name])
    assert len(trows) == 4 + 3 + 2
    _assert_rows_match(trows, jrows, spectral=name == "aonly")
    assert tlogs == jlogs and sum("S03" in str(x) for x in tlogs) == 2
    assert all(r["time"] is None for r in trows)
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")


def test_run_nesprin2_timelapse_and_subset_match_jax(n2_tl_ds, tmp_path):
    """The time code lands in the "time" column (the reference writes a
    function object there; both packages write the code), the pivots have
    one row per timepoint; then a stage/time subset."""
    kw = dict(donor_ch=1, fret_ch=2, timelapse=True, **CONFIGS["default"])
    trows, jrows, _, _ = _run_both("run_nesprin2", n2_tl_ds, tmp_path, **kw)
    assert [r["time"] for r in trows] == ["t00", "t00", "t01", "t01"]
    _assert_rows_match(trows, jrows)
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")
    wb = xlsxlite.read_xlsx(str(tmp_path / "t" / "xls" / "nesprin2_fret_perROI.xlsx"))
    assert len(wb["ratio_mean_matrix"]) == 3
    trows, jrows, _, _ = _run_both("run_nesprin2", n2_tl_ds, tmp_path / "sub",
                                   subset_stage=1, subset_time=1, do_xls=False, **kw)
    assert [r["time"] for r in trows] == ["t01", "t01"]
    _assert_rows_match(trows, jrows)
    none, _, _, _ = _run_both("run_nesprin2", n2_tl_ds, tmp_path / "none",
                              subset_stage=7, do_xls=False, **kw)
    assert none == []


@pytest.mark.parametrize("name", ["default", "qc-annulus"])
def test_run_nesprin2_batched_matches_jax(n2_ds, tmp_path, name):
    trows, jrows, tlogs, jlogs = _run_both("run_nesprin2_batched", n2_ds, tmp_path,
                                           donor_ch=1, fret_ch=2, **CONFIGS[name])
    assert len(trows) == 9
    _assert_rows_match(trows, jrows)
    assert tlogs == jlogs
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")


@pytest.fixture(scope="module")
def serial_rows(n2_ds):
    """The port's serial rows per config name, run once each."""
    done = {}

    def rows(name):
        if name not in done:
            cfg = tn.Nesprin2Config(donor_ch=1, fret_ch=2, do_xls=False, **CONFIGS[name])
            done[name] = tn.run_nesprin2(str(n2_ds), cfg, log=lambda *_: None,
                                         device="cpu")
        return done[name]

    return rows


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch_size", [1, 3])
def test_batched_rows_equal_serial_rows(n2_ds, serial_rows, name, batch_size):
    """Exactly, every column; S04 takes the per-pair path in the batched
    runner (another frame shape), in key order."""
    cfg = tn.Nesprin2Config(donor_ch=1, fret_ch=2, do_xls=False, **CONFIGS[name])
    serial = serial_rows(name)
    batched = tn.run_nesprin2_batched(str(n2_ds), cfg, log=lambda *_: None,
                                      device="cpu", batch_size=batch_size)
    assert len(serial) == len(batched) == 9
    for a, b in zip(serial, batched):
        assert list(a) == list(b)
        for k in a:
            same = a[k] == b[k] or (isinstance(a[k], float) and math.isnan(a[k])
                                    and math.isnan(b[k]))
            assert same, (name, a["stage"], a["roi"], k, a[k], b[k])


def test_load_pair_fallback_chain_matches_jax(tmp_path):
    """The acceptor-only and intensity frames are looked up under the
    donor's name, then under the acceptor's; a missing acceptor-only frame
    gives None, a missing intensity frame the donor's as float32; frames
    keep their dtype.  The intensity frame feeds only the PNGs: without
    ``do_png`` it is not read (JAX's ``need_intensity=False``)."""
    rng = np.random.default_rng(2)
    for name in ("S01_1.TIF", "S01-c2.TIF", "S01-4.TIF", "S01-3.TIF", "S02_1.TIF",
                 "S02_2.TIF"):
        jtiffio.write_tiff16(str(tmp_path / name), _frame(rng, (60, 70)))
    jroiio.save_roi_bundle(str(tmp_path / "roi" / "S01.json"), "S01", (60, 70),
                           [POLYS[3] / 4])
    for s, apath in (("S01", "S01-c2.TIF"), ("S02", "S02_2.TIF")):
        args = ((s, None), str(tmp_path / f"{s}_1.TIF"), str(tmp_path / apath),
                str(tmp_path / "roi"))
        for png in (False, True):
            got = tn.load_pair_nesprin2(*args, tn.Nesprin2Config(aonly_ch=4, do_png=png))
            want = jn.load_pair_nesprin2(*args, jn.Nesprin2Config(aonly_ch=4),
                                         need_intensity=png)
            assert len(got) == len(want) == 5
            for g, w in zip(got[:4], want[:4]):
                assert (g is None) == (w is None)
                if w is not None:
                    assert g.dtype == w.dtype and np.array_equal(g, w)
            assert (got[4] is None) == (want[4] is None) == (s == "S02")
            assert (got[3] is None) == (s == "S02") and (got[2] is None) == (not png)
            if png:   # S02 has no channel 3: the donor frame stands in
                assert got[2].dtype == np.float32 and \
                    np.array_equal(got[2], got[0].astype(np.float32)) == (s == "S02")


def test_no_pairs_and_cancel(n2_ds, tmp_path):
    logs = []
    cfg = tn.Nesprin2Config(donor_ch=7, fret_ch=8)
    for run in (tn.run_nesprin2, tn.run_nesprin2_batched):
        assert run(str(n2_ds), cfg, log=logs.append, device="cpu") == []
    jlogs = []
    assert jn.run_nesprin2(str(n2_ds), jn.Nesprin2Config(donor_ch=7, fret_ch=8),
                           log=jlogs.append) == []
    assert logs == jlogs * 2
    cfg = tn.Nesprin2Config(donor_ch=1, fret_ch=2, do_xls=False, **CONFIGS["default"])
    for run in (tn.run_nesprin2, tn.run_nesprin2_batched):
        seen, logs = [], []
        rows = run(str(n2_ds), cfg, log=logs.append, device="cpu",
                   cancel=lambda: len(seen) >= 1 or seen.append(1))
        assert len(rows) in (0, 4) and any("CANCEL" in str(x).upper() or "취소" in str(x) for x in logs)


def _n2_colorbar(name):
    """The crop under the inset colorbar of an ``n2_ds`` ratio crop PNG."""
    if not name.startswith("PNG/CROP_RATIO"):
        return None
    stage, roi = int(name.split("/S")[1][:2]), int(name.split("_roi")[1].split("_")[0])
    fw, fh = (H, W) if stage == 4 else (W, H)
    x0, x1, y0, y1 = trender.crop_bbox_poly(N2_ROIS[stage][roi - 1], fw, fh)
    return x1 - x0 + 1, y1 - y0 + 1


@pytest.mark.parametrize("runner", ["run_nesprin2", "run_nesprin2_batched"])
@pytest.mark.parametrize("out", ["do_tif", "do_png"])
def test_image_outputs_raise_before_reading(n2_ds, tmp_path, runner, out):
    """An empty folder gives no rows and no error.  ``do_png`` writes the
    JAX runner's PNGs (full ratio and intensity frames, the rim-masked
    ratio crops with their inset colorbar, the intensity crops): the
    serial runner with the annulus and QC (each crop's ratio rebuilt from
    the corrected frames) and the intensity frame of channel 4; the
    batched one, which hands the run to the serial one, with a scalebar
    and an intensity channel that has no file (the donor frame stands in).
    The JAX runs draw no colorbar (``assert_pngs_match``).  (The name is
    kept from when ``do_png`` raised.)"""
    missing = str(tmp_path / "no-such-folder")
    assert getattr(tn, runner)(missing, tn.Nesprin2Config(**{out: True}),
                               log=lambda *_: None, device="cpu") == []
    if out == "do_tif":
        return
    kw = (dict(CONFIGS["qc-annulus"], intensity_ch=4) if runner == "run_nesprin2"
          else dict(CONFIGS["default"], intensity_ch=3, add_scalebar=True))
    kw.update(donor_ch=1, fret_ch=2, do_png=True, do_xls=False)
    trows = getattr(tn, runner)(str(n2_ds), tn.Nesprin2Config(**kw),
                                out_root=str(tmp_path / "t"), log=lambda *_: None,
                                device="cpu")
    jrows = jn.run_nesprin2(str(n2_ds), jn.Nesprin2Config(**kw, show_colorbar=False),
                            out_root=str(tmp_path / "j"), log=lambda *_: None)
    assert len(trows) == len(jrows) == 9
    # per pair with ROIs: two full frames, and per ROI the ratio crop and
    # two intensity crops
    names = assert_pngs_match(tmp_path / "t", tmp_path / "j",
                              step=lut_step("turbo", "gray"), expect=3 * 2 + 9 * 3,
                              colorbar=_n2_colorbar)
    assert sum(_n2_colorbar(n) is not None for n in names) == 9


def test_save_panel_raises_naming_item_14d(n2_ds, tmp_path):
    """The intensity / ratio panel is laid out by matplotlib: with
    ``do_png`` both runners refuse it before a file is read or written."""
    for runner in (tn.run_nesprin2, tn.run_nesprin2_batched):
        with pytest.raises(NotImplementedError, match="item 14d"):
            runner(str(n2_ds), tn.Nesprin2Config(donor_ch=1, fret_ch=2, do_png=True,
                                                 save_panel=True),
                   out_root=str(tmp_path / "o"), log=lambda *_: None, device="cpu")
        assert not (tmp_path / "o").exists()
    # without do_png the panel is never drawn, in JAX too
    rows = tn.run_nesprin2(str(n2_ds), tn.Nesprin2Config(donor_ch=1, fret_ch=2, do_xls=False,
                                                         save_panel=True),
                           log=lambda *_: None, device="cpu")
    assert len(rows) == 9


def test_mesh_raises_naming_its_roadmap_item(n2_ds):
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tn.run_nesprin2_batched(str(n2_ds), tn.Nesprin2Config(donor_ch=1, fret_ch=2),
                                mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tn.make_nesprin2_batched_step(tn.Nesprin2Config(), has_aonly=False, tile=64,
                                      mesh=object())


def test_runners_default_to_the_card(n2_ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tn.Nesprin2Config(donor_ch=1, fret_ch=2)
    for run in (tn.run_nesprin2, tn.run_nesprin2_batched):
        with pytest.raises(RuntimeError, match="is_available"):
            run(str(n2_ds), cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        tn.process_pair_nesprin2(("S01", None), "", "", "", cfg, loaded=())


def test_cpu_run_launches_no_kernel(n2_ds):
    rsk.reset_launches()
    cfg = tn.Nesprin2Config(donor_ch=1, fret_ch=2, do_xls=False, **CONFIGS["qc-annulus"])
    quiet = lambda *_: None  # noqa: E731
    assert len(tn.run_nesprin2(str(n2_ds), cfg, log=quiet, device="cpu")) == 9
    assert len(tn.run_nesprin2_batched(str(n2_ds), cfg, log=quiet, device="cpu")) == 9
    assert rsk.launches["roistats_f32"] == 0


@pytest.mark.cuda
def test_cuda_rows_match_cpu(n2_ds):
    """On a card: both runners on the card (the roistats_f32 kernel: one
    launch per pair or chunk, two with the annulus) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    quiet = lambda *_: None  # noqa: E731
    for name, per_pair in (("default", 1), ("qc-annulus", 2), ("aonly", 1)):
        cfg = tn.Nesprin2Config(donor_ch=1, fret_ch=2, do_xls=False, **CONFIGS[name])
        cpu = tn.run_nesprin2(str(n2_ds), cfg, log=quiet, device="cpu")
        for run, launches in ((tn.run_nesprin2, 3 * per_pair),
                              (tn.run_nesprin2_batched, 2 * per_pair)):
            rsk.reset_launches()
            card = run(str(n2_ds), cfg, log=quiet, device="cuda")
            assert rsk.launches["roistats_f32"] == launches
            assert len(card) == len(cpu)
            for a, b in zip(card, cpu):
                for k, v in b.items():
                    if isinstance(v, float) and math.isnan(v):
                        assert math.isnan(a[k]), k
                    elif k in MEAN_COLS:
                        assert abs(a[k] - v) <= M_RTOL * max(abs(v), 1e-9), k
                    else:
                        assert a[k] == v, (name, k, a[k], v)
