"""Port parity of the figures that the JAX package lays out with matplotlib:
the rim-FRET 2-up panel (``render.save_panel_intensity_ratio``), the FA crop
PNGs (``render.save_fa_crop_colormap``, ``fa.export_fa_crops``) and the FA
overview figures with the MATLAB boundary overlay (``fa.save_fa_figs``,
``core.roiio.find_matching_mat`` / ``load_matlab_boundaries``), on the CPU
against matplotlib 3.10.8 through the JAX functions on the same seeded
inputs.

The standard, per figure: the canvas size is equal; the boxes of the
images, the colorbar gradients (with their outline and ticks) and the
dashed outlines are within 2 px; the ink boxes of titles, tick labels,
offset text, colorbar labels, scalebars and ROI numbers within 4 px;
gradients within one LUT step; the drawn tick values equal matplotlib's
and so do their label strings and the offset text; the image regions equal
matplotlib's pixels where it enlarges by nearest neighbour (above 3 times,
as every small frame here), and elsewhere the port's own
``pilcomp.paste_image`` of the same RGBA (matplotlib's Hanning filter is
not reproduced).
"""

import os
import sys

import numpy as np
import pytest
from PIL import Image

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.figure as mfigure  # noqa: E402

from imageprocess_tpu.core import roiio as jroiio  # noqa: E402
from imageprocess_tpu.pipelines import fa as jfa  # noqa: E402
from imageprocess_tpu.report import render as jr  # noqa: E402
from imageprocess_tpu_torch.core import roiio as troiio  # noqa: E402
from imageprocess_tpu_torch.core import tiffio  # noqa: E402
from imageprocess_tpu_torch.pipelines import fa as tfa  # noqa: E402
from imageprocess_tpu_torch.report import pilcomp as tpil  # noqa: E402
from imageprocess_tpu_torch.report import render as tr  # noqa: E402
from test_torch_fa import CELLS, CFG, _synthetic_cell_image  # noqa: E402
from test_torch_tiffout import lut_step, png_files  # noqa: E402

QUIET = dict(log=lambda *_: None)


def _write_mat_v73(path, cells):
    """A MATLAB-v7.3-layout HDF5 file: dataset ``bdokcc`` is a (ncells, 1)
    cell-of-cells of object references, each inner cell a (nfa, 1)
    reference array onto (2, N) [y; x] coordinate data (the writer of
    tests/test_matlab_facrops.py)."""
    import h5py

    with h5py.File(path, "w") as f:
        refs = f.create_group("#refs#")
        outer = []
        for i, polys in enumerate(cells):
            inner = []
            for j, p in enumerate(polys):
                p = np.asarray(p, float)  # (N, 2) [x, y]
                d = refs.create_dataset(f"c{i}_{j}", data=p[:, [1, 0]].T)
                inner.append(d.ref)
            cell = refs.create_dataset(
                f"cell{i}",
                data=np.array(inner, dtype=h5py.ref_dtype)[:, None])
            outer.append(cell.ref)
        f.create_dataset(
            "bdokcc", data=np.array(outer, dtype=h5py.ref_dtype)[:, None])


# ------------------------------------------------------------------ helpers


def rgb(path):
    return np.array(Image.open(path).convert("RGB")).astype(np.int16)


def window(box, canvas_h, pad):
    """A display-pixel box (y up) as an image window (c0, r0, c1, r1)
    grown by *pad*."""
    return (int(box[0] - pad), int(canvas_h - box[3] - pad),
            int(np.ceil(box[2] + pad)), int(np.ceil(canvas_h - box[1] + pad)))


def ink(arr, win, pred):
    """(x0, x1, y0, y1) of the pixels of *win* where *pred* holds, or
    None."""
    c0, r0, c1, r1 = win
    c0, r0 = max(0, c0), max(0, r0)
    ys, xs = np.nonzero(pred(arr[r0:r1, c0:c1]))
    if ys.size == 0:
        return None
    return (xs.min() + c0, xs.max() + c0, ys.min() + r0, ys.max() + r0)


def occupied(arr, win, pred, frac):
    """(x0, x1, y0, y1) of the columns and rows of *win* where more than
    *frac* of the pixels satisfy *pred*: an image's box, robust to overlays
    and to its own stray pixels."""
    c0, r0, c1, r1 = win
    c0, r0 = max(0, c0), max(0, r0)
    m = pred(arr[r0:r1, c0:c1])
    cols = np.nonzero(m.mean(0) > frac)[0]
    rows = np.nonzero(m.mean(1) > frac)[0]
    return (cols.min() + c0, cols.max() + c0, rows.min() + r0, rows.max() + r0)


def near(a, b, tol):
    assert a is not None and b is not None, (a, b)
    assert all(abs(int(x) - int(y)) <= tol for x, y in zip(a, b)), (a, b)


def dark(a):
    return a.max(-1) < 110


def white(a):
    return a.min(-1) > 200


def not_white(a):
    return a.min(-1) < 245


def colour(a):
    return (a.max(-1) - a.min(-1)) > 60


@pytest.fixture
def mpl_ticks(monkeypatch):
    """The drawn colorbar ticks of every figure the JAX package saves:
    [[(value, label), ...], offset text] per axes with a visible y axis."""
    record = []
    orig = mfigure.Figure.savefig

    def savefig(self, *a, **k):
        orig(self, *a, **k)
        for ax in self.axes:
            ya = ax.yaxis
            if ya.get_visible() and ax.axison:
                drawn = ya._update_ticks()
                record.append(([(float(t.get_loc()), t.label2.get_text()) for t in drawn],
                               ya.offsetText.get_text()))

    monkeypatch.setattr(mfigure.Figure, "savefig", savefig)
    return record


def port_ticks(lay):
    return [(v, label) for v, _, label, _, _ in lay["ticks"]], lay["offset"][0]


def assert_ticks(lay, want):
    got_ticks, got_offset = port_ticks(lay)
    want_ticks, want_offset = want
    assert [label for _, label in got_ticks] == [label for _, label in want_ticks]
    assert np.allclose([v for v, _ in got_ticks], [v for v, _ in want_ticks],
                       rtol=1e-12, atol=0)
    assert got_offset == want_offset


def assert_colorbar(t, j, cax, lay, lut, dpi, text_pred, tick_pt):
    """Gradient + outline + ticks box within 2 px, its centre column within
    one LUT step, every tick label's, the offset text's and the label's ink
    within 4 px."""
    ch = t.shape[0]
    px = dpi / 72.0
    bar = (cax[0], cax[1], cax[2] + tpil.TICK_LEN_PT * px, cax[3])
    win = window(bar, ch, 3)
    outline = ink(j, win, lambda a: colour(a) | text_pred(a))
    near(ink(t, win, lambda a: colour(a) | text_pred(a)), outline, 2)
    cx = int((cax[0] + cax[2]) / 2)
    r0, r1 = int(ch - cax[3]) + 3, int(ch - cax[1]) - 3
    assert np.abs(t[r0:r1, cx] - j[r0:r1, cx]).max() <= lut_step(lut)
    for _, _, label, box, _ in lay["ticks"]:
        w = window(box, ch, 0.3 * tick_pt * px)
        near(ink(t, w, text_pred), ink(j, w, text_pred), 4)
    if lay["offset"][0]:
        w = window(lay["offset"][1], ch, 8)
        near(ink(t, w, text_pred), ink(j, w, text_pred), 4)
    if lay["label"] is not None:
        w = window(lay["label"][1], ch, 10)
        near(ink(t, w, text_pred), ink(j, w, text_pred), 4)


# ------------------------------------------------------------------ panel

PANEL_CASES = [(False, True, 0.0, 0.7, "turbo", (90, 120)),
               (True, True, 0.25, 1.75, "jet", (90, 120)),
               (False, False, 0.0, 0.7, "turbo", (90, 120)),
               (True, False, 0.0, 0.7, "viridis", (90, 120)),
               (False, True, 0.0, 0.7, "turbo", (300, 400))]


def nearest_regime(box, h, w):
    """Whether matplotlib enlarges an h x w image into *box* by nearest
    neighbour."""
    ow, oh, _, _ = tpil._agg_out_shape(np.zeros((h, w, 4), np.uint8), box)
    return ow > 3 * w and oh > 3 * h


def _panel_inputs(H=90, W=120):
    rng = np.random.default_rng(11)
    I = rng.uniform(100, 4000, (H, W)).astype(np.float32)
    R = rng.uniform(0.1, 1.9, (H, W)).astype(np.float32)
    rim = np.ones((H, W), bool)
    rim[40:50, 50:70] = False          # a hole: NaN pixels show the white
    return I, R, rim


@pytest.mark.parametrize("scalebar, colorbar, vmin, vmax, cmap, shape", PANEL_CASES,
                         ids=["colorbar", "scalebar-colorbar", "bare", "scalebar",
                              "large-frame"])
def test_panel_matches_jax(tmp_path, mpl_ticks, scalebar, colorbar, vmin, vmax, cmap,
                           shape):
    I, R, rim = _panel_inputs(*shape)
    kw = dict(add_scalebar=scalebar, sb_um=5.0, cmap=cmap, vmin=vmin, vmax=vmax,
              show_colorbar=colorbar)
    jr.save_panel_intensity_ratio(I, R, rim, str(tmp_path / "j.png"), 0.2, **kw)
    tr.save_panel_intensity_ratio(I, R, rim, str(tmp_path / "t.png"), 0.2, **kw)
    t, j = rgb(tmp_path / "t.png"), rgb(tmp_path / "j.png")
    assert t.shape == j.shape == (900, 1800, 3)
    ch = t.shape[0]
    H, W = R.shape
    spec = tr.scalebar_spec(W, H, 25 * 0.2, 0.2) if scalebar else None
    lay = tr.panel_layout(W, H, colorbar, vmin, vmax, spec)
    for k, (box, title) in enumerate(zip(lay["axes"], ("Intensity", "FRET"))):
        win = window(box, ch, 10)
        near(occupied(t, win, not_white, 0.3), occupied(j, win, not_white, 0.3), 2)
        tw = window(tpil.title_layout(box, title, 300)[0], ch, 12)
        near(ink(t, tw, dark), ink(j, tw, dark), 4)
        if scalebar and k == 1:   # turbo / jet / viridis have no white
            near(ink(t, win, white), ink(j, win, white), 4)
        if not scalebar:          # the image region
            own = Image.new("RGBA", (1800, 900), (255, 255, 255, 255))
            img, cm, lo, hi = ((I, "gray", *np.percentile(I[rim], [1, 99])) if k == 0
                               else (R, cmap, vmin, vmax))
            c0, r0, dw, dh = tpil.paste_image(
                own, tr.colormap_rgba_u8(np.where(rim, img, np.nan), cm, lo, hi), box)
            own = np.array(own.convert("RGB")).astype(np.int16)
            region = np.s_[r0:r0 + dh, c0:c0 + dw]
            # matplotlib's pixels where it enlarges by nearest and the box is
            # its box to the bit: without the colorbar, whose tick labels'
            # autohinted widths (which PIL cannot measure) move tight_layout
            # by a fraction of a pixel; else the port's own
            nn = nearest_regime(box, H, W)
            assert nn == (shape == (90, 120))
            exact = nn and not colorbar
            assert np.array_equal(t[region], (j if exact else own)[region])
    if colorbar:
        assert len(mpl_ticks) == 1
        assert_ticks(lay["colorbar"], mpl_ticks[0])
        assert_colorbar(t, j, lay["cax"], lay["colorbar"], cmap, 300, dark, 10)
    else:
        assert mpl_ticks == []
        assert lay["cax"] is None


def test_panel_of_a_nesprin2_run_is_written_where_jax_writes_it(tmp_path):
    """``save_nesprin2_images`` with ``save_panel``: the file under
    ``PNG/panel`` and only with ``do_png``, as the JAX function writes it."""
    from types import SimpleNamespace

    I, R, rim = _panel_inputs(40, 50)
    cfg = SimpleNamespace(do_tif=False, do_png=True, save_full=False, save_crop=False,
                          save_panel=True, px_um=0.2, add_scalebar=True,
                          scale_bar_um=2.0, cmap_name="turbo", fret_min=0.0,
                          fret_max=0.7, show_colorbar=True)
    for mod, side in ((tr, "t"), (jr, "j")):
        dirs = {"png_panel": str(tmp_path / side / "PNG" / "panel")}
        mod.save_nesprin2_images("S01", "A", R, rim, I, [], cfg, dirs, 1.0)
    assert png_files(tmp_path / "t") == png_files(tmp_path / "j") == [
        os.path.join("PNG", "panel", "S01_panel_A.png")]


# ------------------------------------------------------------------ FA crop

CROP_CASES = [("jet", True, 1.0, 0.0), ("jet", False, 1e-2, 1e6),
              ("green", True, 1.0, 0.0), ("Magenta", False, 1e4, 0.0)]
CROP_POLY = np.array([[5, 5], [45, 8], [40, 55], [8, 50]], float)


def _crop_inputs(scale, shift):
    """A 60 x 50 crop; its FA mask a blob and a 2-px ring at the crop's
    edge (which shows the image's box), so the ROI outline lies on the
    black background."""
    rng = np.random.default_rng(12)
    crop = (rng.uniform(100, 4000, (60, 50)) * scale + shift).astype(np.float32)
    yy, xx = np.mgrid[0:60, 0:50]
    mask = ((yy - 30) ** 2 + (xx - 24) ** 2 < 64)
    mask[:2], mask[-2:], mask[:, :2], mask[:, -2:] = True, True, True, True
    return crop, mask


def _dash_grey(a):
    """The 0.8-alpha gray (128) outline where it lies on the black
    background: (102, 102, 102) within 3."""
    return (np.abs(a - 102) <= 3).all(-1)


@pytest.mark.parametrize("cmap, sb_on, scale, shift", CROP_CASES,
                         ids=["jet-scalebar", "jet-offset", "css-green-scalebar",
                              "css-magenta-sci"])
def test_fa_crop_matches_jax(tmp_path, mpl_ticks, cmap, sb_on, scale, shift):
    crop, mask = _crop_inputs(scale, shift)
    kw = dict(cmap_name=cmap, sb_on=sb_on, sb_len_um=2.0, px_size=0.112, out_dpi=300)
    jr.save_fa_crop_colormap(crop, mask, CROP_POLY, str(tmp_path / "j.png"), **kw)
    tr.save_fa_crop_colormap(crop, mask, CROP_POLY, str(tmp_path / "t.png"), **kw)
    t, j = rgb(tmp_path / "t.png"), rgb(tmp_path / "j.png")
    assert t.shape == j.shape == (500, 500, 3)
    box, cax = tr.fa_crop_layout(50, 60, 500, 500, 300)
    win = window(box, 500, 10)
    near(ink(t, win, colour), ink(j, win, colour), 2)
    ax = tpil.ImageAxes(None, box, 50, 60, 300)
    xs, ys = ax.to_px(CROP_POLY[:, 0], CROP_POLY[:, 1])
    ow = window((xs.min(), ys.min(), xs.max(), ys.max()), 500, 6)  # no text
    near(ink(t, ow, _dash_grey), ink(j, ow, _dash_grey), 2)
    valid = crop[mask]
    vmin, vmax = np.percentile(valid, 1), np.percentile(valid, 99)
    lay = tpil.colorbar_layout(cax, vmin, vmax, 300, tick_pt=8)
    assert len(mpl_ticks) == 1
    assert_ticks(lay, mpl_ticks[0])
    assert_colorbar(t, j, cax, lay, tr._fa_crop_lut(cmap), 300, white, 8)
    if sb_on:   # the bar and its bold label, below the colorbar
        sw = (0, int(500 - cax[1]) + 10, 500, 500)
        near(ink(t, sw, white), ink(j, sw, white), 4)
    # the image inside the outline, away from the colorbar: matplotlib
    # enlarges the crop by nearest neighbour, and so does the port
    assert nearest_regime(box, 60, 50)
    (xa, ya), (xb, yb) = ax.to_px(12, 15), ax.to_px(30, 40)
    sl = np.s_[int(500 - ya):int(500 - yb), int(xa):int(xb)]
    assert np.array_equal(t[sl], j[sl])


# ------------------------------------------------------------------ FA overview

MAT_POLY = np.array([[60.0, 60.0], [200.0, 62.0], [198.0, 195.0], [58.0, 192.0]])


@pytest.fixture(scope="module")
def fa_runs(tmp_path_factory):
    """Two FA stages (256 x 320, two cells each) and a v7.3 boundary file
    matched to S01; the overview figures of both packages with and without
    the MATLAB overlay, and both packages' crop exports."""
    root = tmp_path_factory.mktemp("fa_figs")
    img_dir, roi_dir, mat_dir = root / "imgs", root / "roi", root / "mat"
    for d in (img_dir, roi_dir, mat_dir):
        d.mkdir()
    for s in (1, 2):
        img, _ = _synthetic_cell_image(s)
        tiffio.write_tiff16(str(img_dir / f"S{s:02d}_0.tif"), img.astype(np.uint16))
        troiio.save_roi_bundle(str(roi_dir / f"S{s:02d}.json"), f"S{s:02d}",
                               img.shape, CELLS)
    _write_mat_v73(str(mat_dir / "BNDb_e1s1.mat"), [[MAT_POLY]])
    args = (str(img_dir), str(roi_dir))
    out = {}
    for mat in (False, True):
        kw = dict(mat_dir=str(mat_dir) if mat else None, **QUIET)
        out[("j", mat)] = jfa.save_fa_figs(*args, str(root / f"j{mat}"),
                                           jfa.FaConfig(**CFG), **kw)
        out[("t", mat)] = tfa.save_fa_figs(*args, str(root / f"t{mat}"),
                                           tfa.FaConfig(**CFG), device="cpu", **kw)
    out["crops"] = (jfa.export_fa_crops(*args, str(root / "jc"), jfa.FaConfig(**CFG),
                                        **QUIET),
                    tfa.export_fa_crops(*args, str(root / "tc"), tfa.FaConfig(**CFG),
                                        device="cpu", **QUIET))
    out["root"], out["img_dir"] = root, img_dir
    return out


def _yellow(a):
    return (a[..., 0] > 200) & (a[..., 1] > 200) & (a[..., 2] < 80)


def _magenta(a):
    return (a[..., 0] > 180) & (a[..., 2] > 180) & (a[..., 1] < 100)


@pytest.mark.parametrize("mat", [False, True], ids=["plain", "matlab"])
def test_fa_overview_matches_jax(fa_runs, mat):
    jw, tw = fa_runs[("j", mat)], fa_runs[("t", mat)]
    root = fa_runs["root"]
    assert [os.path.relpath(p, root / f"j{mat}") for p in jw] == \
        [os.path.relpath(p, root / f"t{mat}") for p in tw] == \
        [os.path.join("fig", "S01_FA.png"), os.path.join("fig", "S02_FA.png")]
    for jp, tp in zip(jw, tw):
        t, j = rgb(tp), rgb(jp)
        assert t.shape == j.shape == (1200, 1500, 3)
        whole = (0, 0, 1500, 1200)
        near(occupied(t, whole, not_white, 0.5), occupied(j, whole, not_white, 0.5), 2)
        ib = occupied(j, whole, not_white, 0.5)
        above = (0, 0, 1500, ib[2] - 2)
        near(ink(t, above, dark), ink(j, above, dark), 4)
        near(ink(t, whole, _yellow), ink(j, whole, _yellow), 2)
        matched = mat and tp.endswith("S01_FA.png")
        assert (ink(j, whole, _magenta) is None) == (not matched)
        if matched:
            near(ink(t, whole, _magenta), ink(j, whole, _magenta), 2)
        _, box, _, centers = tfa.fa_fig_layout(256, 320, CELLS,
                                               [MAT_POLY] if matched else [],
                                               "x", 150)
        ax = tpil.ImageAxes(None, box, 320, 256, 150)
        for cx, cy in centers:      # the ROI numbers
            x, y = ax.to_px(cx, cy)
            w = (int(x) - 20, int(1200 - y) - 30, int(x) + 20, int(1200 - y) + 8)
            near(ink(t, w, _yellow), ink(j, w, _yellow), 4)
        # a corner of the frame away from every overlay, enlarged by nearest
        # neighbour in both
        assert nearest_regime(box, 256, 320)
        (xa, ya), (xb, yb) = ax.to_px(2, 2), ax.to_px(30, 25)
        sl = np.s_[int(1200 - ya):int(1200 - yb), int(xa):int(xb)]
        assert np.array_equal(t[sl], j[sl])


def test_fa_crop_export_writes_jax_files(fa_runs):
    jw, tw = fa_runs["crops"]
    root = fa_runs["root"]
    names = [os.path.relpath(p, root / "tc") for p in tw]
    assert names == [os.path.relpath(p, root / "jc") for p in jw] == [
        os.path.join("crops_export", f"S{s:02d}", f"Cell_{c}.png")
        for s in (1, 2) for c in (1, 2)]
    for k, (jp, tp) in enumerate(zip(jw, tw)):
        t, j = rgb(tp), rgb(jp)
        assert t.shape == j.shape == (500, 500, 3)
        roi = CELLS[k % 2]      # the crop window of export_fa_crops
        x0, y0 = int(np.floor(roi[:, 0].min())) - 5, int(np.floor(roi[:, 1].min())) - 5
        w = int(np.ceil(roi[:, 0].max())) + 5 - x0
        h = int(np.ceil(roi[:, 1].max())) + 5 - y0
        box, cax = tr.fa_crop_layout(w, h, 500, 500, 300)
        xs, ys = tpil.ImageAxes(None, box, w, h, 300).to_px(roi[:, 0] - x0, roi[:, 1] - y0)
        ow = window((xs.min(), ys.min(), xs.max(), ys.max()), 500, 6)
        ow = (ow[0], ow[1], min(ow[2], int(cax[0]) - 2), ow[3])   # no colorbar
        near(ink(t, ow, _dash_grey), ink(j, ow, _dash_grey), 2)
        bar = window((cax[0], cax[1], cax[2] + 3.5 * 300 / 72, cax[3]), 500, 3)
        near(ink(t, bar, white), ink(j, bar, white), 2)


def test_fa_figures_default_to_the_card(fa_runs, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (str(fa_runs["img_dir"]), str(fa_runs["img_dir"]), "never", tfa.FaConfig())
    for fn in (tfa.save_fa_figs, tfa.export_fa_crops):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(*args, **QUIET)
    assert not os.path.exists("never")


# ------------------------------------------------------------------ MATLAB files


def test_find_matching_mat_equals_jax(tmp_path):
    """The cases of tests/test_matlab_facrops.py, both packages."""
    d = tmp_path / "mat"
    d.mkdir()

    def both(folder, tag):
        got = troiio.find_matching_mat(str(folder), tag)
        assert got == jroiio.find_matching_mat(str(folder), tag)
        return got

    assert both(tmp_path / "nope", "S01") is None
    assert both(d, "S01") is None
    (d / "BNDb_e1s1.mat").write_bytes(b"")
    assert both(d, "S01") == str(d / "BNDb_e1s1.mat")
    (d / "BNDb_S01.mat").write_bytes(b"")
    assert both(d, "S01") == str(d / "BNDb_S01.mat")
    (d / "S01.mat").write_bytes(b"")
    assert both(d, "S01") == str(d / "S01.mat")
    assert both(d, "S99") is None
    assert both(d, "stage") is None


def test_load_matlab_boundaries_equals_jax(tmp_path):
    p1 = np.array([[10.0, 20.0], [40.0, 22.0], [38.0, 50.0]])
    p2 = np.array([[60.0, 60.0], [90.0, 62.0], [88.0, 95.0], [58.0, 92.0]])
    path = str(tmp_path / "BNDb_e1s1.mat")
    _write_mat_v73(path, [[p1], [p2, p1]])
    got = troiio.load_matlab_boundaries(path)
    want = jroiio.load_matlab_boundaries(path)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert troiio.load_matlab_boundaries(path, dataset="absent") == []


def test_load_matlab_boundaries_without_h5py_raises(tmp_path, monkeypatch):
    """No silent skip of the overlay: without h5py the read raises."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        troiio.load_matlab_boundaries(str(tmp_path / "x.mat"))


# ------------------------------------------------------------------ text metrics


def test_lp_table_is_matplotlibs():
    """The port's "lp" metrics at the layout dpi are matplotlib's
    (autohinted) ones, and its widths within half a pixel plus 1%."""
    from matplotlib.backends.backend_agg import RendererAgg
    from matplotlib.font_manager import FontProperties

    r = RendererAgg(10, 10, tpil.FIG_DPI)
    for (pt, bold), (h, d) in tpil._LP_AT_FIG_DPI.items():
        prop = FontProperties(size=pt, weight="bold" if bold else "normal")
        assert r.get_text_width_height_descent("lp", prop, False)[1:] == (h, d)
        for s in ("Intensity", "0.35", "FRET ratio", "S01  alpha=3.0"):
            w = r.get_text_width_height_descent(s, prop, False)[0]
            got = tpil.text_metrics(s, pt, tpil.FIG_DPI, bold)[0]
            assert abs(got - w) <= 0.5 + 0.01 * w, (s, pt, got, w)
