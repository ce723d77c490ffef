"""Port parity of the PNG image outputs' building blocks on the CPU:
``report.cmaps`` (the committed LUT table and the black -> colour ramps),
``report.pilcomp`` (the compositor, the committed font, the inset
colorbar) and the savers of ``report.render``, against matplotlib 3.10.8
and the JAX package on the same inputs.

Bars: every LUT of the table equals matplotlib's; the ramps equal JAX's
and matplotlib's; ``colormap_rgba_u8`` and every compositor function give
JAX's pixels exactly, so the PNGs are byte-equal (the writer is the same).
The inset colorbar is matplotlib's in the JAX package and a PIL drawing in
the port, held to visual parity: the same canvas size, the gradient box
within 2 px of matplotlib's on each edge, its centre column within one LUT
step row by row 2 px in from the edges, the three text boxes within 4 px,
and the image pixel-equal at identity scale.
"""

import hashlib
import io
import os
from dataclasses import astuple

import numpy as np
import pytest
from PIL import Image

# the reference here is matplotlib, which a machine with a card may lack
# (this file holds no card test)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.colors import LinearSegmentedColormap  # noqa: E402

from imageprocess_tpu.report import pilcomp as jpil  # noqa: E402
from imageprocess_tpu.report import render as jr  # noqa: E402
from imageprocess_tpu_torch.report import cmaps  # noqa: E402
from imageprocess_tpu_torch.report import pilcomp as tpil  # noqa: E402
from imageprocess_tpu_torch.report import render as tr  # noqa: E402
from test_torch_tiffout import colorbar_rect_px, lut_step  # noqa: E402

MPL_NAMES = sorted(matplotlib.colormaps)
COLORS = ["Cyan", "Yellow", "Green", "Red", "Blue", "Magenta"]
FONT_PX = 10.0 * 300 / 72.0            # a 10 pt label at dpi 300


def _mpl_lut(cm):
    return (cm(np.linspace(0.0, 1.0, 256)) * 255.0 + 0.5).astype(np.uint8)


# ------------------------------------------------------------------ cmaps


def test_lut_table_names_are_matplotlibs():
    assert matplotlib.__version__ == "3.10.8"
    assert cmaps.names() == MPL_NAMES and len(MPL_NAMES) == 180
    assert "jet_r" in MPL_NAMES and "turbo" in MPL_NAMES


@pytest.mark.parametrize("name", MPL_NAMES)
def test_lut_equals_matplotlib(name):
    """The record of how the table was made: regenerated from matplotlib as
    the JAX package's ``render._cmap_lut_u8`` samples it."""
    lut = cmaps.lut_u8(name)
    assert lut.dtype == np.uint8 and lut.shape == (256, 4)
    assert np.array_equal(lut, _mpl_lut(plt.get_cmap(name)))
    assert np.array_equal(lut, jr._cmap_lut_u8(name))


@pytest.mark.parametrize("color", COLORS + ["Grayscale", None, "Orange"])
def test_single_color_ramps_match_jax(color):
    got, want = tr.get_cmap_for_color(color), jr.get_cmap_for_color(color)
    if isinstance(want, str):
        assert got == want == "gray"
        return
    assert np.array_equal(got, jr._cmap_lut_u8(want))
    assert np.array_equal(got, cmaps.single_color_lut(color.lower()))


@pytest.mark.parametrize("color", [c.lower() for c in COLORS])
def test_css_ramps_match_matplotlibs_from_list(color):
    """The FA crop's ramps go to the CSS colour: green is (0, 0.502, 0),
    not the pure green of the channel ramps."""
    want = _mpl_lut(LinearSegmentedColormap.from_list(f"custom_{color}", ["black", color]))
    assert np.array_equal(cmaps.css_ramp_lut(color), want)
    assert (color == "green") == (not np.array_equal(
        cmaps.css_ramp_lut(color), cmaps.single_color_lut(color)))


def test_unknown_colormap_raises_naming_the_table():
    with pytest.raises(ValueError, match="_cmap_luts.npz"):
        cmaps.lut_u8("no_such_cmap")
    with pytest.raises(ValueError, match="LUT table"):
        tr.colormap_rgba_u8(np.zeros((2, 2), np.float32), "Jet", 0.0, 1.0)
    with pytest.raises(ValueError, match="uint8"):
        cmaps.lut_u8(np.zeros((256, 4), np.float32))


def test_font_is_matplotlibs_copy_byte_for_byte():
    ttf = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf")
    for name in ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "LICENSE_DEJAVU"):
        with open(os.path.join(ttf, name), "rb") as f:
            want = hashlib.sha256(f.read()).hexdigest()
        with open(os.path.join(os.path.dirname(tpil.FONT_PATH), name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == want, name
    assert tpil._dejavu(FONT_PX).path == tpil.FONT_PATH


def test_font_without_freetype_raises(monkeypatch):
    from PIL import features

    monkeypatch.setattr(features, "check", lambda name: name != "freetype2")
    monkeypatch.setattr(tpil, "_FONT_CACHE", {})
    with pytest.raises(RuntimeError, match="FreeType"):
        tpil._dejavu(12)


# ------------------------------------------------------------------ colormap_rgba_u8
# (tests/test_render_u8.py on the port, each also equal to the JAX function)


def _mpl_oracle(img, cmap, vmin, vmax):
    norm = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax, clip=True)
    return (plt.get_cmap(cmap)(norm(img)) * 255.0 + 0.5).astype(np.uint8)


def _same_as_jax(img, cmap, vmin=None, vmax=None, mask=None):
    got = tr.colormap_rgba_u8(img, cmap, vmin, vmax, mask=mask)
    assert np.array_equal(got, jr.colormap_rgba_u8(img, cmap, vmin, vmax, mask=mask))
    return got


@pytest.mark.parametrize("cmap", ["gray", "jet", "viridis"])
def test_matches_mpl_within_one_lut_step(cmap):
    rng = np.random.default_rng(0)
    img = rng.uniform(-50.0, 4000.0, size=(64, 80)).astype(np.float32)
    ours = _same_as_jax(img, cmap, 0.0, 3500.0)
    ref = _mpl_oracle(img, cmap, 0.0, 3500.0)
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= lut_step(cmap)
    assert np.mean((ours == ref).all(axis=-1)) > 0.97


def test_degenerate_range_is_flat_not_nan():
    out = _same_as_jax(np.full((8, 8), 7.0, np.float32), "gray", 7.0, 7.0)
    assert out.dtype == np.uint8 and (out == out[0, 0]).all()


def test_nonfinite_and_mask_get_alpha_zero():
    img = np.ones((4, 4), np.float32)
    img[0, 0], img[1, 1] = np.nan, np.inf
    mask = np.ones((4, 4), bool)
    mask[2, 2] = False
    out = _same_as_jax(img, "jet", 0.0, 2.0, mask)
    assert out[0, 0, 3] == 0 and out[1, 1, 3] == 0 and out[2, 2, 3] == 0
    assert out[3, 3, 3] == 255


def test_auto_range_ignores_masked_and_nonfinite():
    img = np.zeros((4, 4), np.float32)
    img[0, 0], img[3, 3] = np.nan, 1e9
    img[1:3, 1:3] = [[10, 20], [30, 40]]
    mask = np.ones((4, 4), bool)
    mask[3, 3] = False
    out = _same_as_jax(img, "gray", mask=mask)
    assert out[2, 2, 0] == 255 and 0 < out[1, 2, 0] < 255


def test_tiny_window_hot_pixels_clip_to_top():
    """The float clip before the int cast: far-over-range pixels take the
    top LUT entry, not INT32_MIN's."""
    img = np.zeros((4, 4), np.float32)
    img[1, 1], img[2, 2] = 65535.0, -65535.0
    with np.errstate(invalid="raise"):
        out = _same_as_jax(img, "gray", 0.0, 1e-3)
    assert out[1, 1, 0] == 255 and out[2, 2, 0] == 0 and out[0, 0, 0] == 0


def test_all_masked_frame_does_not_crash():
    out = _same_as_jax(np.full((4, 4), np.nan, np.float32), "gray")
    assert out.shape == (4, 4, 4) and (out[..., 3] == 0).all()


def test_lut_given_as_array():
    img = np.linspace(0, 1, 48, dtype=np.float32).reshape(6, 8)
    lut = tr.get_cmap_for_color("Magenta")
    got = tr.colormap_rgba_u8(img, lut, 0.0, 1.0)
    assert np.array_equal(got, jr.colormap_rgba_u8(
        img, jr.get_cmap_for_color("Magenta"), 0.0, 1.0))


# ------------------------------------------------------------------ pilcomp
# (tests/test_pilcomp.py on the port, and every function against JAX's)


def _rgb(canvas):
    return np.array(canvas.convert("RGB"))


def _mpl_borderless(rgba, out_px, dpi):
    fig, ax = plt.subplots()
    ax.set_facecolor("black")
    fig.patch.set_facecolor("black")
    ax.imshow(rgba)
    ax.set_axis_off()
    ax.set_position((0.0, 0.0, 1.0, 1.0))
    if out_px:
        fig.set_size_inches(out_px[0] / dpi, out_px[1] / dpi)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi, facecolor=fig.get_facecolor())
    plt.close(fig)
    buf.seek(0)
    return np.array(Image.open(buf).convert("RGB"))


def _rgba(h, w, cmap="jet", seed=0, masked=False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 4000, size=(h, w)).astype(np.float32)
    mask = rng.random((h, w)) > 0.2 if masked else None
    return tr.colormap_rgba_u8(img, cmap, 0.0, 3500.0, mask=mask)


@pytest.mark.parametrize("cmap", ["gray", "jet"])
def test_identity_scale_pixel_parity(cmap):
    rgba = _rgba(120, 160, cmap)
    ours = _rgb(tpil.compose_borderless(rgba, (160, 120), 300)[0])
    ref = _mpl_borderless(rgba, (160, 120), dpi=300)
    assert ours.shape == ref.shape
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    assert np.mean((ours == ref).all(axis=-1)) > 0.99


def test_identity_scale_masked_pixels_show_black():
    img = np.full((40, 50), 100.0, np.float32)
    mask = np.ones((40, 50), bool)
    mask[5:10, 5:10] = False
    rgba = tr.colormap_rgba_u8(img, "jet", 0.0, 200.0, mask=mask)
    ours = _rgb(tpil.compose_borderless(rgba, (50, 40), 300)[0])
    assert (ours[5:10, 5:10] == 0).all()
    assert np.array_equal(ours, _mpl_borderless(rgba, (50, 40), dpi=300))


@pytest.mark.parametrize("shape,out_px,dpi", [
    ((120, 160), (160, 120), 300), ((50, 100), (300, 300), 100),
    ((333, 250), (500, 500), 300), ((1200, 1700), None, 100),
    ((37, 23), None, 60), ((90, 70), (64, 48), 300)],
    ids=["identity", "up-letterbox", "up-tall", "down-default", "up-default", "down"])
@pytest.mark.parametrize("masked", [False, True], ids=["opaque", "masked"])
def test_compose_borderless_equals_jax(shape, out_px, dpi, masked):
    rgba = _rgba(*shape, masked=masked)
    got, gbox = tpil.compose_borderless(rgba, out_px, dpi)
    want, wbox = jpil.compose_borderless(rgba, out_px, dpi)
    assert gbox == wbox and got.size == want.size
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("dims", [(100, 50, 300, 300), (50, 100, 300, 300),
                                  (2048, 1536, 1920, 1440), (7, 3, 500, 500),
                                  (1, 1, 1, 1)])
def test_letterbox_geometry_equals_jax(dims):
    assert tpil.letterbox_geometry(*dims) == jpil.letterbox_geometry(*dims)
    assert tpil.letterbox_geometry(100, 50, 300, 300) == (0, 75, 300, 150)


@pytest.mark.parametrize("anchor", ["br", "bl", "tr", "tl", "xx"])
@pytest.mark.parametrize("font_pt,dpi", [(10, 300), (14, 150)])
def test_stamp_scalebar_equals_jax(anchor, font_pt, dpi):
    H, W = 200, 300
    rgba = _rgba(H, W)
    spec = tr.scalebar_spec(W, H, 20.0, 0.5, anchor)
    assert astuple(spec) == astuple(jr.scalebar_spec(W, H, 20.0, 0.5, anchor))
    got, box = tpil.compose_borderless(rgba, (420, 400), dpi)
    want, _ = jpil.compose_borderless(rgba, (420, 400), dpi)
    tpil.stamp_scalebar(got, box, W, H, spec, font_pt=font_pt, dpi=dpi)
    jpil.stamp_scalebar(want, box, W, H, spec, font_pt=font_pt, dpi=dpi)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    if anchor in ("br", "xx") and dpi == 300:
        # the bar on the spec's row, from x0 to x1 (test_pilcomp's geometry)
        black = np.zeros((H, W, 4), np.uint8)
        black[..., 3] = 255
        canvas, box = tpil.compose_borderless(black, (W, H), 300)
        tpil.stamp_scalebar(canvas, box, W, H, spec, dpi=300)
        row = _rgb(canvas)[int(spec.y)]
        white = np.where((row == 255).all(axis=-1))[0]
        assert white.size >= 35 and abs(white.min() - spec.x0) <= 2 \
            and abs(white.max() - spec.x1) <= 2


def test_stamp_polyline_and_text_equal_jax():
    H, W = 160, 224
    rgba = _rgba(H, W, "gray")
    P = np.array([[20.5, 20.5], [70.5, 25.5], [65.5, 80.5], [15.5, 75.5]])
    canvases = []
    for pil in (tpil, jpil):
        canvas, box = pil.compose_borderless(rgba, (1600, 1143), dpi=200)
        pil.stamp_polyline(canvas, box, W, H, P, dpi=200)
        pil.stamp_polyline(canvas, box, W, H, P[:3] + 50, color=(255, 0, 0, 255),
                           lw_pt=3.0, dpi=200, close=False)
        for ha, va in (("center", "center"), ("left", "top"), ("right", "bottom")):
            pil.stamp_text(canvas, box, W, H, (100.0, 90.0), "17", font_pt=10,
                           dpi=200, box_rgba=(0, 0, 0, 77), ha=ha, va=va)
        pil.stamp_text(canvas, box, W, H, (10.0, 150.0), "ROI 3 µm", font_pt=7, dpi=300)
        canvases.append(np.asarray(canvas))
    assert np.array_equal(*canvases)


@pytest.mark.parametrize("title,width,cap", [
    ("S01  ROI#1  ch2  AR=1.23  Circ=0.876", 1100, None),
    ("S01  ROI#1  ch2  AR=1.23  Circ=0.876", 1100, 2.0),
    ("a long title " * 4, 1100, 2.0), ("t", 40, None)],
    ids=["reference", "capped", "shrunk", "narrow"])
def test_compose_titled_equals_jax(title, width, cap):
    rgba = _rgba(80, 200, "gray")
    got, gbox = tpil.compose_titled(rgba, width, title, font_pt=9, dpi=220,
                                    max_upscale=cap)
    want, wbox = jpil.compose_titled(rgba, width, title, font_pt=9, dpi=220,
                                     max_upscale=cap)
    assert gbox == wbox and np.array_equal(np.asarray(got), np.asarray(want))


def test_compose_titled_layout():
    rgba = np.full((80, 200, 4), 128, np.uint8)
    rgba[..., 3] = 255
    canvas, (ox, oy, dw, dh) = tpil.compose_titled(rgba, 400, "S01 ROI#1 AR=1.23",
                                                   font_pt=9, dpi=220)
    assert canvas.size == (400, oy + dh) and dw == 400 and dh == 160
    arr = _rgb(canvas)
    assert (arr[:oy] < 100).any() and (arr[oy + 5:oy + dh - 5] == 128).all()
    canvas, (_, oy, dw, dh) = tpil.compose_titled(rgba, 1100, "a long title " * 4,
                                                  font_pt=9, dpi=220, max_upscale=2.0)
    assert (dw, dh) == (400, 160) and (_rgb(canvas)[:oy] < 100).any()


def test_write_png_rgb_is_jaxs_bytes_and_roundtrips(tmp_path):
    rng = np.random.default_rng(3)
    g = np.linspace(0, 255, 50 * 60).reshape(50, 60)
    arrays = [rng.integers(0, 256, size=s, dtype=np.uint8)
              for s in [(1, 1, 3), (7, 5, 3), (64, 100, 3)]]
    arrays.append(np.dstack([g, g / 2, g / 3]).astype(np.uint8))
    for k, arr in enumerate(arrays):
        pt, pj = tmp_path / f"t{k}.png", tmp_path / f"j{k}.png"
        tpil._write_png_rgb(arr, str(pt))
        jpil._write_png_rgb(arr, str(pj))
        assert pt.read_bytes() == pj.read_bytes()
        back = np.array(Image.open(pt))
        assert back.dtype == np.uint8 and np.array_equal(back, arr)


def test_save_borderless_png_equals_jax(tmp_path):
    rgba = tr.colormap_rgba_u8(
        np.linspace(0, 1, 60 * 80, dtype=np.float32).reshape(60, 80), "viridis", 0.0, 1.0)
    spec = tr.scalebar_spec(80, 60, 10.0, 1.0)
    for pil, side in ((tpil, "t"), (jpil, "j")):
        pil.save_borderless_png(rgba, str(tmp_path / side / "y.png"), dpi=300,
                                out_px=(80, 60), scalebar_spec=spec, sb_font_pt=8)
        pil.save_canvas_png(pil.compose_borderless(rgba, None, 50)[0],
                            str(tmp_path / side / "c.png"))
    for name in ("y.png", "c.png"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert Image.open(tmp_path / "t" / "y.png").size == (80, 60)


# ------------------------------------------------------------------ render


def test_geometry_helpers_equal_jax():
    for args in [(5, 90, 7, 60, 128, 96), (-3.5, 200.2, 0, 95.9, 128, 96),
                 (1000, 1100, 1400, 1500, 2048, 1536)]:
        assert tr.crop_bbox(*args) == jr.crop_bbox(*args)
    P = np.array([[10.5, 12.5], [60.5, 15.5], [55.5, 70.5]])
    assert tr.crop_bbox_poly(P, 128, 96) == jr.crop_bbox_poly(P, 128, 96)
    for w, h, um, px in [(300, 200, 20.0, 0.5), (40, 30, 1000.0, 0.1), (500, 500, 0.01, 1.0)]:
        for anchor in ("br", "bl", "tr", "tl", "?"):
            assert astuple(tr.scalebar_spec(w, h, um, px, anchor)) == \
                astuple(jr.scalebar_spec(w, h, um, px, anchor))


@pytest.mark.parametrize("txt", [("", ""), ("0.2", "1.5"), ("junk", ""), ("1.5", "0.2"),
                                 ("", "0.9"), ("0.5", "x")])
def test_vminmax_resolution_equals_jax(txt):
    vals = np.random.default_rng(5).uniform(0.1, 2.0, 500).astype(np.float32)
    assert tr.resolve_vminmax_txt(*txt, vals) == jr.resolve_vminmax_txt(*txt, vals)
    assert tr.resolve_vminmax_txt(*txt, lambda: vals) == jr.resolve_vminmax_txt(*txt, vals)
    for on in (False, True):
        if "junk" in txt or "x" in txt:
            opt = tr.PanelPngOptions(cmap_on=True, cmin=txt[0], cmax=txt[1])
            with pytest.raises(ValueError):
                opt.vminmax(vals, 1.0, 99.0)
            continue
        t = tr.PanelPngOptions(cmap_on=on, cmin=txt[0], cmax=txt[1])
        j = jr.PanelPngOptions(cmap_on=on, cmin=txt[0], cmax=txt[1])
        assert t.vminmax(vals, 2.0, 98.0) == j.vminmax(vals, 2.0, 98.0)


def _both(tmp_path, saver, *args, **kw):
    """Run a saver of both packages into t/x.png and j/x.png; decoded RGB."""
    out = {}
    for mod, side in ((tr, "t"), (jr, "j")):
        path = tmp_path / side / "x.png"
        getattr(mod, saver)(*args, str(path), **kw)
        out[side] = np.array(Image.open(path).convert("RGB"))
    return out["t"], out["j"]


@pytest.mark.parametrize("kw", [
    dict(vmin=0.0, vmax=3000.0, cmap="jet"),
    dict(vmin=None, vmax=None, cmap="gray", out_px=(500, 500)),
    dict(vmin=100.0, vmax=2500.0, cmap="turbo", masked=True, scalebar_um=5.0, px_um=0.2,
         bar_anchor="tl", bar_font=14, out_px=(333, 250), dpi=150),
    dict(vmin=None, vmax=3000.0, cmap="Green", out_px=(500, 500))],
    ids=["full", "auto-range", "masked-scalebar", "ramp"])
def test_save_png_colormap_without_colorbar_equals_jax(tmp_path, kw):
    """Without a colorbar both packages compose with PIL: equal bytes."""
    kw = dict(kw)
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 3500, (120, 150)).astype(np.float32)
    img[:5] = np.nan
    mask = rng.random(img.shape) > 0.3 if kw.pop("masked", False) else None
    for mod, side in ((tr, "t"), (jr, "j")):
        cmap = mod.get_cmap_for_color("Green") if kw["cmap"] == "Green" else kw["cmap"]
        mod.save_png_colormap(img, str(tmp_path / side / "x.png"), mask=mask,
                              **dict(kw, cmap=cmap))
    assert (tmp_path / "t" / "x.png").read_bytes() == (tmp_path / "j" / "x.png").read_bytes()


def test_colorbar_needs_both_bounds(tmp_path):
    """A colorbar asked for without both bounds is not drawn, as in JAX."""
    img = np.random.default_rng(3).uniform(0, 5, (60, 80)).astype(np.float32)
    for show in (True, False):
        tr.save_png_colormap(img, str(tmp_path / f"{show}.png"), vmin=None, vmax=4.0,
                             cmap="jet", show_colorbar=show)
    assert (tmp_path / "True.png").read_bytes() == (tmp_path / "False.png").read_bytes()


@pytest.mark.parametrize("shape,vm,out_px", [((90, 110), (None, None), None),
                                             ((90, 110), (10.0, 2000.0), (500, 500)),
                                             ((300, 40), (0.0, 1.0), (64, 64))])
def test_save_png_gray_equals_jax(tmp_path, shape, vm, out_px):
    img = np.random.default_rng(1).uniform(0, 2500, shape).astype(np.float32)
    img[3, :] = np.inf
    _both(tmp_path, "save_png_gray", img, vmin=vm[0], vmax=vm[1], dpi=300, out_px=out_px)
    assert (tmp_path / "t" / "x.png").read_bytes() == (tmp_path / "j" / "x.png").read_bytes()


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
@pytest.mark.parametrize("scalebar", [None, 3.0, 1000.0], ids=["none", "bar", "clamped"])
def test_save_png_image_equals_jax(tmp_path, rgb, scalebar):
    rng = np.random.default_rng(6)
    img = rng.uniform(-0.1, 1.1, (70, 90) + ((3,) if rgb else ())).astype(np.float32)
    _both(tmp_path, "save_png_image", img, dpi=300, out_px=(500, 500),
          scalebar_um=scalebar, px_um=0.25)
    assert (tmp_path / "t" / "x.png").read_bytes() == (tmp_path / "j" / "x.png").read_bytes()


def test_save_panel_draws_both_image_boxes_on_the_jax_canvas(tmp_path):
    """The 2-up panel of a 4 x 4 frame: the JAX figure's 1800 x 900 canvas
    on white with both image boxes drawn (tests/test_torch_figures.py holds
    it to matplotlib's)."""
    rim = np.ones((4, 4), bool)
    rim[0] = False
    tr.save_panel_intensity_ratio(np.arange(16.0).reshape(4, 4), np.full((4, 4), 0.35),
                                  rim, str(tmp_path / "p.png"), 0.2)
    got = np.array(Image.open(tmp_path / "p.png"))
    assert got.shape == (900, 1800, 3)
    assert (got == 255).all(-1).mean() > 0.3
    lay = tr.panel_layout(4, 4)
    for box in lay["axes"]:   # the ratio's turbo colour at 0.35 / 0.7
        c, r = int((box[0] + box[2]) / 2), int(900 - (box[1] + box[3]) / 2)
        assert not (got[r, c] == 255).all()
    mid = cmaps.lut_u8("turbo")[128, :3]
    box = lay["axes"][1]
    assert np.array_equal(got[int(900 - (box[1] + box[3]) / 2),
                              int((box[0] + box[2]) / 2)], mid)


# ------------------------------------------------------------------ the inset colorbar


def colorbar_boxes(arr, rect, dpi=300):
    """The drawn colorbar of a decoded RGB canvas: the gradient's pixel box
    (coloured pixels near *rect*) and the ink boxes of the white text right
    of the ticks -- the top and bottom tick labels and the rotated label
    (None where nothing is drawn).  Boxes are (x0, x1, y0, y1), inclusive."""
    left, right, top, bottom = rect
    px = dpi / 72.0
    colour = (arr.max(-1).astype(int) - arr.min(-1)) > 60
    y0, y1 = int(top) - 10, int(bottom) + 10
    x0, x1 = int(left) - 10, int(right) + 10
    ys, xs = np.nonzero(colour[max(0, y0):y1, max(0, x0):x1])
    boxes = {"grad": (xs.min() + max(0, x0), xs.max() + max(0, x0),
                      ys.min() + max(0, y0), ys.max() + max(0, y0))}
    white = (arr.min(-1) > 90) & ((arr.max(-1).astype(int) - arr.min(-1)) < 40)
    xr = int(right + 3 * px + 3)                  # right of the ticks
    band = 1.2 * 10 * px                          # a 10 pt line
    for name, (r0, r1) in {"top": (top - band, top + band),
                           "bottom": (bottom - band, bottom + band),
                           "label": (top + band, bottom - band)}.items():
        r0 = max(0, int(r0))
        ys, xs = np.nonzero(white[r0:int(r1), xr:])
        boxes[name] = None if ys.size == 0 else (
            xs.min() + xr, xs.max() + xr, ys.min() + r0, ys.max() + r0)
    return boxes


def _colorbar_image(H, W, vmin, vmax):
    """NaN except the top-left third, so the bar stands on the black
    facecolor."""
    img = np.full((H, W), np.nan, np.float32)
    img[: H // 3, : W // 2] = np.random.default_rng(1).uniform(vmin, vmax,
                                                               (H // 3, W // 2))
    return img


def _colorbar_pngs(tmp_path, H, W, out_px, vmin, vmax, cmap, label):
    """The same figure through both savers; decoded RGB."""
    out = {}
    for mod, side in ((tr, "t"), (jr, "j")):
        path = tmp_path / f"{side}.png"
        mod.save_png_colormap(_colorbar_image(H, W, vmin, vmax), str(path), vmin=vmin,
                              vmax=vmax, cmap=cmap, show_colorbar=True, dpi=300,
                              out_px=out_px, cbar_label=label)
        out[side] = np.array(Image.open(path).convert("RGB")).astype(np.int16)
    return out["t"], out["j"]


@pytest.mark.parametrize("H,W,out_px,vm,cmap,label", [
    (1440, 1920, None, (0.25, 1.75), "jet", "FRET ratio"),
    (120, 130, (500, 500), (0.0, 1.0), "jet", "FRET ratio"),
    (1000, 600, None, (-12.5, 1234.5), "turbo", "ch2 Intensity"),
    (140, 90, (500, 500), (0.4, 0.9), "viridis", "FRET ratio")],
    ids=["1920x1440-identity", "500x500", "tall", "500x500-tall"])
def test_colorbar_matches_matplotlib(tmp_path, H, W, out_px, vm, cmap, label):
    t, j = _colorbar_pngs(tmp_path, H, W, out_px, *vm, cmap, label)
    assert t.shape == j.shape
    ch, cw = t.shape[:2]
    rect = colorbar_rect_px(W, H, cw, ch)
    bt, bj = colorbar_boxes(t, rect), colorbar_boxes(j, rect)
    assert all(abs(a - b) <= 2 for a, b in zip(bt["grad"], bj["grad"])), (bt, bj)
    for name in ("top", "bottom", "label"):
        assert (bt[name] is None) == (bj[name] is None), (name, bt, bj)
        if bj[name] is not None:
            assert all(abs(a - b) <= 4 for a, b in zip(bt[name], bj[name])), (name, bt, bj)
    assert bj["top"] is not None and bj["bottom"] is not None
    # the gradient's centre column, row by row, 2 px in from its edges
    gx0, gx1, gy0, gy1 = bj["grad"]
    cx = (gx0 + gx1) // 2
    d = np.abs(t[gy0 + 2:gy1 - 1, cx] - j[gy0 + 2:gy1 - 1, cx]).max()
    assert d <= lut_step(cmap), d
    # vmax at the top, vmin at the bottom
    lut = cmaps.lut_u8(cmap)[:, :3].astype(np.int16)
    nearest = [int(np.abs(lut - t[y, cx]).sum(-1).argmin()) for y in (gy0 + 2, gy1 - 2)]
    assert nearest[0] >= 240 and nearest[1] <= 15, nearest
    # the image left of the colorbar: pixel-equal at identity scale, and
    # equal to the port's own borderless render at any scale
    left = int(rect[0]) - 10
    if out_px is None and (H, W) == (ch, cw):
        assert np.array_equal(t[:, :left], j[:, :left])
    own = tpil.compose_borderless(
        tr.colormap_rgba_u8(_colorbar_image(H, W, *vm), cmap, *vm), out_px, 300)[0]
    assert np.array_equal(t[:, :left], np.array(own.convert("RGB"))[:, :left])


def test_colorbar_rect_is_the_default_subplot_box():
    """The JAX saver reads the image axes' position before it fills the
    figure: the aspect-equal box in matplotlib's default subplot box."""
    for H, W in [(1440, 1920), (120, 130), (1000, 600), (5, 400)]:
        fig, ax = plt.subplots()
        ax.imshow(np.zeros((H, W, 4), np.uint8))
        ax.set_axis_off()
        want = jr._inset_colorbar_rect(ax.get_position())
        plt.close(fig)
        assert np.allclose(tpil.colorbar_rect(W, H), want, rtol=0, atol=1e-12), (H, W)
