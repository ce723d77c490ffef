"""Direct-PIL compositor of the PNG image outputs.

Port of ``imageprocess_tpu/report/pilcomp.py``: the same functions, giving
the same pixels for the same inputs, plus ``stamp_colorbar``, which draws
the JAX package's matplotlib inset colorbar (``render.add_short_colorbar``)
with PIL.  The geometry it reproduces is matplotlib's:

  - the canvas is ``figsize * dpi`` (or the explicit ``out_px``), filled
    with the facecolor;
  - the image is letterboxed into it center-anchored with aspect
    preserved -- an imshow axes stretched to the full figure;
  - alpha-0 pixels (masked / non-finite) show the facecolor through;
  - the scalebar is a white bar + DejaVu Sans label with a 40%-alpha
    black box, at ``pt * dpi / 72`` pixels.

Text is DejaVu Sans from ``fonts/DejaVuSans.ttf`` beside this module, a
byte-for-byte copy of matplotlib 3.10.8's ``mpl-data/fonts/ttf`` file (the
face the JAX compositor reads from matplotlib); PIL must have FreeType.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# matplotlib's default figsize (rcParams figure.figsize): the borderless
# savers never override it, so canvas = (6.4, 4.8) * dpi
_DEFAULT_FIGSIZE = (6.4, 4.8)

_FONT_CACHE: dict = {}
FONT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts",
                         "DejaVuSans.ttf")


def _dejavu(px: float, exact: bool = False) -> ImageFont.FreeTypeFont:
    """DejaVu Sans at a pixel size, from the committed font file: rounded to
    whole pixels as the JAX compositor does, or, with *exact*, at the
    fractional size matplotlib renders (``pt * dpi / 72``).  Raises when PIL
    was built without FreeType: PIL's bitmap default font would change
    every glyph."""
    px = round(float(px), 3) if exact else max(1, int(round(px)))
    f = _FONT_CACHE.get(px)
    if f is None:
        from PIL import features

        if not features.check("freetype2"):
            raise RuntimeError("PIL was built without FreeType: the PNG text "
                               f"needs {FONT_PATH} through ImageFont.truetype")
        f = ImageFont.truetype(FONT_PATH, px)
        _FONT_CACHE[px] = f
    return f


def _resample_for(src_w: int, dst_w: int):
    """Lanczos only when DOWNSCALING (anti-aliasing needed); bilinear for
    upscales — visually equivalent to matplotlib's 'antialiased' mode
    (which degrades to nearest at large upsample factors) at a third of
    the filter cost, and upscaled crop canvases dominate the morphology
    render wall."""
    return Image.LANCZOS if dst_w < src_w else Image.BILINEAR


def letterbox_geometry(img_w: int, img_h: int, canvas_w: int, canvas_h: int):
    """(offset_x, offset_y, draw_w, draw_h) of the aspect-preserving,
    center-anchored image box inside the canvas."""
    scale = min(canvas_w / img_w, canvas_h / img_h)
    dw = max(1, int(round(img_w * scale)))
    dh = max(1, int(round(img_h * scale)))
    return (canvas_w - dw) // 2, (canvas_h - dh) // 2, dw, dh


def compose_borderless(
    rgba: np.ndarray,
    out_px: Optional[Tuple[int, int]],
    dpi: int,
    facecolor: Tuple[int, int, int] = (0, 0, 0),
) -> Tuple[Image.Image, Tuple[int, int, int, int]]:
    """RGBA u8 array -> letterboxed canvas image.

    Returns (canvas, (ox, oy, dw, dh)) where the tuple is the image box in
    canvas pixels (needed to map data coordinates for overlays)."""
    ih, iw = rgba.shape[:2]
    if out_px:
        cw, ch = int(out_px[0]), int(out_px[1])
    else:
        cw = int(round(_DEFAULT_FIGSIZE[0] * dpi))
        ch = int(round(_DEFAULT_FIGSIZE[1] * dpi))
    ox, oy, dw, dh = letterbox_geometry(iw, ih, cw, ch)
    canvas = Image.new("RGBA", (cw, ch), facecolor + (255,))
    src = Image.fromarray(rgba, "RGBA")
    if (dw, dh) != (iw, ih):
        src = src.resize((dw, dh), _resample_for(iw, dw))
    # paste with the alpha channel as mask: masked/non-finite pixels keep
    # the facecolor, exactly the savefig composite over the figure patch
    canvas.paste(src, (ox, oy), src)
    return canvas, (ox, oy, dw, dh)


def stamp_scalebar(
    canvas: Image.Image,
    box: Tuple[int, int, int, int],
    img_w: int,
    img_h: int,
    spec,
    lw_pt: float = 3.0,
    font_pt: float = 10.0,
    dpi: int = 300,
) -> None:
    """Paint a ScalebarSpec (render.scalebar_spec, data coordinates) onto
    the composed canvas: white bar + white label over a 40%-alpha black box
    (Fluor_INT.py:588-613)."""
    to_canvas = _mapper(box, img_w, img_h)
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    dr = ImageDraw.Draw(overlay)

    x0, y = to_canvas(spec.x0, spec.y)
    x1, _ = to_canvas(spec.x1, spec.y)
    lw_px = max(1.0, lw_pt * dpi / 72.0)
    dr.rectangle([x0, y - lw_px / 2.0, x1, y + lw_px / 2.0],
                 fill=(255, 255, 255, 255))

    font = _dejavu(font_pt * dpi / 72.0)
    cx, ly = to_canvas((spec.x0 + spec.x1) / 2.0, spec.label_y)
    label = spec.label
    bb = dr.textbbox((0, 0), label, font=font)
    tw, th = bb[2] - bb[0], bb[3] - bb[1]
    tx = cx - tw / 2.0 - bb[0]
    ty = (ly - th - bb[1]) if spec.label_va == "bottom" else (ly - bb[1])
    pad = max(1.0, dpi / 72.0)  # mpl bbox pad=1 (points)
    dr.rectangle([tx + bb[0] - pad, ty + bb[1] - pad,
                  tx + bb[0] + tw + pad, ty + bb[1] + th + pad],
                 fill=(0, 0, 0, 102))  # black, alpha 0.4
    dr.text((tx, ty), label, font=font, fill=(255, 255, 255, 255))
    canvas.alpha_composite(overlay)


def _mapper(box: Tuple[int, int, int, int], img_w: int, img_h: int):
    """data-coordinate (imshow pixel-center) -> canvas-pixel mapping for an
    image letterboxed at *box*."""
    ox, oy, dw, dh = box
    sx, sy = dw / img_w, dh / img_h

    def to_canvas(x, y):
        return ox + (x + 0.5) * sx, oy + (y + 0.5) * sy

    return to_canvas


def stamp_polyline(
    canvas: Image.Image,
    box: Tuple[int, int, int, int],
    img_w: int,
    img_h: int,
    pts: np.ndarray,
    color: Tuple[int, int, int, int] = (0, 255, 255, 255),
    lw_pt: float = 1.5,
    dpi: int = 200,
    close: bool = True,
) -> None:
    """Closed polygon outline in data coordinates (the cyan ROI outlines of
    the morphology overlays, MOR_by_ROI.py:436-505)."""
    to_canvas = _mapper(box, img_w, img_h)
    P = np.asarray(pts, np.float64)
    xy = [to_canvas(x, y) for x, y in P]
    if close and len(xy) > 1:
        xy.append(xy[0])
    lw = max(1, int(round(lw_pt * dpi / 72.0)))
    dr = ImageDraw.Draw(canvas)
    dr.line(xy, fill=color, width=lw, joint="curve")


def stamp_text(
    canvas: Image.Image,
    box: Tuple[int, int, int, int],
    img_w: int,
    img_h: int,
    xy_data: Tuple[float, float],
    text: str,
    font_pt: float = 10.0,
    dpi: int = 200,
    fill: Tuple[int, int, int, int] = (255, 255, 255, 255),
    box_rgba: Optional[Tuple[int, int, int, int]] = None,
    ha: str = "center",
    va: str = "center",
) -> None:
    """Text at a data coordinate with optional background box (the numbered
    ROI labels of the full-frame overlay)."""
    to_canvas = _mapper(box, img_w, img_h)
    cx, cy = to_canvas(*xy_data)
    font = _dejavu(font_pt * dpi / 72.0)
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    dr = ImageDraw.Draw(overlay)
    bb = dr.textbbox((0, 0), text, font=font)
    tw, th = bb[2] - bb[0], bb[3] - bb[1]
    tx = cx - bb[0] - (tw / 2.0 if ha == "center" else (tw if ha == "right" else 0.0))
    ty = cy - bb[1] - (th / 2.0 if va == "center" else (th if va == "bottom" else 0.0))
    if box_rgba is not None:
        pad = max(1.0, dpi / 72.0)
        dr.rectangle([tx + bb[0] - pad, ty + bb[1] - pad,
                      tx + bb[0] + tw + pad, ty + bb[1] + th + pad],
                     fill=box_rgba)
    dr.text((tx, ty), text, font=font, fill=fill)
    canvas.alpha_composite(overlay)


def compose_titled(
    rgba: np.ndarray,
    canvas_w: int,
    title: str,
    font_pt: float = 9.0,
    dpi: int = 220,
    facecolor: Tuple[int, int, int] = (255, 255, 255),
    text_rgb: Tuple[int, int, int] = (0, 0, 0),
    max_upscale: Optional[float] = None,
) -> Tuple[Image.Image, Tuple[int, int, int, int]]:
    """Image scaled to *canvas_w* with a centered one-line title strip above
    it (the morphology crop figure's title, MOR_by_ROI.py:478-489).  Returns
    (canvas, image box).

    *max_upscale* caps the blow-up of small crops: the reference's
    fixed-figure-size export renders a ~190-px cell crop onto an 1100-px
    canvas — pure interpolation pixels whose PNG encode dominates the
    image-output morphology wall.  Capped canvases carry the same
    information at a fraction of the encode cost; pass None for the exact
    reference geometry (MorConfig.mpl_canvas)."""
    ih, iw = rgba.shape[:2]
    dw = canvas_w
    if max_upscale is not None and canvas_w > iw * max_upscale:
        dw = max(1, int(round(iw * max_upscale)))
    dh = max(1, int(round(ih * (dw / iw))))
    font_px = font_pt * dpi / 72.0
    strip = int(round(font_px * 1.5 + 2 * dpi / 72.0))
    canvas = Image.new("RGBA", (dw, strip + dh), facecolor + (255,))
    src = Image.fromarray(rgba, "RGBA")
    if (dw, dh) != (iw, ih):
        src = src.resize((dw, dh), _resample_for(iw, dw))
    canvas.paste(src, (0, strip), src)
    font = _dejavu(font_px)
    dr = ImageDraw.Draw(canvas)
    bb = dr.textbbox((0, 0), title, font=font)
    tw, th = bb[2] - bb[0], bb[3] - bb[1]
    if tw > dw - 8:  # capped canvas narrower than the title: shrink to fit
        font = _dejavu(font_px * (dw - 8) / tw)
        bb = dr.textbbox((0, 0), title, font=font)
        tw, th = bb[2] - bb[0], bb[3] - bb[1]
    dr.text((dw / 2.0 - tw / 2.0 - bb[0], strip / 2.0 - th / 2.0 - bb[1]),
            title, font=font, fill=text_rgb + (255,))
    return canvas, (0, strip, dw, dh)


# The inset colorbar of the JAX package's matplotlib saver
# (render.add_short_colorbar after plt.subplots() and imshow), its sizes
# read from matplotlib 3.10.8's default rcParams: figure.subplot.* (the
# image axes' box when the colorbar is placed), axes.linewidth (the
# outline), ytick.major.width / .pad, tick_params(length=3), font.size
# ("medium" tick labels and label) and axes.labelpad; sizes in points.
_SUBPLOT_BOX = (0.125, 0.11, 0.9, 0.88)     # left, bottom, right, top
_CB_OUTLINE_PT = 0.8
_CB_TICK_LEN_PT = 3.0
_CB_TICK_W_PT = 0.8
_CB_TICK_PAD_PT = 3.5
_CB_FONT_PT = 10.0
_CB_LABELPAD_PT = 4.0
_WHITE = (255, 255, 255, 255)


def colorbar_rect(img_w: int, img_h: int) -> Tuple[float, float, float, float]:
    """[x0, y0, w, h] of the inset colorbar in figure fractions (y from the
    bottom), as the JAX saver places it: from the image axes' position
    before it fills the figure -- the aspect-equal box, centered in the
    default subplot box of the default figure size -- 0.01 right of it,
    0.02 wide, 2/3 of its height, centered vertically.  ``out_px`` only
    rescales the figure afterwards, so the fractions hold for every
    canvas."""
    fw, fh = _DEFAULT_FIGSIZE
    left, bottom, right, top = _SUBPLOT_BOX
    bw, bh = (right - left) * fw, (top - bottom) * fh
    if img_h / img_w > bh / bw:
        w, h = bh * img_w / img_h, bh
    else:
        w, h = bw, bw * img_h / img_w
    x1 = (left * fw + (bw - w) / 2.0 + w) / fw
    y0 = (bottom * fh + (bh - h) / 2.0) / fh
    hf = h / fh
    cb_h = hf * (2.0 / 3.0)
    return x1 + 0.01, y0 + (hf - cb_h) / 2.0, 0.02, cb_h


def _fill_px(dr: ImageDraw.ImageDraw, x0: float, y0: float, x1: float,
             y1: float, fill) -> None:
    """Fill the pixels whose centers lie in [x0, x1) x [y0, y1)."""
    c0, c1 = int(np.ceil(x0 - 0.5)), int(np.ceil(x1 - 0.5))
    r0, r1 = int(np.ceil(y0 - 0.5)), int(np.ceil(y1 - 0.5))
    if c1 > c0 and r1 > r0:
        dr.rectangle([c0, r0, c1 - 1, r1 - 1], fill=fill)


def stamp_colorbar(
    canvas: Image.Image,
    img_w: int,
    img_h: int,
    lut: np.ndarray,
    vmin: float,
    vmax: float,
    label: str,
    dpi: int = 300,
) -> None:
    """Draw the JAX saver's inset colorbar onto a composed canvas: 256
    gradient bands of *lut* (vmin at the bottom) in :func:`colorbar_rect`,
    a white outline, white endpoint ticks on the right, the two tick labels
    ``f"{vmin:.2f}"`` / ``f"{vmax:.2f}"`` and *label* rotated 90 degrees
    right of them; points are ``dpi / 72`` pixels.  Like matplotlib's, the
    bar may sit over the image and its text may run off the canvas."""
    cw, ch = canvas.size
    px = dpi / 72.0
    fx, fy, fw, fh = colorbar_rect(img_w, img_h)
    left, right = fx * cw, (fx + fw) * cw
    top, bottom = (1.0 - fy - fh) * ch, (1.0 - fy) * ch

    # gradient: pixel row r shows the band under its center
    r0, r1 = int(np.ceil(top - 0.5)), int(np.ceil(bottom - 0.5))
    c0, c1 = int(np.ceil(left - 0.5)), int(np.ceil(right - 0.5))
    if r1 > r0 and c1 > c0:
        rows = np.arange(r0, r1) + 0.5
        band = np.clip(((bottom - rows) / (bottom - top) * 256.0).astype(np.int64),
                       0, 255)
        strip = np.repeat(np.asarray(lut, np.uint8)[band][:, None, :], c1 - c0, 1)
        strip[..., 3] = 255
        canvas.paste(Image.fromarray(strip, "RGBA"), (c0, r0))

    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    dr = ImageDraw.Draw(overlay)
    lw = _CB_OUTLINE_PT * px / 2.0
    _fill_px(dr, left - lw, top - lw, right + lw, top + lw, _WHITE)
    _fill_px(dr, left - lw, bottom - lw, right + lw, bottom + lw, _WHITE)
    _fill_px(dr, left - lw, top - lw, left + lw, bottom + lw, _WHITE)
    _fill_px(dr, right - lw, top - lw, right + lw, bottom + lw, _WHITE)
    tw = _CB_TICK_W_PT * px / 2.0
    for y in (top, bottom):
        _fill_px(dr, right, y - tw, right + _CB_TICK_LEN_PT * px, y + tw, _WHITE)

    # tick labels: ink left at the tick's end + pad, baseline half the
    # ascent of "lp" below the tick (matplotlib's center_baseline)
    font = _dejavu(_CB_FONT_PT * px, exact=True)
    asc_lp = -font.getbbox("lp", anchor="ls")[1]
    tx = right + (_CB_TICK_LEN_PT + _CB_TICK_PAD_PT) * px
    text_right = right + _CB_TICK_LEN_PT * px
    for value, y in ((vmin, bottom), (vmax, top)):
        text = f"{value:.2f}"
        bb = font.getbbox(text, anchor="ls")
        x = tx - bb[0]
        dr.text((x, y + asc_lp / 2.0), text, font=font, fill=_WHITE, anchor="ls")
        text_right = max(text_right, x + bb[2])

    # the label: rotated 90 degrees (reads upwards), its ascent line
    # labelpad right of the tick labels, its ink centered on the bar
    if label.strip():
        bb = font.getbbox(label, anchor="ls")
        asc = max(asc_lp, -bb[1])
        w, h = bb[2] - bb[0], bb[3] - bb[1]
        mask = Image.new("L", (max(1, int(np.ceil(w))) + 2,
                               max(1, int(np.ceil(h))) + 2), 0)
        ImageDraw.Draw(mask).text((1 - bb[0], 1 - bb[1]), label, font=font,
                                  fill=255, anchor="ls")
        mask = mask.rotate(90, expand=True)
        # after the rotation the ascent faces left: the baseline is column
        # 1 - bb[1] of the mask
        ink = mask.getbbox()
        base_x = text_right + _CB_LABELPAD_PT * px + asc
        x0 = base_x - (1 - bb[1])
        y0 = (top + bottom) / 2.0 - (ink[1] + ink[3]) / 2.0
        overlay.paste(Image.new("RGBA", mask.size, _WHITE),
                      (int(round(x0)), int(round(y0))), mask)
    canvas.alpha_composite(overlay)


def _write_png_rgb(arr: np.ndarray, out_path: str) -> None:
    """Minimal PNG writer for opaque u8 RGB canvases: SUB row filter done
    vectorized in numpy (u8 wraparound subtraction is exactly the PNG
    filter arithmetic), one level-1 filtered-strategy deflate stream.

    Measured on real morphology crop canvases (1100-px upscaled gray cell
    + overlays): ~50 ms vs PIL's 64 ms at the same level-1 size and 128 ms
    at its default path — the PNG encode is the wall of every image-output
    workload once the draws are PIL stamps, so the filter pass is worth
    owning.  Round-trips bit-exact through PIL decode."""
    import struct
    import zlib

    H, W, C = arr.shape
    raw = np.ascontiguousarray(arr).reshape(H, W * C)
    body = np.empty((H, W * C + 1), np.uint8)
    body[:, 0] = 1  # SUB filter on every row
    body[:, 1:C + 1] = raw[:, :C]
    body[:, C + 1:] = raw[:, C:] - raw[:, :-C]
    co = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    idat = co.compress(body.tobytes()) + co.flush()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    hdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(out_path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
                + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def save_canvas_png(canvas: Image.Image, out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    # the canvas is fully opaque (facecolor-backed composite): encode RGB,
    # 25% less data through the deflate wall than RGBA for the same image
    _write_png_rgb(np.asarray(canvas.convert("RGB")), out_path)


def save_borderless_png(
    rgba: np.ndarray,
    out_path: str,
    dpi: int = 300,
    out_px: Optional[Tuple[int, int]] = None,
    scalebar_spec=None,
    sb_lw_pt: float = 3.0,
    sb_font_pt: float = 10.0,
) -> None:
    """The full borderless pipeline: letterbox-compose, optional scalebar,
    PNG write.  Drop-in render path for save_png_colormap / save_png_gray /
    save_png_image when no colorbar is requested."""
    ih, iw = rgba.shape[:2]
    canvas, box = compose_borderless(rgba, out_px, dpi)
    if scalebar_spec is not None:
        stamp_scalebar(canvas, box, iw, ih, scalebar_spec,
                       lw_pt=sb_lw_pt, font_pt=sb_font_pt, dpi=dpi)
    save_canvas_png(canvas, out_path)
