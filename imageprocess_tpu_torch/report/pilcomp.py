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

import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# matplotlib's default figsize (rcParams figure.figsize): the borderless
# savers never override it, so canvas = (6.4, 4.8) * dpi
_DEFAULT_FIGSIZE = (6.4, 4.8)

_FONT_CACHE: dict = {}
FONT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts",
                         "DejaVuSans.ttf")
BOLD_FONT_PATH = os.path.join(os.path.dirname(FONT_PATH), "DejaVuSans-Bold.ttf")


def _dejavu(px: float, exact: bool = False,
            bold: bool = False) -> ImageFont.FreeTypeFont:
    """DejaVu Sans (or Sans Bold) at a pixel size, from the committed font
    files: rounded to whole pixels as the JAX compositor does, or, with
    *exact*, at the fractional size matplotlib renders (``pt * dpi / 72``).
    Raises when PIL was built without FreeType: PIL's bitmap default font
    would change every glyph."""
    px = round(float(px), 3) if exact else max(1, int(round(px)))
    f = _FONT_CACHE.get((px, bold))
    if f is None:
        from PIL import features

        if not features.check("freetype2"):
            raise RuntimeError("PIL was built without FreeType: the PNG text "
                               f"needs {FONT_PATH} through ImageFont.truetype")
        f = ImageFont.truetype(BOLD_FONT_PATH if bold else FONT_PATH, px)
        _FONT_CACHE[(px, bold)] = f
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


def _stamp_gradient(canvas: Image.Image, dr: ImageDraw.ImageDraw, left: float,
                    top: float, right: float, bottom: float, lut: np.ndarray,
                    lw: float, edge) -> None:
    """A colorbar's body in canvas coordinates (rows down): 256 bands of
    *lut*, vmin at the bottom -- pixel row r shows the band under its
    center -- pasted on *canvas*, and its outline of half-width *lw* drawn
    with *dr* (an overlay's)."""
    r0, r1 = int(np.ceil(top - 0.5)), int(np.ceil(bottom - 0.5))
    c0, c1 = int(np.ceil(left - 0.5)), int(np.ceil(right - 0.5))
    if r1 > r0 and c1 > c0:
        rows = np.arange(r0, r1) + 0.5
        band = np.clip(((bottom - rows) / (bottom - top) * 256.0).astype(np.int64),
                       0, 255)
        strip = np.repeat(np.asarray(lut, np.uint8)[band][:, None, :], c1 - c0, 1)
        strip[..., 3] = 255
        canvas.paste(Image.fromarray(strip, "RGBA"), (c0, r0))
    _fill_px(dr, left - lw, top - lw, right + lw, top + lw, edge)
    _fill_px(dr, left - lw, bottom - lw, right + lw, bottom + lw, edge)
    _fill_px(dr, left - lw, top - lw, left + lw, bottom + lw, edge)
    _fill_px(dr, right - lw, top - lw, right + lw, bottom + lw, edge)


def _paste_rotated(overlay: Image.Image, text: str, font, base_x: float,
                   ink_yc: float, fill) -> None:
    """*text* rotated 90 degrees (reading upwards) onto *overlay*: its
    baseline at column *base_x*, its ink centered on row *ink_yc*."""
    bb = font.getbbox(text, anchor="ls")
    w, h = bb[2] - bb[0], bb[3] - bb[1]
    mask = Image.new("L", (max(1, int(np.ceil(w))) + 2, max(1, int(np.ceil(h))) + 2), 0)
    ImageDraw.Draw(mask).text((1 - bb[0], 1 - bb[1]), text, font=font, fill=255,
                              anchor="ls")
    mask = mask.rotate(90, expand=True)
    # after the rotation the ascent faces left: the baseline is column
    # 1 - bb[1] of the mask
    ink = mask.getbbox()
    if ink is not None:
        overlay.paste(Image.new("RGBA", mask.size, fill),
                      (int(round(base_x - (1 - bb[1]))),
                       int(round(ink_yc - (ink[1] + ink[3]) / 2.0))), mask)


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
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    dr = ImageDraw.Draw(overlay)
    _stamp_gradient(canvas, dr, left, top, right, bottom, lut,
                    _CB_OUTLINE_PT * px / 2.0, _WHITE)
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
        asc = max(asc_lp, -font.getbbox(label, anchor="ls")[1])
        _paste_rotated(overlay, label, font, text_right + _CB_LABELPAD_PT * px + asc,
                       (top + bottom) / 2.0, _WHITE)
    canvas.alpha_composite(overlay)


# ---------------------------------------------------------------------------
# The figures that matplotlib lays out in the JAX package (the rim-FRET 2-up
# panel, the FA crop PNGs, the FA overview figures), drawn with PIL after
# matplotlib 3.10.8's geometry at its default rcParams.  Geometry is in
# display pixels, origin at the bottom left and y up, as matplotlib's; boxes
# are (x0, y0, x1, y1).  A figure of ``figsize`` inches at ``dpi`` is a
# canvas of ``int(figsize * dpi)`` pixels; its axes are boxes in figure
# fractions.  The JAX savers lay out at the figure's dpi (``FIG_DPI``) and
# draw at the savefig dpi: the port measures text at the same two dpis.

Box = Tuple[float, float, float, float]

FIG_DPI = 100.0                  # rcParams figure.dpi
SUBPLOT_BOX = (0.125, 0.11, 0.9, 0.88)   # figure.subplot.left/bottom/right/top
SUBPLOT_WSPACE = 0.2             # figure.subplot.wspace
FONT_PT = 10.0                   # font.size: tick and axis labels, offset text
TITLE_PT = 12.0                  # axes.titlesize ("large")
TITLE_PAD_PT = 6.0               # axes.titlepad
TICK_LEN_PT = 3.5                # ytick.major.size
TICK_PAD_PT = 3.5                # ytick.major.pad
LINE_W_PT = 0.8                  # axes.linewidth = ytick.major.width
LABELPAD_PT = 4.0                # axes.labelpad
OFFSET_PAD_PT = 3.0              # YAxis.OFFSETTEXTPAD
MARGIN = 0.05                    # axes.xmargin / ymargin
DASHES = (3.7, 1.6)              # lines.dashed_pattern, times the line width


def figure_px(figsize, dpi) -> Tuple[int, int]:
    """The canvas of a figure: ``int(width * dpi), int(height * dpi)``."""
    return int(figsize[0] * dpi), int(figsize[1] * dpi)


def to_px(box: Box, figsize, dpi) -> Box:
    """A box in figure fractions to display pixels."""
    fw, fh = figsize[0] * dpi, figsize[1] * dpi
    return box[0] * fw, box[1] * fh, box[2] * fw, box[3] * fh


def union(boxes) -> Box:
    boxes = list(boxes)
    return (min(b[0] for b in boxes), min(b[1] for b in boxes),
            max(b[2] for b in boxes), max(b[3] for b in boxes))


def grid_columns(box: Box, ncols: int, wspace: float, ratios=None):
    """The cells of a one-row gridspec spanning *box* (``GridSpecBase
    .get_grid_positions``), each a box of the same units."""
    left, bottom, right, top = box
    ratios = [1.0] * ncols if ratios is None else list(ratios)
    cell_w = (right - left) / (ncols + wspace * (ncols - 1))
    norm = cell_w * ncols / sum(ratios)
    cell_ws = np.cumsum(np.column_stack(
        [[0.0] + [wspace * cell_w] * (ncols - 1), [r * norm for r in ratios]]).flat)
    lefts, rights = (left + cell_ws).reshape((-1, 2)).T
    return [(float(lo), bottom, float(hi), top) for lo, hi in zip(lefts, rights)]


def aspect_box(pos: Box, box_aspect: float, fig_aspect: float,
               anchor=(0.5, 0.5)) -> Box:
    """The active box of an axes of fixed aspect (``Axes.apply_aspect``:
    ``Bbox.shrunk_to_aspect`` then ``anchored``) in figure fractions;
    *box_aspect* is height over width in physical units."""
    left, bottom, right, top = pos
    w, h = right - left, top - bottom
    H = w * box_aspect / fig_aspect
    if H <= h:
        W = w
    else:
        W = h * fig_aspect / box_aspect
        H = h
    x0 = left + anchor[0] * (w - W)
    y0 = bottom + anchor[1] * (h - H)
    return x0, y0, x0 + W, y0 + H


def tight_params(figsize, cells, tight_boxes, pad: float):
    """``tight_layout``'s subplot parameters of a one-row grid: *cells* are
    the grid's cells in figure fractions, *tight_boxes* the union of each
    cell's axes, titles and labels in display pixels at ``FIG_DPI``
    (``_auto_adjust_subplotpars``); None where matplotlib gives up."""
    fw_in, fh_in = figsize
    dpi = FIG_DPI
    pad_inch = pad * FONT_PT / 72.0
    cols = len(cells)
    hspaces = np.zeros(cols + 1)
    vtop, vbottom = np.zeros(cols), np.zeros(cols)
    for c, (cell, tb) in enumerate(zip(cells, tight_boxes)):
        tb = (tb[0] / (fw_in * dpi), tb[1] / (fh_in * dpi),
              tb[2] / (fw_in * dpi), tb[3] / (fh_in * dpi))
        hspaces[c] += cell[0] - tb[0]
        hspaces[c + 1] += tb[2] - cell[2]
        vtop[c] += tb[3] - cell[3]
        vbottom[c] += cell[1] - tb[1]
    left = max(hspaces[0], 0) + pad_inch / fw_in
    right = max(hspaces[-1], 0) + pad_inch / fw_in
    top = max(vtop.max(), 0) + pad_inch / fh_in
    bottom = max(vbottom.max(), 0) + pad_inch / fh_in
    if left + right >= 1 or bottom + top >= 1:
        return None
    params = dict(left=left, right=1 - right, bottom=bottom, top=1 - top,
                  wspace=SUBPLOT_WSPACE)
    if cols > 1:
        hspace = hspaces[1:-1].max() + pad_inch / fw_in
        h_axes = (1 - right - left - hspace * (cols - 1)) / cols
        if h_axes < 0:
            return None
        params["wspace"] = hspace / h_axes
    return params


# matplotlib's (height, descent) of "lp" at FIG_DPI by (size in points, bold):
# it measures with FreeType's autohinter, which PIL cannot select, and the
# two hintings differ by a pixel at these sizes -- a pixel of tight_layout's
# margins, three at 300 dpi.  (tests/test_torch_figures.py checks the table.)
_LP_AT_FIG_DPI = {(10.0, False): (14.0, 3.0), (12.0, False): (18.0, 4.0),
                  (10.0, True): (14.0, 3.0), (12.0, True): (18.0, 4.0)}


def text_metrics(text: str, size_pt: float, dpi: float,
                 bold: bool = False) -> Tuple[float, float, float]:
    """matplotlib's (width, height, descent) of one line of text in pixels
    at *dpi* (``Text._get_layout``): the ink box of the string, its height
    and descent at least those of "lp".  The width is measured at 8 times
    the size, as matplotlib hints at 8 times the horizontal resolution
    (``text.hinting_factor``)."""
    px = size_pt * dpi / 72.0
    font = _dejavu(px, exact=True, bold=bold)
    lp = _LP_AT_FIG_DPI.get((float(size_pt), bold)) if dpi == FIG_DPI else None
    if lp is None:
        lb = font.getbbox("lp", anchor="ls")
        lp = (lb[3] - lb[1], lb[3])
    h, d = lp
    if not text:
        return 0.0, h, d
    b = font.getbbox(text, anchor="ls")
    b8 = _dejavu(px * 8, exact=True, bold=bold).getbbox(text, anchor="ls")
    return (b8[2] - b8[0]) / 8.0, max(h, b[3] - b[1]), max(d, b[3])


_VA_OFFSET = {  # offsety of Text._get_layout over (h, d), the box's top at 0
    "top": lambda h, d: 0.0,
    "center": lambda h, d: -h / 2.0,
    "baseline": lambda h, d: d - h,
    "center_baseline": lambda h, d: -(h - d) / 2.0,
    "bottom": lambda h, d: -h,
}


def text_layout(x: float, y: float, text: str, size_pt: float, dpi: float,
                ha: str = "left", va: str = "baseline", bold: bool = False):
    """(layout box, pen) of an unrotated line of text anchored at (x, y):
    the box matplotlib's ``get_window_extent`` gives, and the left end of
    its baseline, where the glyphs start."""
    w, h, d = text_metrics(text, size_pt, dpi, bold)
    x0 = x - {"left": 0.0, "center": w / 2.0, "right": w}[ha]
    top = y - _VA_OFFSET[va](h, d)
    return (x0, top - h, x0 + w, top), (x0, top - (h - d))


def draw_text(dr: ImageDraw.ImageDraw, canvas_h: int, pen, text: str,
              size_pt: float, dpi: float, fill, bold: bool = False) -> None:
    """Glyphs of *text* from the display-pixel *pen* of :func:`text_layout`."""
    font = _dejavu(size_pt * dpi / 72.0, exact=True, bold=bold)
    dr.text((pen[0], canvas_h - pen[1]), text, font=font, fill=fill, anchor="ls")


def fill_box(dr: ImageDraw.ImageDraw, canvas_h: int, box: Box, fill) -> None:
    """Fill the pixels whose centers lie in a display-pixel box."""
    _fill_px(dr, box[0], canvas_h - box[3], box[2], canvas_h - box[1], fill)


@dataclass
class ImageAxes:
    """The port's stand-in for a matplotlib axes that shows an image: the
    canvas, the image's axes box in display pixels (the active box, after
    the aspect), the image's size and the dpi the canvas is drawn at."""

    canvas: Image.Image
    box: Box
    img_w: int
    img_h: int
    dpi: float

    def to_px(self, x, y):
        """Data coordinates -> display pixels."""
        return data_to_px(self.box, self.img_w, self.img_h)(x, y)


def data_to_px(box: Box, img_w: int, img_h: int):
    """imshow's data coordinates (pixel centers, row 0 at the top) -> the
    display pixels of the axes box *box*."""
    x0, y0, x1, y1 = box
    sx, sy = (x1 - x0) / img_w, (y1 - y0) / img_h

    def f(x, y):
        return x0 + (np.asarray(x, np.float64) + 0.5) * sx, \
            y1 - (np.asarray(y, np.float64) + 0.5) * sy

    return f


def _agg_iround(v: float) -> int:
    return int(v - 0.5) if v < 0 else int(v + 0.5)


def _agg_dda(y1: int, y2: int, count: int) -> np.ndarray:
    """``agg::dda2_line_interpolator``: *count* integer steps from *y1*
    towards *y2*, as Agg's linear span interpolator walks a scanline."""
    q = abs(y2 - y1) // count * (1 if y2 >= y1 else -1)   # C division
    lft, rem = q, (y2 - y1) - q * count
    mod = rem
    if mod <= 0:
        mod, rem, lft = mod + count, rem + count, lft - 1
    mod -= count
    out = np.empty(count, np.int64)
    y = y1
    for k in range(count):
        out[k] = y
        mod += rem
        y += lft
        if mod > 0:
            mod -= count
            y += 1
    return out


def _agg_out_shape(rgba: np.ndarray, box: Box):
    """(width, height, x scale, y scale) of ``_make_image``'s output for an
    image in the display box *box*: a fractional box is rounded up and the
    transform stretched to fill it."""
    ih, iw = rgba.shape[:2]
    bw, bh = box[2] - box[0], box[3] - box[1]
    if bw % 1.0 == 0.0 and bh % 1.0 == 0.0:
        return int(bw), int(bh), bw / iw, bh / ih
    ow, oh = math.ceil(bw), math.ceil(bh)
    return ow, oh, bw / iw * (1.0 + (ow - bw) / bw), bh / ih * (1.0 + (oh - bh) / bh)


def _nearest_like_agg(canvas: Image.Image, rgba: np.ndarray, box: Box):
    """matplotlib's nearest-neighbour imshow of *rgba* into the axes box
    *box*: the output is the box's size rounded up (``_make_image``),
    sampled at pixel centers through Agg's 1/256-pixel span interpolator,
    placed at the rounded box corner and clipped to the axes box as Agg
    clips (edges rounded, right and bottom inclusive)."""
    ih, iw = rgba.shape[:2]
    ch = canvas.size[1]
    ow, oh, sx, sy = _agg_out_shape(rgba, box)
    cols = _agg_dda(_agg_iround(0.5 / sx * 256), _agg_iround((0.5 + ow) / sx * 256),
                    ow) >> 8
    # output rows count up from the bottom; the image's row 0 is at the top
    rows = np.array([_agg_iround((ih - (r + 0.5) / sy) * 256)
                     for r in range(oh)], np.int64)[::-1] >> 8
    src = rgba[np.clip(rows, 0, ih - 1)][:, np.clip(cols, 0, iw - 1)]
    c0 = _agg_iround(box[0])
    r0 = ch - _agg_iround(box[1]) - oh
    x1, x2 = max(_agg_iround(box[0]), 0), min(_agg_iround(box[2]), canvas.size[0] - 1)
    y1, y2 = max(_agg_iround(ch - box[3]), 0), min(_agg_iround(ch - box[1]), ch - 1)
    cut = src[max(y1 - r0, 0):y2 + 1 - r0, max(x1 - c0, 0):x2 + 1 - c0]
    c0, r0 = max(c0, x1), max(r0, y1)
    piece = Image.fromarray(np.ascontiguousarray(cut), "RGBA")
    canvas.paste(piece, (c0, r0), piece)
    return c0, r0, cut.shape[1], cut.shape[0]


def paste_image(canvas: Image.Image, rgba: np.ndarray, box: Box) -> Tuple[int, int, int, int]:
    """An imshow into the axes box *box*, composited over the canvas by its
    alpha.  Where matplotlib's ``"auto"`` interpolation picks nearest (an
    enlargement above 3 times, or by 1 or 2 times exactly, on both axes),
    its pixels (:func:`_nearest_like_agg`); else its Hanning filter is
    replaced by the compositor's resampling rule onto the box rounded to
    whole pixels.  Returns the pixel box (column, row, width, height)."""
    ih, iw = rgba.shape[:2]
    ow, oh, _, _ = _agg_out_shape(rgba, box)
    if (ow > 3 * iw or ow in (iw, 2 * iw)) and (oh > 3 * ih or oh in (ih, 2 * ih)):
        return _nearest_like_agg(canvas, rgba, box)
    ch = canvas.size[1]
    c0, c1 = int(round(box[0])), int(round(box[2]))
    r0, r1 = int(round(ch - box[3])), int(round(ch - box[1]))
    dw, dh = max(1, c1 - c0), max(1, r1 - r0)
    src = Image.fromarray(np.ascontiguousarray(rgba), "RGBA")
    if (dw, dh) != (iw, ih):
        src = src.resize((dw, dh), _resample_for(iw, dw))
    canvas.paste(src, (c0, r0), src)
    return c0, r0, dw, dh


def _clip_to(overlay: Image.Image, box: Box) -> Image.Image:
    """*overlay* with every pixel outside the display box *box* cleared
    (an artist clipped to its axes)."""
    ch = overlay.size[1]
    keep = Image.new("L", overlay.size, 0)
    _fill_px(ImageDraw.Draw(keep), box[0], ch - box[3], box[2], ch - box[1], 255)
    a = overlay.getchannel("A")
    overlay.putalpha(Image.composite(a, keep, keep))
    return overlay


def stamp_lines(canvas: Image.Image, paths, lw_pt: float, dpi: float, rgba,
                clip: Box) -> None:
    """Polylines of display-pixel points ((N, 2) arrays), drawn as one
    artist in matplotlib's ``--`` pattern (on 3.7, off 1.6 times the line
    width, restarting at each path, butt dash ends) and clipped to the axes
    box *clip*; an alpha below 255 blends the whole artist once."""
    ch = canvas.size[1]
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    dr = ImageDraw.Draw(overlay)
    lw = lw_pt * dpi / 72.0
    width = max(1, int(round(lw)))
    on, off = (DASHES[0] * lw, DASHES[1] * lw)
    for pts in paths:
        P = np.asarray(pts, np.float64)
        if len(P) < 2:
            continue
        xy = [(float(x), float(ch - y)) for x, y in P]
        draw_on, left = True, on        # in a dash, and the length left of it
        for (xa, ya), (xb, yb) in zip(xy[:-1], xy[1:]):
            seg = float(np.hypot(xb - xa, yb - ya))
            pos = 0.0
            while seg - pos > 1e-9:
                step = min(left, seg - pos)
                if draw_on:
                    t0, t1 = pos / seg, (pos + step) / seg
                    dr.line([(xa + (xb - xa) * t0, ya + (yb - ya) * t0),
                             (xa + (xb - xa) * t1, ya + (yb - ya) * t1)],
                            fill=tuple(rgba), width=width)
                pos += step
                left -= step
                if left <= 1e-9:
                    draw_on = not draw_on
                    left = on if draw_on else off
    canvas.alpha_composite(_clip_to(overlay, clip))


def stamp_bar(canvas: Image.Image, p0, p1, lw_pt: float, dpi: float, rgba,
              clip: Box) -> None:
    """A horizontal solid line from display point *p0* to *p1* with
    matplotlib's default projecting caps (half the width past each end),
    clipped to the axes box *clip*."""
    ch = canvas.size[1]
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    hw = lw_pt * dpi / 72.0 / 2.0
    fill_box(ImageDraw.Draw(overlay), ch,
             (min(p0[0], p1[0]) - hw, p0[1] - hw, max(p0[0], p1[0]) + hw, p0[1] + hw),
             tuple(rgba))
    canvas.alpha_composite(_clip_to(overlay, clip))


LABEL_BOX_PAD_PT = 1.0           # the scalebar label's bbox pad


def stamp_label(canvas: Image.Image, x: float, y: float, text: str,
                size_pt: float, dpi: float, rgba, va: str,
                bold: bool = False, box_rgba=None) -> None:
    """``ax.text`` with ``ha="center"`` at display point (x, y): the glyphs,
    over a square ``bbox`` patch ``LABEL_BOX_PAD_PT`` around the layout box
    when *box_rgba* is given."""
    box, pen = text_layout(x, y, text, size_pt, dpi, "center", va, bold)
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    dr = ImageDraw.Draw(overlay)
    ch = canvas.size[1]
    if box_rgba is not None:
        p = LABEL_BOX_PAD_PT * dpi / 72.0
        fill_box(dr, ch, (box[0] - p, box[1] - p, box[2] + p, box[3] + p), box_rgba)
    draw_text(dr, ch, pen, text, size_pt, dpi, tuple(rgba), bold)
    canvas.alpha_composite(overlay)


def title_layout(ax: Box, text: str, dpi: float, for_layout: bool = False):
    """(box, pen) of an axes title: centered, its baseline ``axes.titlepad``
    above the axes; *for_layout* narrows the box to 1 pixel as
    ``tight_layout`` measures it."""
    box, pen = text_layout((ax[0] + ax[2]) / 2.0, ax[3] + TITLE_PAD_PT * dpi / 72.0,
                           text, TITLE_PT, dpi, "center", "baseline")
    if for_layout and box[2] > box[0]:
        x0 = (box[0] + box[2]) / 2.0 - 0.5
        box = (x0, box[1], x0 + 1.0, box[3])
    return box, pen


def colorbar_layout(cax: Box, vmin, vmax, dpi: float, tick_pt: float = FONT_PT,
                    label: str = "") -> dict:
    """The long axis of a vertical colorbar of ``Normalize(vmin, vmax)`` in
    the display box *cax*: the ticks and labels of ``report.ticks`` (the
    tick space of the box's height), each label's (box, pen) at
    ``center_baseline`` right of its tick, the offset text's ``right`` /
    ``baseline`` (box, pen) above the box, and the label's layout box (the
    text rotated 90 degrees, ``va="top"`` at ``labelpad`` right of the tick
    labels, centered on the box)."""
    from . import ticks

    px = dpi / 72.0
    length_pt = (cax[3] - cax[1]) / px
    locs, vis, view = ticks.colorbar_ticks(vmin, vmax, length_pt, tick_pt)
    fmt = ticks.ScalarFormatter()
    labels = dict(zip(locs.tolist(), fmt.format_ticks(locs, view)))
    tx = cax[2] + (TICK_LEN_PT + TICK_PAD_PT) * px
    out = {"ticks": [], "tick_pt": tick_pt}
    for v in vis.tolist():
        y = cax[1] + (v - view[0]) / (view[1] - view[0]) * (cax[3] - cax[1])
        box, pen = text_layout(tx, y, labels[v], tick_pt, dpi, "left", "center_baseline")
        out["ticks"].append((v, y, labels[v], box, pen))
    offset = fmt.get_offset()
    out["offset"] = (offset,) + text_layout(cax[2], cax[3] + OFFSET_PAD_PT * px,
                                            offset, FONT_PT, dpi, "right", "baseline")
    out["label"] = None
    if label:
        right = max([cax[2] + TICK_LEN_PT * px] + [t[3][2] for t in out["ticks"]])
        w, h, d = text_metrics(label, FONT_PT, dpi)
        x = right + LABELPAD_PT * px
        yc = (cax[1] + cax[3]) / 2.0
        out["label"] = (label, (x, yc - w / 2.0, x + h, yc + w / 2.0), x + (h - d))
    return out


def colorbar_tight_box(cax: Box, lay: dict) -> Box:
    """The colorbar axes' share of ``tight_layout``: its box, the tick
    labels, the offset text and the label narrowed to 1 pixel in height."""
    boxes = [cax] + [t[3] for t in lay["ticks"]]
    if lay["offset"][0]:
        boxes.append(lay["offset"][1])
    if lay["label"] is not None:
        b = lay["label"][1]
        y0 = (b[1] + b[3]) / 2.0 - 0.5
        boxes.append((b[0], y0, b[2], y0 + 1.0))
    return union(boxes)


def stamp_colorbar_axes(canvas: Image.Image, cax: Box, lay: dict, lut: np.ndarray,
                        dpi: float, rgba) -> None:
    """Draw a vertical colorbar laid out by :func:`colorbar_layout`: 256
    gradient bands of *lut* (vmin at the bottom), then in *rgba* the
    outline and the ticks (``axes.linewidth``, ticks ``ytick.major.size``
    long on the right), tick labels, offset text and the rotated label."""
    ch = canvas.size[1]
    px = dpi / 72.0
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    dr = ImageDraw.Draw(overlay)
    ink = tuple(rgba)
    lw = LINE_W_PT * px / 2.0
    _stamp_gradient(canvas, dr, cax[0], ch - cax[3], cax[2], ch - cax[1], lut, lw, ink)
    for _, y, label, _, pen in lay["ticks"]:
        fill_box(dr, ch, (cax[2], y - lw, cax[2] + TICK_LEN_PT * px, y + lw), ink)
        draw_text(dr, ch, pen, label, lay["tick_pt"], dpi, ink)
    offset, _, pen = lay["offset"]
    if offset:
        draw_text(dr, ch, pen, offset, FONT_PT, dpi, ink)
    if lay["label"] is not None:
        label, box, base_x = lay["label"]
        font = _dejavu(FONT_PT * px, exact=True)
        # the ink starts lsb past the pen, so its centre lies lsb above the
        # layout box's
        lsb = font.getbbox(label, anchor="ls")[0]
        _paste_rotated(overlay, label, font, base_x,
                       ch - ((box[1] + box[3]) / 2.0 + lsb), ink)
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
