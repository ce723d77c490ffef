"""The TIFF and PNG image outputs of the intensity, FRET, rim-FRET and
morphology runners, and the cropper's PNG writer.

Port of ``imageprocess_tpu/report/render.py`` without matplotlib: the same
folders, file names and pixels, through numpy and PIL alone.  Colormaps are
the committed LUT table of ``report.cmaps``; every PNG is composed by
``report.pilcomp``, the inset colorbar (``show_colorbar``) included, which
the JAX package lays out with matplotlib and ``pilcomp.stamp_colorbar``
draws to visual parity (the rect, 256 gradient bands, white outline,
endpoint ticks and labels).  PNGs are written as 8-bit RGB.

The figures that the JAX package lays out with matplotlib -- the rim-FRET
2-up panel (``save_panel_intensity_ratio``) and the FA crop PNGs
(``save_fa_crop_colormap``) -- are drawn with the layout primitives of
``report.pilcomp`` after matplotlib's geometry (``tight_layout``, the side
colorbar, ``inset_axes``, dashed lines) and the automatic ticks of
``report.ticks``.  Where a JAX function takes a matplotlib axes, the port
takes a ``pilcomp.ImageAxes``: the canvas and the image's box on it.

The frames arrive as host arrays: the runners copy them from the device
only when ``do_tif`` or ``do_png`` is on.  Percentiles are taken on the host
with ``np.percentile``, so a preview or a PNG is bit-equal to the JAX
package's for the same frame.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..core import tiffio
from ..geom.rasterize import rasterize_polygon_np
from . import cmaps

COLOR_CHOICES = ["Cyan", "Yellow", "Green", "Red", "Blue", "Magenta", "Grayscale"]
CMAP_CHOICES = ["jet", "turbo", "viridis", "plasma", "magma", "inferno", "cividis"]
SB_ANCHORS = ["br", "bl", "tr", "tl"]


def _auto_minmax_np(vals: np.ndarray, p_lo: float, p_hi: float):
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return 0.0, 1.0
    lo = float(np.percentile(vals, p_lo))
    hi = float(np.percentile(vals, p_hi))
    if hi <= lo:
        hi = lo + 1e-6
    return lo, hi


def polygon_union(polys: Sequence[np.ndarray], shape) -> np.ndarray:
    """OR of the host-rasterized polygon masks over an (H, W) frame.  Each
    polygon is rasterized on its own rows only: no edge crosses a scanline
    outside them, and moving the polygon up by a whole number of rows
    changes none of the rasterizer's float64 values (the differences it
    takes are the same), so the union equals the one of full-frame
    masks."""
    H, W = shape
    union = np.zeros((H, W), bool)
    for P in polys:
        P = np.asarray(P, np.float64)
        r0 = int(np.clip(np.floor(P[:, 1].min()), 0, H))
        r1 = int(np.clip(np.ceil(P[:, 1].max()) + 1, r0, H))
        if r1 > r0:
            union[r0:r1] |= rasterize_polygon_np(P - np.array([0.0, r0]),
                                                 (r1 - r0, W))
    return union


def crop_bbox(minx, maxx, miny, maxy, W: int, H: int):
    """The reference crop window: bbox + max(10, 5% of the long side) pad,
    clamped inclusive to the frame (Fluor_INT.py:1019-1035)."""
    pad = max(10, int(0.05 * max(W, H)))
    x0 = max(int(minx) - pad, 0)
    x1 = min(int(maxx) + pad, W - 1)
    y0 = max(int(miny) - pad, 0)
    y1 = min(int(maxy) + pad, H - 1)
    return x0, x1, y0, y1


def crop_bbox_poly(pts: np.ndarray, W: int, H: int):
    """:func:`crop_bbox` of a polygon's vertices."""
    pts = np.asarray(pts)
    return crop_bbox(pts[:, 0].min(), pts[:, 0].max(),
                     pts[:, 1].min(), pts[:, 1].max(), W, H)


def get_cmap_for_color(color_name: Optional[str]):
    """Black -> single-colour ramp (a (256, 4) uint8 LUT) of a channel
    colour name; "gray" for Grayscale, None and unknown names."""
    if color_name is None or color_name.lower() not in cmaps.SINGLE_RGB:
        return "gray"
    return cmaps.single_color_lut(color_name.lower())


@dataclass(frozen=True)
class ScalebarSpec:
    x0: float
    x1: float
    y: float
    label_y: float
    label_va: str
    label: str


def scalebar_spec(img_w: int, img_h: int, scalebar_um: float, px_um: float,
                  anchor: str = "br") -> ScalebarSpec:
    """Placement of a scalebar in image coordinates (5% margins, label
    offset max(10 px, 2% of the height), bar clamped to [2 px, 80% of the
    width]).  The printed label is the CLAMPED physical length."""
    if anchor not in SB_ANCHORS:
        anchor = "br"
    bar_px = int(round(float(scalebar_um) / float(px_um)))
    bar_px = max(2, min(bar_px, int(0.8 * img_w)))
    mx, my = int(img_w * 0.05), int(img_h * 0.05)
    at_bottom = anchor in ("br", "bl")
    x0 = (img_w - mx - bar_px) if anchor in ("br", "tr") else mx
    y = (img_h - my) if at_bottom else my
    dy = max(10, int(0.02 * img_h))
    return ScalebarSpec(
        x0=x0, x1=x0 + bar_px, y=y,
        label_y=y - dy if at_bottom else y + dy,
        label_va="bottom" if at_bottom else "top",
        label=f"{bar_px * float(px_um):.0f} µm",
    )


_WHITE = (255, 255, 255, 255)
_BLACK = (0, 0, 0, 255)


def draw_scalebar(ax, img_w, img_h, bar_px, bar_um, lw=3, anchor="br",
                  font_size=10):
    """A white scalebar with a boxed label on *ax*, a ``pilcomp.ImageAxes``
    (the JAX function's matplotlib axes: the canvas and the image's box);
    geometry from :func:`scalebar_spec`."""
    spec = scalebar_spec(img_w, img_h, bar_um, bar_um / max(bar_px, 1), anchor)
    _paint_scalebar(ax, spec, lw=lw, font_size=font_size)


def _paint_scalebar(ax, spec: ScalebarSpec, lw=3, font_size=10):
    """The bar (*lw* points, projecting caps, clipped to the axes) and the
    label over a 40%-alpha black box 1 point around its layout box, on a
    ``pilcomp.ImageAxes``."""
    from . import pilcomp

    y = ax.to_px(0.0, spec.y)[1]
    pilcomp.stamp_bar(ax.canvas, (ax.to_px(spec.x0, 0.0)[0], y),
                      (ax.to_px(spec.x1, 0.0)[0], y), lw, ax.dpi, _WHITE, clip=ax.box)
    x, ly = ax.to_px((spec.x0 + spec.x1) / 2, spec.label_y)
    pilcomp.stamp_label(ax.canvas, float(x), float(ly), spec.label, font_size, ax.dpi,
                        _WHITE, spec.label_va, box_rgba=(0, 0, 0, 102))


def add_short_colorbar(fig, ax, vmin, vmax, cmap="jet", label="Intensity (a.u.)"):
    """White-on-black inset colorbar with endpoint-only ticks.  *fig* is the
    canvas and *ax* the ``pilcomp.ImageAxes`` of the borderless image (the
    JAX function's figure and axes): ``pilcomp.stamp_colorbar`` draws it."""
    from . import pilcomp

    pilcomp.stamp_colorbar(fig, ax.img_w, ax.img_h, cmaps.lut_u8(cmap), vmin, vmax,
                           label, dpi=ax.dpi)


def colormap_rgba_u8(img2d, cmap="jet", vmin=None, vmax=None, mask=None):
    """Scalar colormapping in numpy: normalize -> LUT index -> (H, W, 4)
    uint8.  *cmap* is a name of the LUT table or a (256, 4) uint8 LUT.
    Non-finite pixels and mask=False pixels get alpha 0 (the savers' black
    background shows through); missing bounds come from the visible
    pixels."""
    v = np.asarray(img2d, np.float32)
    fin = np.isfinite(v)
    if mask is not None:
        fin &= np.asarray(mask, bool)
    allfin = bool(fin.all())
    if not allfin:
        v = np.where(fin, v, 0.0)
    if vmin is None or vmax is None:
        vis = v[fin] if not allfin else v
        lo = float(vis.min()) if vis.size else 0.0
        hi = float(vis.max()) if vis.size else 1.0
        vmin = lo if vmin is None else float(vmin)
        vmax = hi if vmax is None else float(vmax)
    scale = 256.0 / (vmax - vmin) if vmax > vmin else 0.0
    # clip in float before the cast: a tiny display window with hot pixels
    # can push (v-vmin)*scale past 2^31, and float->int32 overflow would
    # land on INT32_MIN (the brightest pixels at index 0)
    idx = np.clip((v - np.float32(vmin)) * np.float32(scale),
                  0.0, 255.0).astype(np.int32)
    out = cmaps.lut_u8(cmap)[idx]
    if not allfin:
        out[~fin] = 0
    return out


def save_png_colormap(
    img2d,
    out_path,
    vmin=None,
    vmax=None,
    cmap="jet",
    mask=None,
    scalebar_um=None,
    px_um=None,
    show_colorbar=False,
    dpi=300,
    out_px=None,
    cbar_label="Intensity (a.u.)",
    bar_anchor="br",
    bar_font=10,
):
    """Black-background borderless PNG with optional mask transparency,
    scalebar and inset colorbar (Fluor_INT.py:642-675).  The colorbar is
    drawn only with both bounds given, as in the JAX saver."""
    from . import pilcomp

    shown = np.asarray(img2d)
    rgba = colormap_rgba_u8(shown, cmap, vmin, vmax, mask=mask)
    Hs, Ws = shown.shape[:2]
    canvas, box = pilcomp.compose_borderless(rgba, out_px, dpi)
    if scalebar_um is not None and px_um is not None and scalebar_um > 0:
        pilcomp.stamp_scalebar(canvas, box, Ws, Hs,
                               scalebar_spec(Ws, Hs, scalebar_um, px_um, bar_anchor),
                               font_pt=bar_font, dpi=dpi)
    if show_colorbar and vmin is not None and vmax is not None:
        add_short_colorbar(canvas, pilcomp.ImageAxes(canvas, box, Ws, Hs, dpi),
                           vmin, vmax, cmap=cmap, label=cbar_label)
    pilcomp.save_canvas_png(canvas, out_path)


@dataclass
class PanelPngOptions:
    """One PNG output panel (the reference's full_* / crop_* GUI group)."""

    enabled: bool = True
    cmap_on: bool = False
    cmap: str = "jet"
    cmin: str = ""      # "" = auto from percentiles
    cmax: str = ""
    mask_outside: bool = False
    colorbar: bool = False
    scalebar_um: Optional[float] = None
    sb_anchor: str = "br"
    sb_font: int = 10
    dpi: int = 300

    def vminmax(self, vals: np.ndarray, auto_lo: float, auto_hi: float):
        """get_vminmax semantics (Fluor_INT.py:956-966): explicit bounds win;
        missing or inverted bounds fall back to the percentile auto-range;
        without colormap mode (None, None).  Malformed text raises."""
        if not self.cmap_on:
            return None, None
        vmin = float(self.cmin) if self.cmin != "" else None
        vmax = float(self.cmax) if self.cmax != "" else None
        if vmin is None or vmax is None or vmax <= vmin:
            lo, hi = _auto_minmax_np(vals, auto_lo, auto_hi)
            vmin = lo if vmin is None else vmin
            if vmax is None or vmax <= vmin:
                vmax = hi
        return vmin, vmax


def resolve_vminmax_txt(cmin_txt: str, cmax_txt: str, vals,
                        p_lo: float = 1.0, p_hi: float = 99.0):
    """Tolerant cmin/cmax of the FRET and rim-FRET crops: malformed or
    missing text falls back to the percentile auto-range of *vals*, and an
    explicit-but-inverted pair keeps vmin and re-derives vmax
    (fret_ratio_builder.py:371-426).  *vals* may be a zero-argument
    callable, evaluated only when the auto-range is needed."""
    try:
        vmin = float(cmin_txt) if cmin_txt != "" else None
    except ValueError:
        vmin = None
    try:
        vmax = float(cmax_txt) if cmax_txt != "" else None
    except ValueError:
        vmax = None
    if vmin is None or vmax is None or vmax <= vmin:
        lo, hi = _auto_minmax_np(vals() if callable(vals) else vals, p_lo, p_hi)
        if vmin is None:
            vmin = lo
        if vmax is None or vmax <= vmin:
            vmax = hi
    return vmin, vmax


def save_png_image(img, out_path, dpi=300, out_px=None, scalebar_um=None,
                   px_um=None):
    """The cropper's normalized-view PNG: gray [0, 1] for 2-D input, RGB
    for 3-D (src/roi_channel_cropper.py:321-345)."""
    from . import pilcomp

    if img.ndim == 2:
        rgba = colormap_rgba_u8(img, "gray", 0.0, 1.0)
    else:
        rgb = (np.clip(np.asarray(img, np.float32), 0, 1)
               * 255.0 + 0.5).astype(np.uint8)
        rgba = np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])
    H, W = img.shape[:2]
    spec = None
    if scalebar_um is not None and px_um is not None:
        bar_px = int(round(float(scalebar_um) / float(px_um)))
        bar_px = max(2, min(bar_px, int(0.8 * W)))
        spec = scalebar_spec(W, H, bar_px * float(px_um), float(px_um))
    pilcomp.save_borderless_png(rgba, out_path, dpi=dpi, out_px=out_px,
                                scalebar_spec=spec)


def save_png_gray(img2d, out_path, vmin=None, vmax=None, dpi=300, out_px=None):
    """Gray black-background PNG (fret_ratio_builder.py:371-380)."""
    from . import pilcomp

    pilcomp.save_borderless_png(colormap_rgba_u8(img2d, "gray", vmin, vmax),
                                out_path, dpi=dpi, out_px=out_px)


def _local_mask(P, x0, y0, shape) -> np.ndarray:
    """Mask of polygon *P* in a crop whose origin is (x0, y0)."""
    P2 = np.array(P, copy=True)
    P2[:, 0] -= x0
    P2[:, 1] -= y0
    return rasterize_polygon_np(P2, shape)


def save_intensity_images(extras: dict, cfg, out_root: str) -> None:
    """TIF32 + TIF16-preview + PNG full/crop exports of one (stage, time)
    key (worker block Fluor_INT.py:917-1135): ``TIFF/``, ``TIFF16/`` and
    ``PNG/{full,crop}/ch{ch}/``; the raw-value crop TIFFs
    (``save_raw_crop_tif``) come with the PNG crops.  ``extras["imgs_bc"]``
    is the (C, H, W) float32 corrected stack on the host,
    ``extras["imgs_raw"]`` the raw frames."""
    stid = extras["stid"]
    chs: Sequence[int] = extras["chs"]
    imgs_bc = extras["imgs_bc"]
    polys = extras["polys"]
    union_mask = extras["union_mask"]
    H, W = extras["shape"]

    full_opt: PanelPngOptions = cfg.png_full
    crop_opt: PanelPngOptions = cfg.png_crop
    union = None
    if polys is not None:   # the host union is rasterized only when read
        if (cfg.do_tif and cfg.tif_mask_outside) or (
                cfg.do_png and full_opt.enabled and full_opt.mask_outside):
            union = polygon_union(polys, (H, W))
    elif union_mask is not None:
        union = np.asarray(union_mask, bool)

    tif32_dir = os.path.join(out_root, "TIFF")
    tif16_dir = os.path.join(out_root, "TIFF16")
    png_root = os.path.join(out_root, "PNG")

    if cfg.do_tif:
        os.makedirs(tif32_dir, exist_ok=True)
        os.makedirs(tif16_dir, exist_ok=True)
        for ci, ch in enumerate(chs):
            img_to_save = imgs_bc[ci]
            if cfg.tif_mask_outside and union is not None:
                img_to_save = np.where(union, img_to_save, 0.0).astype(np.float32)
            tiffio.write_tiff32(
                os.path.join(tif32_dir, f"{stid}_ch{ch}_bgcorr.tif"), img_to_save)
            vals = img_to_save[np.isfinite(img_to_save)]
            if vals.size > 0:
                lo, hi = _auto_minmax_np(vals, cfg.auto_lo, cfg.auto_hi)
                tiffio.write_tiff16(
                    os.path.join(tif16_dir, f"{stid}_ch{ch}_bgcorr_preview.tif"),
                    tiffio.normalize_to_u16(img_to_save, lo, hi))

    if not cfg.do_png:
        return
    for ci, ch in enumerate(chs):
        bc = imgs_bc[ci]
        color = cfg.channel_colors.get(ch, "Grayscale")

        if full_opt.enabled:
            cmap_full = full_opt.cmap if full_opt.cmap_on else get_cmap_for_color(color)
            vmin, vmax = full_opt.vminmax(bc[np.isfinite(bc)], cfg.auto_lo, cfg.auto_hi)
            save_png_colormap(
                bc, os.path.join(png_root, "full", f"ch{ch}", f"{stid}_ch{ch}.png"),
                vmin=vmin, vmax=vmax, cmap=cmap_full,
                mask=union if full_opt.mask_outside else None,
                scalebar_um=full_opt.scalebar_um, px_um=cfg.px_um,
                show_colorbar=bool(full_opt.colorbar and full_opt.cmap_on),
                dpi=full_opt.dpi, cbar_label=f"ch{ch} Intensity",
                bar_anchor=full_opt.sb_anchor, bar_font=full_opt.sb_font)

        if not (crop_opt.enabled and (polys is not None or union is not None)):
            continue
        cmap_crop = crop_opt.cmap if crop_opt.cmap_on else get_cmap_for_color(color)
        crop_dir = os.path.join(png_root, "crop", f"ch{ch}")
        items = []
        if polys is not None:
            roi_list = list(range(1, len(polys) + 1))
            if cfg.subset_roi is not None:
                roi_list = ([int(cfg.subset_roi)]
                            if 1 <= int(cfg.subset_roi) <= len(polys) else [])
            items = [(i, np.asarray(polys[i - 1]), None) for i in roi_list]
        else:
            ys, xs = np.where(union)
            if ys.size:
                items.append((1, None, (ys, xs)))
        out_px = (cfg.crop_size, cfg.crop_size) if cfg.fixed_crop else None
        for i, P, coords in items:
            if P is not None:
                x0, x1, y0, y1 = crop_bbox_poly(P, W, H)
                local_mask = _local_mask(P, x0, y0, (y1 - y0 + 1, x1 - x0 + 1))
            else:
                ys, xs = coords
                x0, x1, y0, y1 = crop_bbox(xs.min(), xs.max(), ys.min(), ys.max(),
                                           W, H)
                local_mask = union[y0:y1 + 1, x0:x1 + 1]
            crop = bc[y0:y1 + 1, x0:x1 + 1]
            use_vals = (crop[local_mask] if crop_opt.mask_outside
                        else crop[np.isfinite(crop)])
            vmin, vmax = crop_opt.vminmax(use_vals, cfg.auto_lo, cfg.auto_hi)
            save_png_colormap(
                crop, os.path.join(crop_dir, f"{stid}_roi{i}_ch{ch}.png"),
                vmin=vmin, vmax=vmax, cmap=cmap_crop,
                mask=local_mask if crop_opt.mask_outside else None,
                scalebar_um=crop_opt.scalebar_um, px_um=cfg.px_um,
                show_colorbar=bool(crop_opt.colorbar and crop_opt.cmap_on),
                dpi=crop_opt.dpi, out_px=out_px, cbar_label=f"ch{ch} Intensity",
                bar_anchor=crop_opt.sb_anchor, bar_font=crop_opt.sb_font)
            # raw-value crop TIFF (worker block Fluor_INT.py:1078-1089)
            if cfg.save_raw_crop_tif and extras.get("imgs_raw") is not None \
                    and P is not None:
                raw = np.asarray(extras["imgs_raw"][ci])
                os.makedirs(tif32_dir, exist_ok=True)
                tiffio.write_tiff32(
                    os.path.join(tif32_dir, f"{stid}_roi{i}_ch{ch}_raw.tif"),
                    raw[y0:y1 + 1, x0:x1 + 1].astype(np.float32))


def save_fret_images(stid, suffix, R_full, union, polys, cfg, dirs) -> None:
    """RAT 32/16-bit TIFFs, RAT_ROI_masked variants, PNG full/crop of one
    FRET pair (fret_ratio_builder.py:478-549)."""
    H, W = R_full.shape

    def tif_pair(img, d32, d16):
        os.makedirs(dirs[d32], exist_ok=True)
        os.makedirs(dirs[d16], exist_ok=True)
        tiffio.write_tiff32(
            os.path.join(dirs[d32], f"{stid}_ratio_{suffix}.tif"), img)
        vals = img[np.isfinite(img)]
        out16 = os.path.join(dirs[d16], f"{stid}_ratio_{suffix}_preview.tif")
        if vals.size > 0:
            lo, hi = _auto_minmax_np(vals, 1.0, 99.0)
            tiffio.write_tiff16(out16, tiffio.normalize_to_u16(img, lo, hi))
        else:
            tiffio.write_tiff16(out16, np.zeros_like(img, dtype=np.uint16))

    if cfg.do_tif:
        tif_pair(R_full, "RAT32", "RAT16")

    if cfg.do_png and cfg.save_full:
        lo, hi = _auto_minmax_np(R_full[np.isfinite(R_full)], 1.0, 99.0)
        save_png_gray(
            R_full, os.path.join(dirs["PNG_FULL"], f"{stid}_ratio_{suffix}.png"),
            vmin=lo, vmax=hi, dpi=cfg.png_dpi)

    if polys is None:
        return

    if cfg.do_tif and union is not None:
        R_roi = R_full.copy()
        R_roi[~union] = np.nan
        tif_pair(R_roi, "RROI32", "RROI16")

    if not (cfg.do_png and cfg.save_crop):
        return
    out_px = (cfg.crop_w, cfg.crop_h) if cfg.fixed_crop else None
    for i, P in enumerate(polys, 1):
        pts = np.asarray(P)
        x0, x1, y0, y1 = crop_bbox_poly(pts, W, H)
        crop = R_full[y0:y1 + 1, x0:x1 + 1]
        mask = _local_mask(pts, x0, y0, crop.shape)
        out_path = os.path.join(dirs["PNG_CROP"], f"{stid}_roi{i}_{suffix}.png")
        if cfg.apply_cmap:
            vmin, vmax = resolve_vminmax_txt(cfg.cmin_txt, cfg.cmax_txt,
                                             lambda: crop[mask])
            save_png_colormap(
                crop, out_path, vmin=vmin, vmax=vmax, cmap=cfg.cmap_name,
                mask=mask if cfg.mask_outside else None,
                scalebar_um=cfg.scale_bar_um if cfg.add_scalebar else None,
                px_um=cfg.px_um, show_colorbar=cfg.show_colorbar,
                dpi=cfg.png_dpi, out_px=out_px, cbar_label="FRET ratio")
        else:
            crop_vis = np.array(crop, copy=True)
            if cfg.mask_outside:
                crop_vis[~mask] = 0.0
            lo, hi = _auto_minmax_np(crop_vis[np.isfinite(crop_vis)], 1.0, 99.0)
            save_png_gray(crop_vis, out_path, vmin=lo, vmax=hi,
                          dpi=cfg.png_dpi, out_px=out_px)


_PANEL_FIGSIZE = (6.0, 3.0)
_PANEL_DPI = 300
_CB_FRACTION, _CB_PAD, _CB_ASPECT = 0.046, 0.04, 20.0
_PANEL_CB_LABEL = "FRET ratio"


def _panel_axes(sp, W, H, show_colorbar):
    """The panel's grid cells and active boxes (figure fractions) at the
    subplot parameters *sp*: two aspect-equal image axes in a 1x2 grid; with
    the colorbar, ``make_axes_gridspec`` splits the right cell into the
    image (anchored right) and a box-aspect-20 colorbar ``pad`` to its right
    (anchored left)."""
    from . import pilcomp

    fig_aspect = _PANEL_FIGSIZE[1] / _PANEL_FIGSIZE[0]
    cells = pilcomp.grid_columns((sp["left"], sp["bottom"], sp["right"], sp["top"]),
                                 2, sp["wspace"])
    ax0 = pilcomp.aspect_box(cells[0], H / W, fig_aspect)
    if not show_colorbar:
        return cells, ax0, pilcomp.aspect_box(cells[1], H / W, fig_aspect), None
    main, cb = pilcomp.grid_columns(
        cells[1], 2, 2 * _CB_PAD / (1 - _CB_PAD),
        [1 - _CB_FRACTION - _CB_PAD, _CB_FRACTION])
    return (cells, ax0, pilcomp.aspect_box(main, H / W, fig_aspect, (1.0, 0.5)),
            pilcomp.aspect_box(cb, _CB_ASPECT, fig_aspect, (0.0, 0.5)))


def panel_layout(W, H, show_colorbar=True, vmin=0.0, vmax=0.7, spec=None,
                 titles=("Intensity", "FRET")) -> dict:
    """The panel's geometry at its 300 dpi in display pixels: ``tight_layout``
    (pad 1.08) measured at ``pilcomp.FIG_DPI`` around the two image axes,
    their titles and scalebar labels (*spec*, or None) and the colorbar's
    ticks and label; then the two image boxes (``"axes"``), the colorbar's
    box (``"cax"``, None without it) and its ``pilcomp.colorbar_layout``
    (``"colorbar"``)."""
    from . import pilcomp

    def boxes_at(sp, at_dpi):
        cells, ax0, ax1, cax = _panel_axes(sp, W, H, show_colorbar)
        axes = [pilcomp.to_px(ax, _PANEL_FIGSIZE, at_dpi) for ax in (ax0, ax1)]
        cpx = None if cax is None else pilcomp.to_px(cax, _PANEL_FIGSIZE, at_dpi)
        lay = None if cpx is None else pilcomp.colorbar_layout(
            cpx, vmin, vmax, at_dpi, label=_PANEL_CB_LABEL)
        return cells, axes, cpx, lay

    sp = dict(zip(("left", "bottom", "right", "top"), pilcomp.SUBPLOT_BOX),
              wspace=pilcomp.SUBPLOT_WSPACE)
    cells, axes, cpx, lay = boxes_at(sp, pilcomp.FIG_DPI)
    tight = []
    for px, title in zip(axes, titles):
        parts = [px, pilcomp.title_layout(px, title, pilcomp.FIG_DPI, True)[0]]
        if spec is not None:
            x, y = pilcomp.data_to_px(px, W, H)((spec.x0 + spec.x1) / 2, spec.label_y)
            parts.append(pilcomp.text_layout(float(x), float(y), spec.label, 10,
                                             pilcomp.FIG_DPI, "center",
                                             spec.label_va)[0])
        tight.append(parts)
    if cpx is not None:
        tight[1].append(pilcomp.colorbar_tight_box(cpx, lay))
    sp = pilcomp.tight_params(_PANEL_FIGSIZE, cells, [pilcomp.union(b) for b in tight],
                              pad=1.08) or sp
    _, axes, cpx, lay = boxes_at(sp, _PANEL_DPI)
    return {"axes": axes, "cax": cpx, "colorbar": lay}


def save_panel_intensity_ratio(int_img, ratio_img, rim, out_png, px_um,
                               add_scalebar=False, sb_um=5.0, cmap="turbo",
                               vmin=0.0, vmax=0.7, show_colorbar=True,
                               title_left="Intensity", title_right="FRET"):
    """2-up rim-masked intensity / ratio panel
    (Nesprin2_FRET_Builder.py:498-530): ``figsize=(6, 3)`` at 300 dpi on
    white, two titled image axes with an optional scalebar each, the side
    colorbar "FRET ratio" (``fraction=0.046, pad=0.04``) and
    ``tight_layout`` (:func:`panel_layout`), as matplotlib lays out the JAX
    figure."""
    from PIL import Image, ImageDraw

    from . import pilcomp

    I = np.where(rim, int_img, np.nan)
    R = np.where(rim, ratio_img, np.nan)
    ilo, ihi = _p1_p99(I[np.isfinite(I)])
    H, W = R.shape
    spec = None
    if add_scalebar and px_um > 0:
        bar_px = max(2, min(int(round(sb_um / px_um)), int(0.8 * W)))
        bar_um = bar_px * px_um
        spec = scalebar_spec(W, H, bar_um, bar_um / max(bar_px, 1), "br")
    titles = (title_left, title_right)
    lay = panel_layout(W, H, show_colorbar, vmin, vmax, spec, titles)

    canvas = Image.new("RGBA", pilcomp.figure_px(_PANEL_FIGSIZE, _PANEL_DPI),
                       (255, 255, 255, 255))
    for box, img, cm, lo, hi, title in zip(lay["axes"], (I, R), ("gray", cmap),
                                           (ilo, vmin), (ihi, vmax), titles):
        pilcomp.paste_image(canvas, colormap_rgba_u8(img, cm, lo, hi), box)
        if spec is not None:
            _paint_scalebar(pilcomp.ImageAxes(canvas, box, W, H, _PANEL_DPI), spec)
        overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
        pilcomp.draw_text(ImageDraw.Draw(overlay), canvas.size[1],
                          pilcomp.title_layout(box, title, _PANEL_DPI)[1], title,
                          pilcomp.TITLE_PT, _PANEL_DPI, _BLACK)
        canvas.alpha_composite(overlay)
    if lay["cax"] is not None:
        pilcomp.stamp_colorbar_axes(canvas, lay["cax"], lay["colorbar"],
                                    cmaps.lut_u8(cmap), _PANEL_DPI, _BLACK)
    pilcomp.save_canvas_png(canvas, out_png)


def _p1_p99(vals: np.ndarray):
    return ((np.percentile(vals, 1), np.percentile(vals, 99))
            if vals.size else (0.0, 1.0))


def save_nesprin2_images(tag, suffix, R_full, rim, I, polys, cfg, dirs, eps,
                         ann_bgs=None, numer=None, denom=None) -> None:
    """Rim-FRET TIF32 full + rim, full and crop PNGs of one pair
    (Nesprin2_FRET_Builder.py:1585-1731).  With the annulus (*ann_bgs* set)
    each crop's ratio is rebuilt from *numer* / *denom* minus the ROI's
    annulus backgrounds."""
    H, W = R_full.shape

    if cfg.do_tif:
        for d in ("tif32_full", "tif32_rim"):
            os.makedirs(dirs[d], exist_ok=True)
        tiffio.write_tiff32(
            os.path.join(dirs["tif32_full"], f"{tag}_ratio_full_{suffix}.tif"),
            R_full)
        tiffio.write_tiff32(
            os.path.join(dirs["tif32_rim"], f"{tag}_ratio_rim_{suffix}.tif"),
            np.where(rim, R_full, np.nan))

    if not cfg.do_png:
        return

    if cfg.save_full:
        lo, hi = _auto_minmax_np(R_full[np.isfinite(R_full)], 1.0, 99.0)
        save_png_gray(
            R_full,
            os.path.join(dirs["png_full_ratio"], f"{tag}_ratio_full_{suffix}.png"),
            vmin=lo, vmax=hi, dpi=300)
        ilo, ihi = _p1_p99(I[np.isfinite(I)])
        save_png_gray(
            I, os.path.join(dirs["png_full_int"], f"{tag}_INT_full.png"),
            vmin=ilo, vmax=ihi, dpi=300)

    if cfg.save_panel:
        save_panel_intensity_ratio(
            I, R_full, rim,
            os.path.join(dirs["png_panel"], f"{tag}_panel_{suffix}.png"),
            px_um=cfg.px_um, add_scalebar=cfg.add_scalebar,
            sb_um=cfg.scale_bar_um, cmap=cfg.cmap_name,
            vmin=cfg.fret_min, vmax=cfg.fret_max,
            show_colorbar=cfg.show_colorbar)

    if not cfg.save_crop:
        return
    out_px = (cfg.crop_w, cfg.crop_h) if cfg.crop_fixed else None
    for i, P in enumerate(polys, 1):
        pts = np.asarray(P)
        x0, x1, y0, y1 = crop_bbox_poly(pts, W, H)

        if ann_bgs is not None:
            # rebuild the annulus-corrected per-ROI ratio on the crop only
            bg_n, bg_d = float(ann_bgs[0][i - 1]), float(ann_bgs[1][i - 1])
            nc = numer[y0:y1 + 1, x0:x1 + 1] - bg_n
            dc = denom[y0:y1 + 1, x0:x1 + 1] - bg_d
            if cfg.clip_neg:
                nc = np.maximum(nc, 0.0)
                dc = np.maximum(dc, 0.0)
            cropR = (nc + eps) / (dc + eps)
            if cfg.clip_ratio_on:
                cropR = np.where(cropR > cfg.clip_ratio_max, np.nan, cropR)
        else:
            cropR = R_full[y0:y1 + 1, x0:x1 + 1]
        cropI = I[y0:y1 + 1, x0:x1 + 1]
        crop_rim = _local_mask(pts, x0, y0, cropR.shape) & rim[y0:y1 + 1, x0:x1 + 1]

        vmin, vmax = resolve_vminmax_txt(
            cfg.crop_vmin_txt, cfg.crop_vmax_txt,
            lambda: cropR[crop_rim] if crop_rim.any() else cropR)
        save_png_colormap(
            cropR,
            os.path.join(dirs["png_crop_ratio"], f"{tag}_roi{i}_{suffix}_rim.png"),
            vmin=vmin, vmax=vmax, cmap=cfg.cmap_name, mask=crop_rim,
            scalebar_um=cfg.scale_bar_um if cfg.add_scalebar else None,
            px_um=cfg.px_um, show_colorbar=cfg.show_colorbar,
            dpi=300, out_px=out_px, cbar_label="FRET ratio")

        ilo, ihi = _p1_p99(cropI[np.isfinite(cropI)])
        save_png_gray(
            cropI,
            os.path.join(dirs["png_crop_int_no"], f"{tag}_roi{i}_INT_crop_full.png"),
            vmin=ilo, vmax=ihi, dpi=300, out_px=out_px)
        if cfg.save_crop_intensity:
            I_vis = np.array(cropI, copy=True)
            I_vis[~crop_rim] = np.nan
            ilo2, ihi2 = _p1_p99(I_vis[np.isfinite(I_vis)])
            save_png_gray(
                I_vis,
                os.path.join(dirs["png_crop_int_r"], f"{tag}_roi{i}_INT_rim.png"),
                vmin=ilo2, vmax=ihi2, dpi=300, out_px=out_px)


def _fa_crop_lut(cmap_name: str) -> np.ndarray:
    """The FA crop's colormap: a black -> CSS-colour ramp for a colour
    name, gray for "grayscale", else the named colormap, jet for a name
    matplotlib does not know."""
    low = cmap_name.lower()
    if low in cmaps.CSS_RGB:
        return cmaps.css_ramp_lut(low)
    if low == "grayscale":
        return cmaps.lut_u8("gray")
    try:
        return cmaps.lut_u8(cmap_name)
    except ValueError:
        return cmaps.lut_u8("jet")


def fa_crop_layout(w, h, out_w=500, out_h=500, out_dpi=600):
    """(image box, colorbar box) of an FA crop in display pixels: the
    *w* x *h* crop aspect-equal in the full canvas, and ``inset_axes``'s
    3% x 40% box at its center right, ``borderpad`` 1 ``legend.fontsize``
    (10 points) inside it."""
    from . import pilcomp

    figsize = (out_w / out_dpi, out_h / out_dpi)
    box = pilcomp.to_px(pilcomp.aspect_box((0.0, 0.0, 1.0, 1.0), h / w,
                                           figsize[1] / figsize[0]),
                        figsize, out_dpi)
    pad = pilcomp.FONT_PT * out_dpi / 72.0
    cw, ch = 0.03 * (box[2] - box[0]), 0.4 * (box[3] - box[1])
    x1, yc = box[2] - pad, (box[1] + box[3]) / 2.0
    return box, (x1 - cw, yc - ch / 2.0, x1, yc + ch / 2.0)


def save_fa_crop_colormap(img_crop, mask, roi_poly_crop, out_path,
                          cmap_name="jet", show_cbar=True,
                          vmin=None, vmax=None, sb_on=False, sb_len_um=20,
                          sb_text=True, sb_font=10, px_size=0.112,
                          out_w=500, out_h=500, out_dpi=600,
                          roi_lw=0.5, roi_color="gray"):
    """FA crop export (FA_Analyzer.py:213-264): a black canvas of
    ``out_w x out_h`` at ``out_dpi``, the FA-mask-only colormap view fitted
    aspect-equal into it, the dashed ROI outline (0.8 alpha), the bold
    scalebar, and the ``inset_axes`` colorbar (3% x 40% of the image box,
    ``loc="center right"``, ``borderpad=1``) with automatic ticks at
    labelsize 8 -- the JAX figure's geometry, drawn with PIL."""
    from PIL import Image, ImageColor

    from . import pilcomp

    figsize = (out_w / out_dpi, out_h / out_dpi)
    canvas = Image.new("RGBA", pilcomp.figure_px(figsize, out_dpi), _BLACK)
    if vmin is None or vmax is None:
        valid = img_crop[mask]
        alo, ahi = ((np.percentile(valid, 1), np.percentile(valid, 99))
                    if valid.size else (0, 1))
        vmin = alo if vmin is None else vmin
        vmax = ahi if vmax is None else vmax
    lut = _fa_crop_lut(cmap_name)
    h, w = img_crop.shape
    box, cax = fa_crop_layout(w, h, out_w, out_h, out_dpi)
    pilcomp.paste_image(canvas, colormap_rgba_u8(img_crop, lut, vmin, vmax, mask=mask),
                        box)
    ax = pilcomp.ImageAxes(canvas, box, w, h, out_dpi)
    P = np.asarray(roi_poly_crop, np.float64)
    pilcomp.stamp_lines(canvas, [np.column_stack(ax.to_px(P[:, 0], P[:, 1]))],
                        roi_lw, out_dpi, ImageColor.getrgb(roi_color)[:3] + (204,),
                        clip=box)
    if sb_on and px_size > 0:
        bar_px = sb_len_um / px_size
        if bar_px < w:
            mx, my = int(w * 0.05), int(h * 0.05)
            x_end = w - mx
            (xa, y), (xb, _) = ax.to_px(x_end - bar_px, h - my), ax.to_px(x_end, h - my)
            pilcomp.stamp_bar(canvas, (xa, y), (xb, y), 3, out_dpi, _WHITE, clip=box)
            if sb_text:
                x, y = ax.to_px(x_end - bar_px / 2, h - my - max(10, int(0.02 * h)))
                pilcomp.stamp_label(canvas, float(x), float(y), f"{int(sb_len_um)} µm",
                                    sb_font, out_dpi, _WHITE, "bottom", bold=True)
    if show_cbar:
        pilcomp.stamp_colorbar_axes(
            canvas, cax, pilcomp.colorbar_layout(cax, vmin, vmax, out_dpi, tick_pt=8),
            lut, out_dpi, _WHITE)
    pilcomp.save_canvas_png(canvas, out_path)


def save_morphology_images(img, polys, mets, tag, cfg,
                           png_full_dir, png_crop_dir) -> None:
    """MOR_by_ROI overlay PNGs (src/MOR_by_ROI.py:436-505): the full frame
    with numbered cyan outlines, and per-ROI crops with a title of their
    metrics; every element a PIL stamp."""
    from . import pilcomp

    H, W = img.shape
    if cfg.save_full:
        # matplotlib-era geometry: figsize (8, 8*H/W) at dpi 200
        canvas, box = pilcomp.compose_borderless(
            colormap_rgba_u8(img, "gray"), (1600, int(round(1600 * H / W))), dpi=200)
        for i, poly in enumerate(polys, 1):
            P = np.asarray(poly)
            pilcomp.stamp_polyline(canvas, box, W, H, P, dpi=200)
            pilcomp.stamp_text(canvas, box, W, H,
                               (float(P[:, 0].mean()), float(P[:, 1].mean())),
                               str(i), font_pt=10, dpi=200,
                               box_rgba=(0, 0, 0, 77))  # black alpha 0.3
        pilcomp.save_canvas_png(canvas, os.path.join(
            png_full_dir, f"{tag}_overlay_ch{cfg.sel_ch}.png"))

    if not cfg.save_crop:
        return
    os.makedirs(png_crop_dir, exist_ok=True)
    for i, (poly, met) in enumerate(zip(polys, mets), 1):
        P = np.asarray(poly)
        x0, x1, y0, y1 = crop_bbox_poly(P, W, H)
        crop = img[y0:y1 + 1, x0:x1 + 1]
        P2 = P.copy()
        P2[:, 0] -= x0
        P2[:, 1] -= y0
        if cfg.mask_outside:
            crop = crop * rasterize_polygon_np(P2, crop.shape).astype(crop.dtype)
        ch_, cw_ = crop.shape
        title = (f"{tag}  ROI#{i}  ch{cfg.sel_ch}  "
                 f"AR={met['aspect_ratio']:.2f}  "
                 f"Circ={met['circularity']:.3f}")
        # matplotlib-era geometry: figsize (5, 5*h/w) at dpi 220; small
        # crops cap at 2x blow-up unless MorConfig.mpl_canvas
        canvas, box = pilcomp.compose_titled(
            colormap_rgba_u8(crop, "gray"), 1100, title, font_pt=9, dpi=220,
            max_upscale=None if cfg.mpl_canvas else 2.0)
        pilcomp.stamp_polyline(canvas, box, cw_, ch_, P2, dpi=220)
        if cfg.add_scalebar and cfg.scale_bar_um is not None:
            bar_px = int(round(float(cfg.scale_bar_um) / cfg.px_um))
            max_bar = int(0.8 * cw_)
            if bar_px > max_bar and max_bar > 1:
                bar_px = max_bar
            bar_px = max(bar_px, 2)
            spec = scalebar_spec(cw_, ch_, bar_px * cfg.px_um, cfg.px_um)
            pilcomp.stamp_scalebar(canvas, box, cw_, ch_, spec, dpi=220)
        pilcomp.save_canvas_png(canvas, os.path.join(
            png_crop_dir, f"{tag}_roi{i}_ch{cfg.sel_ch}.png"))
