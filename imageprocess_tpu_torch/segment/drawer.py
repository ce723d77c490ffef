"""ROI drawer persistence & batch workflows (the non-GUI core of
roi_manual_drawer; port of ``imageprocess_tpu/segment/drawer.py``).

Reference semantics: src/roi_manual_drawer.py — ``save_roi_bundle``
(:1308-1371: JSON + uint8 255 mask TIFF [skimage polygon fill rule] +
view-rendered overlay PNG with numbered green outlines + ImageJ .zip),
``_apply_view_and_color`` (:1293-1307), PCOLORS (:290-297), startup task
grouping (:1375-1433).

The batch API refines rough polygons with ``segment_inside_polygon`` on
*device* and persists full bundles; the interactive annotator
(``apps.draw``) saves through :func:`save_drawer_bundle` too.  PIL is
imported only by the overlay writer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import naming, roiio, tiffio
from ..core.i18n import t
from ..device import resolve_device
from ..geom.rasterize import EdgeRule, rasterize_polygon_np
from .autoseg import segment_inside_polygon

PCOLORS = {
    "grayscale": None,
    "green": np.array([0.0, 1.0, 0.0], np.float32),
    "magenta": np.array([1.0, 0.0, 1.0], np.float32),
    "cyan": np.array([0.0, 1.0, 1.0], np.float32),
    "yellow": np.array([1.0, 1.0, 0.0], np.float32),
    "red": np.array([1.0, 0.0, 0.0], np.float32),
    "blue": np.array([0.0, 0.0, 1.0], np.float32),
}

FAST_OVERLAY_MAXPX = 1600  # roi_manual_drawer.py FAST_OVERLAY default


DEFAULT_VIEW_PARAMS = {
    "p_low": 1.0, "p_high": 99.0, "gamma": 1.0, "invert": False,
    "color_mode": "grayscale",
}


def apply_view_and_color(img: np.ndarray, view_params: dict) -> np.ndarray:
    """Percentile clip -> gamma -> invert -> tint, as RGB float [0, 1]
    (roi_manual_drawer.py:1293-1307)."""
    im = img.astype(np.float32, copy=False)
    vmin = np.percentile(im, float(view_params.get("p_low", 1.0)))
    vmax = np.percentile(im, float(view_params.get("p_high", 99.0)))
    if vmax <= vmin:
        vmax = vmin + 1e-6
    x = np.clip((im - vmin) / (vmax - vmin), 0, 1)
    x = np.power(x, 1.0 / max(float(view_params.get("gamma", 1.0)), 1e-6))
    if bool(view_params.get("invert", False)):
        x = 1.0 - x
    mode = str(view_params.get("color_mode", "grayscale")).lower()
    rgb = PCOLORS.get(mode)
    if rgb is None:
        return np.dstack([x, x, x])
    return np.clip(x[..., None] * rgb.reshape(1, 1, 3), 0, 1)


def save_drawer_bundle(
    roi_dir: str,
    base_S_t: str,
    rois: Sequence[np.ndarray],
    img: np.ndarray,
    view_params: Optional[dict] = None,
    log=print,
):
    """Full drawer output bundle: ``roi/<base>.json``,
    ``roi/mask/<base>_mask.tif`` (255 inside, skimage polygon fill),
    ``roi/overlay/<base>_overlay.png`` (view-rendered with green outlines,
    downscaled to <= 1600 px), ``roi/zip/<base>.zip`` (ImageJ ROIs)."""
    view_params = dict(view_params or DEFAULT_VIEW_PARAMS)
    H, W = img.shape[:2]
    mask_dir = os.path.join(roi_dir, "mask")
    overlay_dir = os.path.join(roi_dir, "overlay")
    zip_dir = os.path.join(roi_dir, "zip")
    for d in (roi_dir, mask_dir, overlay_dir, zip_dir):
        os.makedirs(d, exist_ok=True)

    json_path = os.path.join(roi_dir, f"{base_S_t}.json")
    roiio.save_roi_bundle(json_path, base_S_t, (H, W), rois,
                          view_params=view_params)
    log(t("drawer_json_saved").format(path=json_path))

    # per-artifact isolation from here on: the JSON is the source of
    # truth and its failure aborts, but a failed mask/overlay/zip logs a
    # warning and still writes the remaining artifacts
    # (roi_manual_drawer.py:1331-1371)
    mask_path = os.path.join(mask_dir, f"{base_S_t}_mask.tif")
    try:
        # the committed golden mask (roi/mask/S01_mask.tif) is pixel-exact
        # under the matplotlib edge rule — skimage.draw.polygon agrees with
        # it on contour-derived (half-integer) vertices, NOT classic PNPOLY
        mask = np.zeros((H, W), np.uint8)
        for poly in rois:
            if len(poly) >= 3:
                m = rasterize_polygon_np(np.asarray(poly, float), (H, W),
                                         EdgeRule.MPL)
                mask[m] = 255
        tiffio.write_tiff8(mask_path, mask)
        log(t("drawer_mask_saved").format(path=mask_path))
    except Exception as e:
        log(t("drawer_mask_failed").format(err=e))
        mask_path = None  # don't point callers at a missing/stale file

    png_path = os.path.join(overlay_dir, f"{base_S_t}_overlay.png")
    try:
        from PIL import Image, ImageDraw, ImageFont

        bg_rgb = apply_view_and_color(img, view_params)
        Hs, Ws = bg_rgb.shape[:2]
        scale = min(1.0, FAST_OVERLAY_MAXPX / max(Hs, Ws))
        canvas = (bg_rgb * 255).astype(np.uint8)
        pil_img = Image.fromarray(canvas)
        if scale < 1.0:
            pil_img = pil_img.resize((int(Ws * scale), int(Hs * scale)),
                                     Image.BILINEAR)
        draw = ImageDraw.Draw(pil_img)
        font = ImageFont.load_default()
        for i, poly in enumerate(rois, 1):
            P = np.asarray(poly, float) * scale
            xy = [tuple(p) for p in P]
            if len(xy) >= 2:
                draw.line(xy + [xy[0]], width=2, fill=(0, 255, 0))
                draw.text((float(P[:, 0].mean()), float(P[:, 1].mean())),
                          str(i), fill=(255, 210, 0), font=font)
        tmp = png_path + ".tmp"
        try:
            pil_img.save(tmp, format="PNG", optimize=True)
            os.replace(tmp, png_path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)  # atomic-write contract: never leave a .tmp
            raise
        log(t("drawer_overlay_saved").format(path=png_path))
    except Exception as e:
        log(t("drawer_overlay_failed").format(err=e))
        png_path = None

    zip_path = os.path.join(zip_dir, f"{base_S_t}.zip")
    try:
        roiio.save_imagej_roi_zip(zip_path, list(rois), base_S_t)
        log(t("drawer_zip_saved").format(path=zip_path))
    except Exception as e:
        log(t("drawer_zip_failed").format(err=e))
        zip_path = None
    return json_path, mask_path, png_path, zip_path


@dataclass
class RefineConfig:
    """Batch refinement of rough polygons (the drawer's accept-loop defaults,
    roi_manual_drawer.py:1024-1077)."""

    thr_param: float = 90.0
    min_area: float = 40.0
    tolerance: float = 1.0
    mode: str = "percentile"      # "percentile" | "bnd"
    channel: Optional[int] = None
    timelapse: bool = False
    view_params: Dict = field(default_factory=lambda: dict(DEFAULT_VIEW_PARAMS))


def refine_and_save(
    img_dir: str,
    cfg: RefineConfig,
    roi_dir: Optional[str] = None,
    log=print,
    device="cuda",
) -> List[str]:
    """For every frame with an existing rough ROI JSON: re-segment each
    polygon with the drawer core on *device* and write the full bundle
    back."""
    device = resolve_device(device)
    roi_dir = roi_dir or os.path.join(img_dir, "roi")
    files = naming.list_tifs(img_dir)
    written = []
    for path in files:
        base = os.path.basename(path)
        k = naming.parse_tokens(base, cfg.timelapse, naming.ChannelGrammar.KEYWORD)
        if cfg.channel is not None and k.channel != cfg.channel:
            continue
        tag = naming.clean_base_for_save(base, cfg.timelapse,
                                         naming.ChannelGrammar.KEYWORD)
        json_path = os.path.join(roi_dir, f"{tag}.json")
        if not os.path.exists(json_path):
            continue
        rough = roiio.load_roi_polygons(json_path)
        if not rough:
            continue
        img = tiffio.read_2d(path)
        refined = []
        for poly in rough:
            _, _, best = segment_inside_polygon(
                img, poly, thr_param=cfg.thr_param, min_area=cfg.min_area,
                tolerance=cfg.tolerance, mode=cfg.mode, device=device,
            )
            refined.append(best if best is not None else np.asarray(poly))
        save_drawer_bundle(roi_dir, tag, refined, img,
                           view_params=cfg.view_params, log=log)
        written.append(json_path)
    return written
