"""The TIFF image outputs of the intensity, FRET and rim-FRET runners.

Port of the TIFF branches of ``imageprocess_tpu/report/render.py``
(``save_intensity_images``, ``save_fret_images``, ``save_nesprin2_images``)
and of ``_auto_minmax_np``: the same folders, file names and pixels, through
numpy and PIL alone.  Each function returns after its TIFF part; the PNG
outputs need matplotlib and are not ported (``refuse_image_outputs``).

The frames arrive as host arrays: the runners copy them from the device
only when ``do_tif`` is on.  The percentile range of the 16-bit previews is
taken on the host with ``np.percentile``, so a preview is bit-equal to the
JAX package's for the same frame.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..core import tiffio
from ..geom.rasterize import rasterize_polygon_np

IMAGE_OUTPUTS = "the PNG outputs slice (ROADMAP Queue 1 item 14b)"


def refuse_image_outputs(do_images: bool) -> None:
    """Raise for a config that asks for PNG image outputs (``do_png``;
    morphology's ``save_full`` / ``save_crop``)."""
    if do_images:
        raise NotImplementedError(
            f"PNG image outputs are not ported yet: {IMAGE_OUTPUTS}")


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


def save_intensity_images(extras: dict, cfg, out_root: str) -> None:
    """``TIFF/{stid}_ch{ch}_bgcorr.tif`` (float32) and
    ``TIFF16/{stid}_ch{ch}_bgcorr_preview.tif`` for one (stage, time) key;
    with ``tif_mask_outside`` the pixels outside the ROI union are 0.
    ``extras["imgs_bc"]`` is the (C, H, W) float32 corrected stack on the
    host."""
    refuse_image_outputs(cfg.do_png)
    if not cfg.do_tif:
        return
    stid = extras["stid"]
    chs: Sequence[int] = extras["chs"]
    imgs_bc = extras["imgs_bc"]
    polys = extras["polys"]
    union_mask = extras["union_mask"]

    union = None
    if cfg.tif_mask_outside:   # the host union is rasterized only for this
        if polys is not None:
            union = polygon_union(polys, tuple(extras["shape"]))
        elif union_mask is not None:
            union = np.asarray(union_mask, bool)

    tif32_dir = os.path.join(out_root, "TIFF")
    tif16_dir = os.path.join(out_root, "TIFF16")
    os.makedirs(tif32_dir, exist_ok=True)
    os.makedirs(tif16_dir, exist_ok=True)
    for ci, ch in enumerate(chs):
        img_to_save = imgs_bc[ci]
        if union is not None:
            img_to_save = np.where(union, img_to_save, 0.0).astype(np.float32)
        tiffio.write_tiff32(
            os.path.join(tif32_dir, f"{stid}_ch{ch}_bgcorr.tif"), img_to_save)
        vals = img_to_save[np.isfinite(img_to_save)]
        if vals.size > 0:
            lo, hi = _auto_minmax_np(vals, cfg.auto_lo, cfg.auto_hi)
            tiffio.write_tiff16(
                os.path.join(tif16_dir, f"{stid}_ch{ch}_bgcorr_preview.tif"),
                tiffio.normalize_to_u16(img_to_save, lo, hi))


def save_fret_images(stid, suffix, R_full, union, polys, cfg, dirs) -> None:
    """The ratio frame of one FRET pair as ``RAT`` 32/16-bit TIFFs and, with
    ROIs, the ``RAT_ROI_masked`` variants (NaN outside the union)."""
    refuse_image_outputs(cfg.do_png)
    if not cfg.do_tif:
        return

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

    tif_pair(R_full, "RAT32", "RAT16")
    if polys is not None and union is not None:
        R_roi = R_full.copy()
        R_roi[~union] = np.nan
        tif_pair(R_roi, "RROI32", "RROI16")


def save_nesprin2_images(tag, suffix, R_full, rim, cfg, dirs) -> None:
    """``{tag}_ratio_full_{suffix}.tif`` and ``{tag}_ratio_rim_{suffix}.tif``
    (float32; NaN outside the rim) for one rim-FRET pair."""
    refuse_image_outputs(cfg.do_png)
    if not cfg.do_tif:
        return
    for d in ("tif32_full", "tif32_rim"):
        os.makedirs(dirs[d], exist_ok=True)
    tiffio.write_tiff32(
        os.path.join(dirs["tif32_full"], f"{tag}_ratio_full_{suffix}.tif"),
        R_full)
    tiffio.write_tiff32(
        os.path.join(dirs["tif32_rim"], f"{tag}_ratio_rim_{suffix}.tif"),
        np.where(rim, R_full, np.nan))
