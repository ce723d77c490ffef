"""ROI polygon JSON bundles and PNG union masks (port of
``imageprocess_tpu/core/roiio.py``).

``roi/S01.json``: ``{"name", "image_shape": {"height","width"},
"rois": [[[x, y], ...], ...], "view_params": {...}, "generated_by": ...}``;
``roi/S01.png``: a binary mask, white = inside.  ImageJ zips and MATLAB
boundaries stay with the reference module for now.  PIL is imported only
by the PNG reader.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_roi_polygons(json_path: str, min_vertices: int = 3) -> List[np.ndarray]:
    """Polygons as float (N, 2) arrays of [x, y]; drops degenerate entries
    (< *min_vertices*)."""
    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    polys = []
    for poly in data.get("rois", []):
        arr = np.asarray(poly, dtype=float)
        if arr.ndim == 2 and arr.shape[0] >= min_vertices:
            polys.append(arr)
    return polys


def load_roi_bundle(json_path: str) -> dict:
    """The JSON bundle as it is on disk."""
    with open(json_path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_roi_bundle(
    json_path: str,
    name: str,
    image_shape: Tuple[int, int],
    polygons: Sequence[np.ndarray],
    view_params: Optional[dict] = None,
    generated_by: Optional[str] = None,
) -> None:
    """Atomic write of the reference JSON bundle format."""
    H, W = image_shape
    data: Dict = {
        "name": name,
        "image_shape": {"height": int(H), "width": int(W)},
        "rois": [np.asarray(p, dtype=float).tolist() for p in polygons],
    }
    if view_params is not None:
        data["view_params"] = view_params
    if generated_by is not None:
        data["generated_by"] = generated_by
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    tmp = json_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=1)
    os.replace(tmp, json_path)


def load_mask_png(
    png_path: str, img_shape: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Binary mask (white = True), cropped or zero-padded to *img_shape*
    when given."""
    from PIL import Image

    with Image.open(png_path) as im:
        mask = np.array(im.convert("L")) > 0
    if img_shape is not None and mask.shape != tuple(img_shape):
        H, W = img_shape
        mask = mask[: min(H, mask.shape[0]), : min(W, mask.shape[1])]
        pad_h, pad_w = H - mask.shape[0], W - mask.shape[1]
        if pad_h or pad_w:
            mask = np.pad(mask, ((0, pad_h), (0, pad_w)), constant_values=False)
    return mask


def load_polys_or_mask(
    roi_base: str, img_shape: Optional[Tuple[int, int]] = None
) -> Tuple[Optional[List[np.ndarray]], Optional[np.ndarray]]:
    """(polygons, None) from ``<base>.json`` if present and non-empty, else
    (None, mask) from ``<base>.png``, else (None, None)."""
    json_path = roi_base + ".json"
    if os.path.exists(json_path):
        polys = load_roi_polygons(json_path)
        if polys:
            return polys, None
    png_path = roi_base + ".png"
    if os.path.exists(png_path):
        return None, load_mask_png(png_path, img_shape)
    return None, None


def count_rois(roi_base: str) -> int:
    """Work estimate per frame: len(rois) in the JSON, 1 for a PNG mask,
    else 0."""
    json_path = roi_base + ".json"
    if os.path.exists(json_path):
        try:
            with open(json_path, "r", encoding="utf-8") as f:
                return max(0, len(json.load(f).get("rois", [])))
        except Exception:  # noqa: BLE001 — an unreadable bundle weighs 0
            return 0
    return 1 if os.path.exists(roi_base + ".png") else 0
