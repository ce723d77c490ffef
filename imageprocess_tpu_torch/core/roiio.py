"""ROI polygon JSON bundles (port of ``imageprocess_tpu/core/roiio.py``,
JSON only).

``roi/S01.json``: ``{"name", "image_shape": {"height","width"},
"rois": [[[x, y], ...], ...], "view_params": {...}, "generated_by": ...}``.
PNG masks, ImageJ zips and MATLAB boundaries stay with the reference module
for now: the ported paths read and write polygons only.
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
