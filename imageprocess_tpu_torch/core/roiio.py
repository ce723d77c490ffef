"""ROI polygon JSON bundles (port of ``imageprocess_tpu/core/roiio.py``,
JSON only).

``roi/S01.json``: ``{"name", "image_shape": {"height","width"},
"rois": [[[x, y], ...], ...], "view_params": {...}}``.  PNG masks, ImageJ
zips and MATLAB boundaries stay with the reference module for now: the
ported path quantifies polygons only.
"""

from __future__ import annotations

import json
from typing import List

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
