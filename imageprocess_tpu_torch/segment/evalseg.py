"""Instance-segmentation quality metrics (the port's copy of
``imageprocess_tpu/segment/evalseg.py``, host only).

The reference ships no segmentation eval (Cellpose is trusted as-is,
src/ROI_auto_drawer.py:241); the rebuild's learned path carries an explicit
quality bar: predicted polygons are greedily matched to golden manual
polygons by IoU and scored (mean matched IoU + recall/precision).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..geom.rasterize import rasterize_polygon_np


def _rasterize_host(poly: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    # the host rasterizer: the same MPL-rule algorithm as the device one,
    # in float64, one full-frame mask per polygon
    return rasterize_polygon_np(np.asarray(poly, np.float64), shape)


def match_instances(
    pred_polys: Sequence[np.ndarray],
    true_polys: Sequence[np.ndarray],
    shape: Tuple[int, int],
    iou_threshold: float = 0.5,
) -> Dict[str, object]:
    """Greedy IoU matching of predicted vs ground-truth polygons.

    Returns {"pairs": [(ti, pi, iou)], "mean_iou", "recall", "precision"}:
    mean_iou over matched pairs (0.0 if none), recall = matched / n_true,
    precision = matched / n_pred.
    """
    pred_masks = [_rasterize_host(p, shape) for p in pred_polys]
    true_masks = [_rasterize_host(p, shape) for p in true_polys]
    ious = np.zeros((len(true_masks), len(pred_masks)), np.float64)
    for ti, tm in enumerate(true_masks):
        ts = tm.sum()
        for pi, pm in enumerate(pred_masks):
            inter = np.logical_and(tm, pm).sum()
            if inter == 0:
                continue
            union = ts + pm.sum() - inter
            ious[ti, pi] = inter / union
    pairs: List[Tuple[int, int, float]] = []
    used_t, used_p = set(), set()
    order = np.dstack(np.unravel_index(np.argsort(-ious, axis=None),
                                       ious.shape))[0]
    for ti, pi in order:
        if ious[ti, pi] < iou_threshold:
            break
        if ti in used_t or pi in used_p:
            continue
        pairs.append((int(ti), int(pi), float(ious[ti, pi])))
        used_t.add(ti)
        used_p.add(pi)
    n_t = max(1, len(true_masks))
    n_p = max(1, len(pred_masks))
    return {
        "pairs": pairs,
        "mean_iou": float(np.mean([iou for *_, iou in pairs])) if pairs else 0.0,
        "recall": len(pairs) / n_t,
        "precision": len(pairs) / n_p,
    }
