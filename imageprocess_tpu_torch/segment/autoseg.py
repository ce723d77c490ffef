"""In-polygon segmentation: the drawer's refine step (port of
``imageprocess_tpu/segment/autoseg.py``).

Reference semantics: src/roi_manual_drawer.py:337-418
(``segment_inside_polygon``): bbox slice -> contains_points (matplotlib
rule) -> threshold (a percentile of the inside values, or BND mode
mu + k*sigma with a p90 fallback when sigma <= 0) -> 4-connected labels ->
the largest component -> holes filled -> find_contours(0.5) -> global
coordinates -> area >= min_area -> approximate_polygon(tolerance) -> the
largest.

The tile program (raster, threshold, CCL, hole filling) runs on *device*
in plain PyTorch, as it is XLA in the JAX package; marching squares and
Douglas-Peucker run on the host (tens of vertices).  Returns
``(thr, None, best_polygon)`` as the reference does (it skips the mask
return for speed too).  ``timer`` phases: ``upload``, ``threshold``
(raster and threshold), ``largest_component`` and ``fill_holes`` (with
their CCL ``rounds``), ``fetch`` and ``contours`` (host).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geom.polygon import douglas_peucker
from ..geom.rasterize import rasterize_polygons
from ..morphology.ccl import fill_holes, largest_component
from ..morphology.contours import find_contours, polygon_area_contour
from ..ops.percentile import masked_quantile
from ..timing import NO_TIMER


def _segment_tile(sub: torch.Tensor, local_poly: torch.Tensor,
                  in_crop: torch.Tensor, p1000: int, thr_k: torch.Tensor,
                  mode: str, timer=NO_TIMER):
    """One bbox tile: (thr f32, filled mask (Th, Tw) bool, n finite inside
    int32, size of the largest component int32), all on the tile's
    device.  *local_poly* is (1, V, 2) in tile coordinates, *in_crop* the
    bbox inside the tile, *thr_k* a float32 0-dim tensor."""
    with timer.phase("threshold"):
        inside = rasterize_polygons(local_poly, tuple(sub.shape))[0] & in_crop
        fin = torch.isfinite(sub)
        finite = inside & fin
        n = finite.sum(dtype=torch.int32)
        keys = torch.where(fin, sub, torch.full_like(sub, float("inf")))
        if mode == "bnd":
            zero = torch.zeros_like(sub)
            nf = torch.clamp(n.to(torch.float32), min=1.0)
            m = torch.where(finite, sub, zero).sum() / nf
            var = torch.where(finite, (sub - m) ** 2, zero).sum() / nf
            s = torch.sqrt(var)
            thr_bnd = m + thr_k * s
            p90 = masked_quantile(keys, finite, 90000)
            thr = torch.where((s <= 0) | ~torch.isfinite(s), p90, thr_bnd)
        else:
            thr = masked_quantile(keys, finite, p1000)
        cand = (sub >= thr) & inside
    with timer.phase("largest_component"):
        largest, size = largest_component(cand, connectivity=1, timer=timer)
    with timer.phase("fill_holes"):
        mask = fill_holes(largest, timer=timer)
    return thr, mask, n, size


def segment_inside_polygon(
    img: np.ndarray,
    poly: np.ndarray,
    thr_param: float = 90.0,
    min_area: float = 40.0,
    tolerance: float = 1.0,
    mode: str = "percentile",
    device="cuda",
    timer=NO_TIMER,
) -> Tuple[Optional[float], None, Optional[np.ndarray]]:
    """Drawer-core parity; returns (threshold, None, best polygon [x, y]).
    The tile goes to *device*: a (Th, Tw) float32 upload, one fetch of
    (n, size, thr) and, when a component was found, one of the mask."""
    dev = resolve_device(device)
    H, W = img.shape[:2]
    p = np.asarray(poly, float)
    min_x = max(0, int(np.floor(p[:, 0].min())))
    max_x = min(W, int(np.ceil(p[:, 0].max())))
    min_y = max(0, int(np.floor(p[:, 1].min())))
    max_y = min(H, int(np.ceil(p[:, 1].max())))
    if max_x <= min_x or max_y <= min_y:
        return None, None, None
    sh, sw = max_y - min_y, max_x - min_x

    # per-axis pow-2 tiles clamped to THAT axis: a square tile clamped to
    # min(H, W) truncated elongated bboxes on non-square frames (the
    # reference slices the true rectangular bbox,
    # roi_manual_drawer.py:358-366); sh <= H and sw <= W by construction,
    # so per-axis clamping always covers the full bbox
    ty = 64
    while ty < sh:
        ty *= 2
    ty = min(ty, H)
    tx = 64
    while tx < sw:
        tx *= 2
    tx = min(tx, W)
    oy = min(min_y, H - ty)
    ox = min(min_x, W - tx)
    sub = np.zeros((ty, tx), np.float32)
    sub[:, :] = img[oy:oy + ty, ox:ox + tx]
    sy, sx = min_y - oy, min_x - ox
    with timer.phase("upload"):
        in_crop = torch.zeros((ty, tx), dtype=torch.bool, device=dev)
        in_crop[sy:sy + sh, sx:sx + sw] = True
        local = torch.from_numpy((p - [ox, oy]).astype(np.float32)[None]).to(dev)
        sub_t = torch.from_numpy(sub).to(dev)
        thr_k = torch.tensor(thr_param, dtype=torch.float32, device=dev)

    thr, mask, n, size = _segment_tile(
        sub_t, local, in_crop, int(round(float(thr_param) * 1000)), thr_k,
        "bnd" if mode.lower() == "bnd" else "percentile", timer)
    with timer.phase("fetch"):
        # float64 holds the int32 counts and the float32 threshold exactly
        n, size, thr = torch.stack([n.double(), size.double(), thr.double()]).tolist()
        mask_np = mask[sy:sy + sh, sx:sx + sw].cpu().numpy() if n and size else None
    if n == 0:
        return None, None, None
    if size == 0:
        return thr, None, None

    with timer.phase("contours"):
        contours = find_contours(mask_np.astype(float), 0.5)
        polys = []
        for c in contours:
            xy = np.c_[c[:, 1] + min_x, c[:, 0] + min_y]
            area = polygon_area_contour(xy)
            if area >= float(min_area):
                xy_s = douglas_peucker(xy, float(tolerance))
                if len(xy_s) >= 3:
                    polys.append((area, xy_s))
    if not polys:
        return thr, None, None
    best = max(polys, key=lambda t: t[0])[1]
    return thr, None, best
