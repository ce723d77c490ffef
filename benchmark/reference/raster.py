"""Polygon masks by matplotlib's ``Path.contains_points`` rule, in NumPy.

A frozen copy for the benchmark's reference: pixel (x, y) is inside when a
ray to +x crosses the outline an odd number of times, where an edge crosses
row y when min(y0, y1) < y <= max(y0, y1); at the crossing an upward edge
(y0 > y1) counts pixels strictly left of it, a downward one also the pixel
on it.  float64 throughout: with vertices on a 1/16 px lattice inside a
frame of a few thousand px every product below is exact, so the mask is
the rule's and not a rounding's.
"""

from __future__ import annotations

import numpy as np


def _threshold(dy, s, strict: bool):
    """Smallest integer t with t*dy > s (strict) or t*dy >= s, for dy > 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        est = np.where(dy != 0, s / np.where(dy != 0, dy, 1.0), 0.0)
    t0 = np.floor(est) + 1 if strict else np.ceil(est)
    p = (t0 * dy > s) if strict else (t0 * dy >= s)
    pm = ((t0 - 1) * dy > s) if strict else ((t0 - 1) * dy >= s)
    return t0 + (~p).astype(np.float64) - pm.astype(np.float64)


def polygon_mask(poly, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
    """(y1 - y0, x1 - x0) bool mask of *poly* ((V, 2) [x, y] in frame
    coordinates) over the frame window rows y0..y1, columns x0..x1."""
    v = np.asarray(poly, dtype=np.float64)
    vx, vy = v[:, 0] - x0, v[:, 1]
    ax, ay = vx, vy
    bx, by = np.roll(vx, -1), np.roll(vy, -1)
    ty = np.arange(y0, y1, dtype=np.float64)[:, None]
    up = (ay > by) & (by < ty) & (ty <= ay)
    down = (by > ay) & (ay < ty) & (ty <= by)
    s_up = bx * (ay - by) + (ty - by) * (ax - bx)
    s_down = ax * (by - ay) + (ty - ay) * (bx - ax)
    t = np.where(up, _threshold(ay - by, s_up, strict=False),
                 _threshold(by - ay, s_down, strict=True))
    W = x1 - x0
    toggles = up | down
    idx = np.clip(np.where(toggles, t, 0), 0, W).astype(np.int64)
    rows = np.broadcast_to(np.arange(y1 - y0)[:, None], idx.shape)
    hist = np.zeros((y1 - y0, W + 1), np.int64)
    np.add.at(hist, (rows[toggles], idx[toggles]), 1)
    # pixel x toggles for every crossing edge whose threshold lies above x
    count = hist.sum(axis=1, keepdims=True) - np.cumsum(hist[:, :W], axis=1)
    return (count & 1).astype(bool)


def bbox(poly, H: int, W: int):
    """(y0, y1, x0, x1): the frame rows and columns a polygon can cover."""
    v = np.asarray(poly, dtype=np.float64)
    y0 = max(0, int(np.floor(v[:, 1].min())))
    y1 = min(H, int(np.ceil(v[:, 1].max())) + 1)
    x0 = max(0, int(np.floor(v[:, 0].min())))
    x1 = min(W, int(np.ceil(v[:, 0].max())) + 1)
    return y0, y1, x0, x1
