"""Host-side polygon vertex math and padding (the port's copy).

Vertex counts are tiny (tens), so this stays on the host; only
rasterization and pixel statistics go to the device.  Formula parity with
the reference: perimeter, shoelace area and the Andrew monotone-chain hull
of src/MOR_by_ROI.py:166-191, the signed-area centroid with its
vertex-mean fallback of src/roi_manual_drawer.py:421-433, and the
Douglas-Peucker simplification of the drawer's refined contours; and
matplotlib's point-in-path test (``contains_point``), which the apps'
click selection uses.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def contains_point(poly: np.ndarray, x: float, y: float) -> bool:
    """``matplotlib.path.Path(poly).contains_point((x, y))`` without
    matplotlib: the crossing test of ``point_in_path`` in matplotlib's
    ``_path.h`` (radius 0), in float64.  The polygon is closed implicitly;
    an edge (x0, y0) -> (x1, y1) whose ends lie on either side of the ray
    (``y0 >= y`` differs from ``y1 >= y``) toggles the point when
    ``((y1 - y) * (x0 - x1) >= (x1 - x) * (y0 - y1)) == (y1 >= y)``.
    Fewer than 3 vertices, or a non-finite point, is outside.  The vertices
    are finite (matplotlib would split a path at a NaN vertex)."""
    P = np.asarray(poly, dtype=np.float64)
    x, y = float(x), float(y)
    if len(P) < 3 or not (np.isfinite(x) and np.isfinite(y)):
        return False
    x0, y0 = P[:, 0], P[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    above0, above1 = y0 >= y, y1 >= y
    cross = (above0 != above1) & (((y1 - y) * (x0 - x1) >= (x1 - x) * (y0 - y1))
                                  == above1)
    return bool(np.count_nonzero(cross) & 1)


def polygon_perimeter(poly: np.ndarray) -> float:
    """Sum of closed-ring segment lengths."""
    pts = np.asarray(poly, dtype=float)
    diffs = pts[(np.arange(len(pts)) + 1) % len(pts)] - pts
    return float(np.sqrt((diffs**2).sum(axis=1)).sum())


def shoelace_area(poly: np.ndarray) -> float:
    pts = np.asarray(poly, dtype=float)
    x, y = pts[:, 0], pts[:, 1]
    return float(0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def polygon_centroid(poly: np.ndarray) -> Tuple[float, float]:
    """Area-weighted centroid (signed shoelace); degenerate polygons fall
    back to the vertex mean."""
    pts = np.asarray(poly, dtype=float)
    if pts.shape[0] < 3:
        return float(pts[:, 0].mean()), float(pts[:, 1].mean())
    x, y = pts[:, 0], pts[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    area = 0.5 * cross.sum()
    if abs(area) < 1e-6:
        return float(x.mean()), float(y.mean())
    cx = ((x + xn) * cross).sum() / (6.0 * area)
    cy = ((y + yn) * cross).sum() / (6.0 * area)
    return float(cx), float(cy)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; collinear points dropped (cross <= 0 popped)."""
    pts = np.unique(np.asarray(points, dtype=float), axis=0)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) <= 1:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: List[tuple] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    upper: List[tuple] = []
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    return np.array(lower[:-1] + upper[:-1], dtype=float)


def douglas_peucker(points: np.ndarray, tolerance: float) -> np.ndarray:
    """Ramer-Douglas-Peucker polyline simplification (keeps endpoints).

    Equivalent to ``skimage.measure.approximate_polygon`` up to tie-breaking;
    tolerance is the max perpendicular deviation in pixels."""
    pts = np.asarray(points, dtype=float)
    if len(pts) < 3 or tolerance <= 0:
        return pts.copy()
    keep = np.zeros(len(pts), dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(pts) - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo < 2:
            continue
        a, b = pts[lo], pts[hi]
        seg = b - a
        seg_len = np.hypot(*seg)
        mid = pts[lo + 1 : hi]
        if seg_len == 0:
            dists = np.hypot(*(mid - a).T)
        else:
            d = mid - a
            dists = np.abs(seg[0] * d[:, 1] - seg[1] * d[:, 0]) / seg_len
        imax = int(np.argmax(dists))
        if dists[imax] > tolerance:
            split = lo + 1 + imax
            keep[split] = True
            stack.append((lo, split))
            stack.append((split, hi))
    return pts[keep]


def polygon_bbox(poly: np.ndarray) -> Tuple[int, int, int, int]:
    """Integer pixel bbox (x0, y0, x1, y1) inclusive-exclusive covering the
    polygon's pixel-center tests."""
    pts = np.asarray(poly, dtype=float)
    x0 = int(np.floor(pts[:, 0].min()))
    y0 = int(np.floor(pts[:, 1].min()))
    x1 = int(np.ceil(pts[:, 0].max())) + 1
    y1 = int(np.ceil(pts[:, 1].max())) + 1
    return x0, y0, x1, y1


def pad_polygons(
    polys: Sequence[np.ndarray], max_vertices: int | None = None
) -> np.ndarray:
    """Stack ragged polygons into a dense (N, V, 2) float32 array, padding by
    repeating each polygon's first vertex.

    Padding with vertex 0 makes every synthetic edge either degenerate
    (v0 -> v0) or the true closing edge (v_last -> v0), so the crossing-test
    rasterizer needs no validity mask."""
    if max_vertices is None:
        max_vertices = max(len(p) for p in polys)
    out = np.zeros((len(polys), max_vertices, 2), dtype=np.float32)
    for i, p in enumerate(polys):
        p = np.asarray(p, dtype=np.float32)
        n = min(len(p), max_vertices)
        out[i, :n] = p[:n]
        out[i, n:] = p[0]
    return out
