"""Polygon rasterization in plain PyTorch.

Port of ``imageprocess_tpu/geom/rasterize.py`` (``EdgeRule``,
``rasterize_polygons``): a row-scan crossing test that is data-parallel
over (polygon, row, edge).

1. per (row, edge): does the edge cross the scanline, and at which integer
   threshold ``T`` does the pixel predicate flip — an f32 estimate refined
   by exact product comparisons;
2. per row: scatter-add the edge toggles into a (W+1) histogram;
3. inside(x) = parity of the suffix count, one cumulative sum per row.

Every step is its own PyTorch operation, so each product and sum rounds to
f32 separately, exactly as in the JAX function: masks are bit-equal for
both rules, on lattice and non-lattice vertices alike.  The JAX package
runs this in XLA, not Pallas; a hand kernel for it is later work.
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np
import torch


class EdgeRule(str, enum.Enum):
    MPL = "mpl"        # matplotlib.path.Path.contains_points parity
    PNPOLY = "pnpoly"  # skimage.draw.polygon / Franklin parity


def _threshold(dy, s, strict: bool):
    """Smallest integer t with t*dy > s (strict) or t*dy >= s."""
    safe = torch.where(dy != 0, dy, torch.ones_like(dy))
    est = torch.where(dy != 0, s / safe, torch.zeros_like(s))
    t0 = torch.floor(est) + 1 if strict else torch.ceil(est)
    if strict:
        p = t0 * dy > s
        pm = (t0 - 1) * dy > s
    else:
        p = t0 * dy >= s
        pm = (t0 - 1) * dy >= s
    return t0 + (~p).to(dy.dtype) - pm.to(dy.dtype)


def rasterize_polygons(
    verts: torch.Tensor,
    shape: Tuple[int, int],
    rule: EdgeRule = EdgeRule.MPL,
) -> torch.Tensor:
    """Padded polygons (N, V, 2) [x, y] float32 -> (N, H, W) bool masks.

    Ragged polygons are padded with their own first vertex
    (``pad_polygons``): the synthetic edges are degenerate and cross no
    scanline."""
    H, W = shape
    verts = verts.to(torch.float32)
    N, V, _ = verts.shape
    x0 = verts[:, None, :, 0]                                  # (N, 1, V)
    y0 = verts[:, None, :, 1]
    x1 = torch.roll(x0, -1, dims=-1)
    y1 = torch.roll(y0, -1, dims=-1)
    ty = torch.arange(H, dtype=torch.float32, device=verts.device)[:, None]

    if rule is EdgeRule.MPL:
        up = (y0 > y1) & (y1 < ty) & (ty <= y0)
        down = (y1 > y0) & (y0 < ty) & (ty <= y1)
    else:
        up = (y0 > y1) & (y1 <= ty) & (ty < y0)
        down = (y1 > y0) & (y0 <= ty) & (ty < y1)

    dy_u = y0 - y1
    s_u = x1 * dy_u + (ty - y1) * (x0 - x1)                    # (N, H, V)
    dy_d = y1 - y0
    s_d = x0 * dy_d + (ty - y0) * (x1 - x0)
    t_up = _threshold(dy_u, s_u, strict=False)
    t_down = _threshold(dy_d, s_d, strict=rule is EdgeRule.MPL)

    toggles = up | down
    thresh = torch.where(up, t_up, t_down)
    t_idx = torch.where(toggles, thresh.clamp(0, W),
                        torch.zeros_like(thresh)).to(torch.int64)
    base = torch.arange(N * H, device=verts.device).view(N, H, 1) * (W + 1)
    hist = torch.zeros(N * H * (W + 1), dtype=torch.int32,
                       device=verts.device)
    hist.index_add_(0, (base + t_idx).reshape(-1),
                    toggles.reshape(-1).to(torch.int32))
    hist = hist.view(N, H, W + 1)
    total = hist.sum(dim=-1, keepdim=True, dtype=torch.int32)
    # pixels x < T toggle: count(x) = #edges with T > x = total - prefix(x)
    count = total - torch.cumsum(hist[..., :W], dim=-1, dtype=torch.int32)
    return (count & 1).to(torch.bool)


def rasterize_polygon_np(
    poly: np.ndarray, shape: Tuple[int, int], rule: EdgeRule = EdgeRule.MPL
) -> np.ndarray:
    """Host (numpy, float64) version of the same algorithm for one polygon
    (V, 2) [x, y] -> (H, W) bool: the full-frame unions and crop masks of
    the image outputs, and small interactive calls."""
    H, W = shape
    v = np.asarray(poly, dtype=np.float64)
    x0, y0 = v[:, 0], v[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    ty = np.arange(H, dtype=np.float64)[:, None]

    if rule is EdgeRule.MPL:
        up = (y0 > y1) & (y1 < ty) & (ty <= y0)
        down = (y1 > y0) & (y0 < ty) & (ty <= y1)
    else:
        up = (y0 > y1) & (y1 <= ty) & (ty < y0)
        down = (y1 > y0) & (y0 <= ty) & (ty < y1)

    dy_u = y0 - y1
    s_u = x1 * dy_u + (ty - y1) * (x0 - x1)
    dy_d = y1 - y0
    s_d = x0 * dy_d + (ty - y0) * (x1 - x0)

    def threshold(dy, s, strict):
        with np.errstate(divide="ignore", invalid="ignore"):
            est = np.where(dy != 0, s / np.where(dy != 0, dy, 1.0), 0.0)
        t0 = np.floor(est) + 1 if strict else np.ceil(est)
        p = (t0 * dy > s) if strict else (t0 * dy >= s)
        pm = ((t0 - 1) * dy > s) if strict else ((t0 - 1) * dy >= s)
        return t0 + (~p).astype(np.float64) - pm.astype(np.float64)

    t_up = threshold(dy_u, s_u, strict=False)
    t_down = threshold(dy_d, s_d, strict=(rule is EdgeRule.MPL))

    toggles = up | down
    thresh = np.where(up, t_up, t_down)
    t_idx = np.clip(np.where(toggles, thresh, 0), 0, W).astype(np.int64)
    hist = np.zeros((H, W + 1), np.int64)
    np.add.at(
        hist,
        (np.repeat(np.arange(H), v.shape[0]), t_idx.ravel()),
        toggles.ravel().astype(np.int64),
    )
    total = hist.sum(axis=1, keepdims=True)
    count = total - np.cumsum(hist[:, :W], axis=1)
    return (count % 2).astype(bool)
