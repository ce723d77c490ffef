"""What both tables references share: reading the generated files, the
per-ROI statistics and the bfloat16 rounding of the control."""

from __future__ import annotations

import json
import os

import numpy as np

from . import raster

PCTS = (5.0, 50.0, 95.0)
WORKERS = 4   # stages read and reduced at once (NumPy and PIL release the GIL)


def read_frame(path: str) -> np.ndarray:
    """A one-page TIFF as PIL decodes it (u16 stays u16)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def read_rois(folder: str, stage: str) -> list:
    with open(os.path.join(folder, "roi", f"{stage}.json"), encoding="utf-8") as f:
        return [np.asarray(p, dtype=np.float64) for p in json.load(f)["rois"]]


def masks(polys, H: int, W: int):
    """[(y0, y1, x0, x1, mask)] of each polygon, by the frozen raster."""
    out = []
    for p in polys:
        y0, y1, x0, x1 = raster.bbox(p, H, W)
        out.append((y0, y1, x0, x1, raster.polygon_mask(p, y0, y1, x0, x1)))
    return out


def bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    in float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + (((b >> 16) & 1) + 0x7FFF)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def stats(v: np.ndarray, acc=np.float64) -> dict:
    """mean, median, std (ddof 0), p5, p95, vmin, vmax, vsum, npx of *v*,
    sums accumulated in *acc*, quantiles by linear interpolation."""
    p5, med, p95 = np.percentile(v, PCTS)
    x = v.astype(acc)
    n = x.size
    s = x.sum(dtype=acc)
    mean = s / acc(n)
    d = x - mean
    return {"mean": float(mean), "median": float(med),
            "std": float(np.sqrt((d * d).sum(dtype=acc) / acc(n))),
            "p5": float(p5), "p95": float(p95), "vmin": float(v.min()),
            "vmax": float(v.max()), "vsum": float(s), "npx": int(n)}
