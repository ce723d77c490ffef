"""Real-data training arrays for the segmentation U-Net (port of
``imageprocess_tpu/models/golden.py``).

Turns an experiment frame + its manual polygon ROIs into the network's
supervision triplet: the inference-normalized image, the binary cell-prob
target, and Cellpose-style centroid-flow targets.  The normalization is the
SAME 1-99 percentile stretch that ``segment.cellseg.segment_frame_unet``
applies at inference (train/infer distribution match); it runs on the
port's device path, the rest is numpy.  ``sample_crops`` draws augmented
training crops, equal to JAX's for the same generator.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..geom.rasterize import rasterize_polygon_np
from .synthcells import stretch_for_training


def frame_training_arrays(
    img: np.ndarray, polys: List[np.ndarray], device="cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(normalized f32 HxW, probs HxW {0,1}, flows HxWx2) from one frame."""
    H, W = img.shape
    x = stretch_for_training(img, device)
    probs = np.zeros((H, W), np.float32)
    flows = np.zeros((H, W, 2), np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pv = np.stack([rasterize_polygon_np(np.asarray(p, np.float64), (H, W))
                   for p in polys])
    for m in pv:
        if not m.any():
            continue
        cy, cx = yy[m].mean(), xx[m].mean()
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) + 1e-6
        probs[m] = 1.0
        flows[..., 0] = np.where(m, (cy - yy) / d, flows[..., 0])
        flows[..., 1] = np.where(m, (cx - xx) / d, flows[..., 1])
    return x, probs, flows


def sample_crops(
    rng: np.random.Generator,
    x: np.ndarray,
    probs: np.ndarray,
    flows: np.ndarray,
    tile: int,
    batch: int,
    fg_bias: float = 0.7,
):
    """Random augmented training crops: *fg_bias* of the batch is centered
    on foreground pixels; flips/rot90 (flow channels transform with the
    geometry); mild intensity jitter."""
    H, W = x.shape
    if H < tile or W < tile:
        # small frames: pad up to the crop tile (np.clip with a_min > a_max
        # would otherwise return a NEGATIVE origin and the crop slicing
        # would crash with a broadcast error)
        py, px = max(0, tile - H), max(0, tile - W)
        x = np.pad(x, ((0, py), (0, px)), mode="edge")
        # targets pad with 0 (background), NOT edge: edge-replicated
        # foreground would create duplicate crop centers with cloned flow
        # vectors in the padded strip, biasing tiny-frame sampling
        probs = np.pad(probs, ((0, py), (0, px)))
        flows = np.pad(flows, ((0, py), (0, px), (0, 0)))
        H, W = x.shape
    fg = np.argwhere(probs > 0.5)
    imgs = np.zeros((batch, tile, tile, 1), np.float32)
    pb = np.zeros((batch, tile, tile), np.float32)
    fb = np.zeros((batch, tile, tile, 2), np.float32)
    for b in range(batch):
        if len(fg) and rng.random() < fg_bias:
            cy, cx = fg[rng.integers(len(fg))]
            y0 = int(np.clip(cy - tile // 2 + rng.integers(-tile // 4, tile // 4),
                             0, H - tile))
            x0 = int(np.clip(cx - tile // 2 + rng.integers(-tile // 4, tile // 4),
                             0, W - tile))
        else:
            y0 = int(rng.integers(0, H - tile + 1))
            x0 = int(rng.integers(0, W - tile + 1))
        ci = x[y0:y0 + tile, x0:x0 + tile]
        cp = probs[y0:y0 + tile, x0:x0 + tile]
        cf = flows[y0:y0 + tile, x0:x0 + tile].copy()
        k = int(rng.integers(4))
        if k:
            ci = np.rot90(ci, k)
            cp = np.rot90(cp, k)
            cf = np.rot90(cf, k, axes=(0, 1))
            for _ in range(k):  # rot90 CCW: (dy, dx) -> (-dx, dy)
                cf = np.stack([-cf[..., 1], cf[..., 0]], axis=-1)
        if rng.random() < 0.5:
            ci = ci[:, ::-1]
            cp = cp[:, ::-1]
            cf = cf[:, ::-1]
            cf[..., 1] = -cf[..., 1]
        gain = 1.0 + rng.normal(0, 0.08)
        bias = rng.normal(0, 0.02)
        imgs[b, ..., 0] = np.clip(ci * gain + bias, 0.0, 1.2)
        pb[b] = cp
        fb[b] = cf
    return imgs, pb, fb
