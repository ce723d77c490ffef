"""Multi-domain synthetic cell fields (the port's copy, numpy only).

Five appearance domains (``DOMAINS``): fluor (sparse bright cells, dark
background), dense (confluent touching cells), inverted (dark cells on a
bright background), ring (membrane-bright cells) and texture (speckled
interiors).  Cells are star-convex shapes r(theta) = r0 * (1 + sum_k a_k
cos(k theta + phi_k)) rasterized from the radial bound; touching cells
go to the highest normalized interiorness (1 - d / r(theta)).  Intensity
fields are raw-camera-like: u16 range, background gradients, vignetting,
Gaussian read noise, optional Poisson shot noise.  ``synth_frame`` draws
one field; ``eval_frame`` the deterministic held-out field of a seed;
``frame_arrays`` a field's training triplet (its stretch runs on the port's
device path, the rest is numpy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

DOMAINS = ("fluor", "dense", "inverted", "ring", "texture")


def _cell_window(rng: np.random.Generator, H: int, W: int, cy: float,
                 cx: float, r0: float, irregularity: float):
    """Star-convex cell footprint in a local window.

    Returns (y0, x0, dist, rbound, inside) where dist/rbound are the
    window's per-pixel center distance and angular radius bound."""
    n_harm = 4
    amps = rng.normal(0.0, irregularity / np.arange(1, n_harm + 1))
    phis = rng.uniform(0, 2 * np.pi, n_harm)
    # elongation: radius modulated by a k=2 term is an ellipse-ish stretch
    rmax = r0 * (1.0 + np.abs(amps).sum() + 0.05)
    y0, y1 = max(0, int(cy - rmax - 2)), min(H, int(cy + rmax + 3))
    x0, x1 = max(0, int(cx - rmax - 2)), min(W, int(cx + rmax + 3))
    if y0 >= y1 or x0 >= x1:
        return y0, x0, None, None, None
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dy = yy - cy
    dx = xx - cx
    dist = np.sqrt(dy * dy + dx * dx)
    theta = np.arctan2(dy, dx)
    rbound = np.full(dist.shape, r0)
    for k in range(n_harm):
        rbound = rbound + r0 * amps[k] * np.cos((k + 1) * theta + phis[k])
    rbound = np.maximum(rbound, 0.35 * r0)
    return y0, x0, dist, rbound, dist <= rbound


def synth_frame(
    rng: np.random.Generator,
    H: int,
    W: int,
    domain: str,
    n_cells: Optional[int] = None,
    r_range: Tuple[float, float] = (8.0, 36.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic field -> (raw f32 image in u16 range, i32 labels).

    Labels are 1..N instance ids (0 = background); every label id present
    owns >= 1 pixel."""
    if domain not in DOMAINS:
        raise ValueError(f"unknown domain {domain!r}; one of {DOMAINS}")
    r_lo, r_hi = r_range
    dense = domain == "dense"
    if n_cells is None:
        area = H * W
        mean_r = 0.5 * (r_lo + r_hi)
        fill = rng.uniform(0.25, 0.55) if dense else rng.uniform(0.04, 0.18)
        n_cells = max(3, int(fill * area / (np.pi * mean_r * mean_r)))

    # --- geometry: score-map ownership (highest interiorness wins) ---
    score = np.zeros((H, W), np.float32)
    labels = np.zeros((H, W), np.int32)
    centers: List[Tuple[float, float]] = []
    placed = 0
    attempts = 0
    while placed < n_cells and attempts < n_cells * 8:
        attempts += 1
        r0 = float(rng.uniform(r_lo, r_hi))
        cy = float(rng.uniform(2, H - 2))
        cx = float(rng.uniform(2, W - 2))
        if not dense:
            # sparse domains keep centers separated (occasional touching
            # pairs still occur through shape irregularity)
            too_close = any((cy - py) ** 2 + (cx - px) ** 2 < (1.4 * r0) ** 2
                            for py, px in centers)
            if too_close:
                continue
        irr = float(rng.uniform(0.05, 0.22))
        y0, x0, dist, rbound, inside = _cell_window(rng, H, W, cy, cx, r0, irr)
        if inside is None or not inside.any():
            continue
        placed += 1
        centers.append((cy, cx))
        s = np.where(inside, 1.0 - dist / np.maximum(rbound, 1e-6), 0.0)
        win_sc = score[y0:y0 + s.shape[0], x0:x0 + s.shape[1]]
        win_lb = labels[y0:y0 + s.shape[0], x0:x0 + s.shape[1]]
        take = s > win_sc
        win_sc[take] = s[take].astype(np.float32)
        win_lb[take] = placed
    # relabel densely: fully-overwritten cells drop out
    ids = np.unique(labels)
    ids = ids[ids > 0]
    remap = np.zeros(labels.max() + 1, np.int32)
    remap[ids] = np.arange(1, len(ids) + 1, dtype=np.int32)
    labels = remap[labels]

    # --- photometry ---
    img = _render(rng, labels, score, domain, H, W)
    return img, labels


def _render(rng: np.random.Generator, labels: np.ndarray, score: np.ndarray,
            domain: str, H: int, W: int) -> np.ndarray:
    """Raw-camera-like intensity field for the label map."""
    bg_level = float(rng.uniform(80, 2000))
    if domain == "inverted":
        bg_level = float(rng.uniform(8000, 35000))
    # smooth background: plane gradient + wide Gaussian bump (vignette-ish)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    gy, gx = rng.normal(0, 0.3 / max(H, W), 2) * bg_level
    img = bg_level + gy * (yy - H / 2) + gx * (xx - W / 2)
    by, bx = rng.uniform(0.2, 0.8, 2)
    bw_ = rng.uniform(0.5, 1.5)
    bump = rng.uniform(-0.25, 0.25) * bg_level
    img = img + bump * np.exp(-(((yy / H - by) ** 2 + (xx / W - bx) ** 2)
                                / (2 * bw_ ** 2)))

    fg = labels > 0
    n = int(labels.max())
    amp_scale = float(rng.uniform(3.0, 15.0)) * max(bg_level, 150.0)
    if domain == "inverted":
        amp_scale = float(rng.uniform(0.4, 0.85)) * bg_level
    amps = rng.uniform(0.35, 1.0, n + 1).astype(np.float32) * amp_scale
    if domain == "texture":
        amps = (rng.uniform(0.1, 1.0, n + 1) ** 2).astype(np.float32) * amp_scale
    amps[0] = 0.0
    cell_amp = amps[labels]

    # interiorness in [0,1] (score is 1 at the center, 0 at the rim)
    s = np.clip(score, 0.0, 1.0)
    if domain == "ring":
        # membrane-bright: peak near the rim, dim interior
        rim = np.exp(-((s - 0.12) ** 2) / (2 * 0.07 ** 2))
        profile = rim + rng.uniform(0.05, 0.3) * s
    else:
        # soft radial falloff toward the rim, never to zero
        profile = 0.45 + 0.55 * np.sqrt(s)
    tex = 1.0
    if domain in ("texture", "dense"):
        tex = 1.0 + rng.uniform(0.15, 0.4) * rng.standard_normal((H, W))
        tex = np.clip(tex, 0.2, 2.5)
    delta = cell_amp * profile * tex * fg
    if domain == "inverted":
        img = img - delta
    else:
        img = img + delta

    # noise: Gaussian read noise always; Poisson shot noise half the time
    img = img + rng.normal(0, max(2.0, 0.02 * bg_level), (H, W))
    img = np.clip(img, 0.0, 60000.0)
    if rng.random() < 0.5:
        img = rng.poisson(img).astype(np.float32)
    return img.astype(np.float32)


def stretch_for_training(img: np.ndarray, device="cuda") -> np.ndarray:
    """The 1-99 percentile stretch that ``segment.cellseg`` applies at
    inference (``ops.view.stretch_view``), run on *device*: float32 HxW in
    [0, 1] on the host."""
    import torch

    from ..device import resolve_device
    from ..ops.view import stretch_view

    x = torch.as_tensor(np.asarray(img, np.float32)).to(resolve_device(device))
    return stretch_view(x, 1000, 99000, 1.0, False).cpu().numpy()


def frame_arrays(img: np.ndarray, labels: np.ndarray, device="cuda"):
    """(normalized x, probs, flows) training triplet from a synthetic frame
    — same supervision construction as models.golden.frame_training_arrays
    (inference-matched 1-99 stretch, centroid-pointing unit flows)."""
    H, W = img.shape
    x = stretch_for_training(img, device)
    probs = (labels > 0).astype(np.float32)
    flows = np.zeros((H, W, 2), np.float32)
    # single pass over foreground pixels (not O(n_cells * H * W) full-frame
    # sweeps): per-label centroids via bincount, then each pixel's flow from
    # its own label's centroid by a gather
    ys, xs = np.nonzero(labels)
    if ys.size:
        labs = labels[ys, xs].astype(np.int64)
        nlab = int(labs.max())
        cnt = np.bincount(labs, minlength=nlab + 1).astype(np.float64)
        cnt[cnt == 0] = 1.0
        cy = (np.bincount(labs, weights=ys, minlength=nlab + 1) / cnt)[labs]
        cx = (np.bincount(labs, weights=xs, minlength=nlab + 1) / cnt)[labs]
        fy = ys.astype(np.float32)
        fx = xs.astype(np.float32)
        cy = cy.astype(np.float32)
        cx = cx.astype(np.float32)
        d = np.sqrt((fy - cy) ** 2 + (fx - cx) ** 2) + np.float32(1e-6)
        flows[ys, xs, 0] = (cy - fy) / d
        flows[ys, xs, 1] = (cx - fx) / d
    return x, probs, flows


def eval_frame(seed: int, domain: str, H: int = 512, W: int = 512,
               r_range: Tuple[float, float] = (10.0, 32.0),
               min_px: int = 150) -> Dict[str, np.ndarray]:
    """Deterministic held-out eval field for *domain* (seeds disjoint from
    training by construction: training uses a seed sequence, eval pins its
    own).  Ground-truth instances below *min_px* (slivers of cells mostly
    overwritten by a denser neighbor) are dropped — inference filters
    components below min_size_px, so they would be unmatchable by design.
    Returns {img, labels, polys} with ground-truth polygons via the same
    cv2 contour conversion the pipeline outputs."""
    from ..morphology.contours import masks_to_polygons

    rng = np.random.default_rng(100_000 + seed)
    img, labels = synth_frame(rng, H, W, domain, r_range=r_range)
    ids, counts = np.unique(labels[labels > 0], return_counts=True)
    drop = ids[counts < min_px]
    if len(drop):
        labels = np.where(np.isin(labels, drop), 0, labels)
    polys = masks_to_polygons(labels, min_area=20.0)
    return {"img": img, "labels": labels, "polys": polys}
