"""Region properties as segment reductions (port of
``imageprocess_tpu/morphology/regions.py``).

Per compact label of a label image: area, intensity sum and mean, centroid
and bounding box, as scatter reductions (``index_add_``,
``scatter_reduce_``) over ``max_labels + 1`` bins, giving fixed-shape
(max_labels,) arrays that stay on the device until the host slices the
valid prefix.  *labels* and *intensity* are one image (H, W) or a stack
(..., H, W), where the JAX package runs the 2-D function under ``vmap``:
every image has bins of its own and no loop runs over the images.

A label above *max_labels* is dropped, not clamped into the last bin (the
JAX scatter drops out-of-range indices): the caller reads the overflow flag
of ``ccl.label`` and raises or skips.

The three float sums are accumulated in float64 and rounded once to
float32.  ``index_add_`` on a card adds in no fixed order; in float64 the
order is invisible after the rounding, so two runs, and the serial and the
batched focal-adhesion runner, give the same means and centroids, within
one float32 ulp of the JAX package's sequential float32 sums.  Areas and
boxes are integers and exact either way.
"""

from __future__ import annotations

from typing import Dict

import torch


def region_props(labels: torch.Tensor, intensity: torch.Tensor,
                 max_labels: int = 1024) -> Dict[str, torch.Tensor]:
    """Per-label reductions over compact int32 label images (0 = bg).

    Returns tensors indexed by label - 1 (shape (..., max_labels)): area
    (int32), sum / mean intensity, centroid_r/c (pixel-index mean, like
    regionprops ``centroid``), bbox min_r/min_c/max_r/max_c (inclusive;
    H, W, -1, -1 for an empty label), plus ``n_labels`` (shape (...), int32
    count of non-empty labels)."""
    lead = labels.shape[:-2]
    H, W = labels.shape[-2:]
    dev = labels.device
    lab = labels.reshape(-1, H * W).to(torch.int64)
    B = lab.shape[0]
    n_bins = max_labels + 2          # the last bin takes the dropped labels
    lab = torch.where(lab <= max_labels, lab, max_labels + 1)
    idx = (lab + torch.arange(B, device=dev)[:, None] * n_bins).reshape(-1)
    rows = torch.arange(H, device=dev, dtype=torch.int32)[:, None].expand(H, W)
    cols = torch.arange(W, device=dev, dtype=torch.int32)[None, :].expand(H, W)
    rows = rows.reshape(-1).repeat(B)
    cols = cols.reshape(-1).repeat(B)

    def bins(fill, dtype):
        return torch.full((B * n_bins,), fill, dtype=dtype, device=dev)

    def out(x):
        return x.reshape(B, n_bins)[:, 1:max_labels + 1].reshape(*lead, max_labels)

    area = out(bins(0, torch.int32).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32)))
    sums = [out(bins(0, torch.float64).index_add_(0, idx, v.to(torch.float64)))
            .to(torch.float32)
            for v in (intensity.reshape(-1).to(torch.float32), rows, cols)]
    min_r = out(bins(H, torch.int32).scatter_reduce_(0, idx, rows, "amin"))
    min_c = out(bins(W, torch.int32).scatter_reduce_(0, idx, cols, "amin"))
    max_r = out(bins(-1, torch.int32).scatter_reduce_(0, idx, rows, "amax"))
    max_c = out(bins(-1, torch.int32).scatter_reduce_(0, idx, cols, "amax"))
    nf = torch.clamp(area.to(torch.float32), min=1.0)
    return {
        "area": area,
        "sum": sums[0],
        "mean": sums[0] / nf,
        "centroid_r": sums[1] / nf,
        "centroid_c": sums[2] / nf,
        "min_r": min_r,
        "min_c": min_c,
        "max_r": max_r,
        "max_c": max_c,
        "n_labels": (area > 0).sum(dim=-1, dtype=torch.int32),
    }
