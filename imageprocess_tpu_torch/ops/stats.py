"""Masked per-ROI statistics in plain PyTorch.

Port of ``imageprocess_tpu/ops/stats.py`` (``STAT_FIELDS``,
``masked_stats``, ``roi_stats``).  Per ROI and channel: mean, median, std
(ddof=0, two-pass like np.std), p5, p95, min, max, sum, count — over the
*finite* masked values; NaN for every statistic but ``npx`` when there are
none.  The quantiles sort the values once (``quantile_from_sorted``).

``masked_stats_batched`` takes any leading batch shape, so one call serves
a whole (B·N·3, t, t) stack of FRET tiles.  It is the plain version of the
hand kernel ``kernels/roistats_f32.cu``: what the CPU runs and what the
kernel is held to on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .percentile import quantile_from_sorted

STAT_FIELDS = ("mean", "median", "std", "p5", "p95", "vmin", "vmax", "vsum", "npx")


def masked_stats_batched(
    img: torch.Tensor,      # (..., H, W) float32
    mask: torch.Tensor,     # (..., H, W) bool, broadcasting against img
    p_lo1000: int = 5000,
    p_hi1000: int = 95000,
) -> Dict[str, torch.Tensor]:
    """:func:`masked_stats` over the trailing (H, W) of every leading
    index: each statistic comes back with the leading shape."""
    img, mask = torch.broadcast_tensors(img, mask)
    x = img.reshape(*img.shape[:-2], -1)
    valid = mask.reshape(x.shape) & torch.isfinite(x)
    n = valid.sum(dim=-1, dtype=torch.int32)
    nf = torch.clamp(n.to(torch.float32), min=1.0)

    # where(), never x * mask: a non-finite pixel anywhere in the tile
    # would poison a product sum (NaN * 0 = NaN)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    total = torch.where(valid, x, zero).sum(dim=-1)
    mean = total / nf
    var = torch.where(valid, (x - mean[..., None]) ** 2, zero).sum(dim=-1) / nf
    vmin = torch.where(valid, x, inf).amin(dim=-1)
    vmax = torch.where(valid, x, -inf).amax(dim=-1)

    xs = torch.sort(torch.where(valid, x, inf), dim=-1).values

    empty = n == 0
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)

    def nanify(v):
        return torch.where(empty, nan, v)

    return {
        "mean": nanify(mean),
        "median": quantile_from_sorted(xs, n, 50000),
        "std": nanify(torch.sqrt(var)),
        "p5": quantile_from_sorted(xs, n, p_lo1000),
        "p95": quantile_from_sorted(xs, n, p_hi1000),
        "vmin": nanify(vmin),
        "vmax": nanify(vmax),
        "vsum": nanify(total),
        "npx": n,
    }


def masked_stats(img: torch.Tensor, mask: torch.Tensor, p_lo1000: int = 5000,
                 p_hi1000: int = 95000) -> Dict[str, torch.Tensor]:
    """All nine reference statistics of img[mask] (finite values only)."""
    return masked_stats_batched(img, mask, p_lo1000, p_hi1000)


def roi_stats(imgs: torch.Tensor, masks: torch.Tensor, p_lo1000: int = 5000,
              p_hi1000: int = 95000) -> Dict[str, torch.Tensor]:
    """Stats for every (channel, roi) pair.

    imgs: (C, H, W) float32; masks: (N, H, W) bool -> dict of (C, N)
    tensors (npx is (C, N) int32; identical across channels unless NaNs
    differ)."""
    return masked_stats_batched(imgs[:, None], masks[None], p_lo1000, p_hi1000)


def auto_minmax(
    img: torch.Tensor,
    p_lo1000: int = 1000,
    p_hi1000: int = 99000,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Display range at the finite (and masked) pixels' percentiles, with a
    hi > lo guard (Fluor_INT.py:540-548): (0, 1) without such pixels, and
    hi = lo + max(1e-6, |lo| * 1e-6) where hi <= lo, so the float32 range
    never collapses."""
    valid = torch.isfinite(img)
    if mask is not None:
        valid = valid & mask
    n = valid.sum(dtype=torch.int32)
    xs = torch.sort(torch.where(valid, img, torch.full_like(img, float("inf")))
                    .reshape(-1)).values
    lo = quantile_from_sorted(xs, n, p_lo1000)
    hi = quantile_from_sorted(xs, n, p_hi1000)
    lo = torch.where(n > 0, lo, torch.zeros_like(lo))
    hi = torch.where(n > 0, hi, torch.ones_like(hi))
    eps = torch.maximum(torch.tensor(1e-6, dtype=lo.dtype, device=lo.device),
                        lo.abs() * 1e-6)
    hi = torch.where(hi <= lo, lo + eps, hi)
    return lo, hi
