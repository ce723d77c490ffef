"""Background estimation and subtraction on the device, in plain PyTorch.

Port of ``imageprocess_tpu/ops/background.py``:

- scope: the full frame or the ROI-union mask;
- mode "percentile": B = percentile of the scoped, strided values, p;
- mode "hist-mode": 2048-bin histogram -> CDF -> first bin with
  CDF >= p/100 -> bin-edge midpoint;
- J = img - B, optionally clipped at 0.

The stride applies to the scoped value sequence (every stride-th scoped
pixel in row-major order, the reference's ``vals[::stride]``).  u8/u16
frames take exact integer paths (a value bisection for the full frame, a
65536-bin histogram for a mask), bit-equal to sorting their float32 cast.

Every division divides by a device tensor or by a power of two: PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which can
differ from the correctly rounded quotient of the JAX function by one bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .percentile import (
    exact_quantile_pos, masked_quantile, quantile_from_sorted, strided_submask,
)
from .tilestats_u16 import bisect_masked_quantile

HIST_BINS = 2048
U16_BINS = 65536
INTEGRAL = (torch.uint8, torch.uint16)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """x clipped to [0, 65535] as int32 (u16 takes few ops on CUDA, so it
    is widened before anything else touches it)."""
    return torch.clamp(x.to(torch.int32), 0, U16_BINS - 1)


def as_float32(x: torch.Tensor) -> torch.Tensor:
    """x as float32 (u16 through int32, a conversion CUDA has)."""
    return x.to(torch.int32).to(torch.float32) if x.dtype == torch.uint16 \
        else x.to(torch.float32)


def integral_masked_quantile(x: torch.Tensor, mask: torch.Tensor,
                             p1000: int) -> torch.Tensor:
    """Exact np.percentile-linear quantile of x[mask] for integral frames
    (u8/u16) via a 65536-bin histogram; NaN for an empty mask."""
    xi = _as_int32(x).reshape(-1).to(torch.int64)
    hist = torch.zeros(U16_BINS, dtype=torch.int32, device=x.device)
    hist.index_add_(0, xi, mask.reshape(-1).to(torch.int32))
    n = hist.sum(dtype=torch.int32)
    k, g = exact_quantile_pos(n, p1000)
    cdf = torch.cumsum(hist, 0, dtype=torch.int32)
    # value of the j-th order statistic = first bin with cdf > j
    k1 = torch.minimum(k + 1, torch.clamp(n - 1, min=0))
    lo, hi = torch.clamp(torch.searchsorted(cdf, torch.stack([k, k1]), right=True),
                         0, U16_BINS - 1).to(torch.float32)
    val = lo + g * (hi - lo)
    return torch.where(n > 0, val, torch.full_like(val, float("nan")))


def histogram_mode_value(x: torch.Tensor, mask: torch.Tensor,
                         p1000: int) -> torch.Tensor:
    """The reference's "hist-mode" background over the finite scoped values
    of float32 *x*: the midpoint of the first of 2048 bins over [min, max]
    whose CDF reaches p/100 (the maximum when none does); NaN when no
    finite value is in scope (the JAX function's percentile fallback over
    an empty scope)."""
    finite = mask & torch.isfinite(x)
    inf = torch.tensor(float("inf"), device=x.device)
    lo = torch.where(finite, x, inf).amin()
    hi = torch.where(finite, x, -inf).amax()
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    idx = torch.clamp(((x - lo) / span * HIST_BINS).to(torch.int32), 0,
                      HIST_BINS - 1)
    hist = torch.zeros(HIST_BINS, dtype=torch.int32, device=x.device)
    hist.index_add_(0, idx.reshape(-1).to(torch.int64),
                    finite.reshape(-1).to(torch.int32))
    total = hist.sum(dtype=torch.int32)
    cdf = (torch.cumsum(hist, 0, dtype=torch.int32).to(torch.float32)
           / torch.clamp(total, min=1).to(torch.float32))
    target = float(np.float32(p1000) / np.float32(100000.0))
    reach = cdf >= target
    first = torch.argmax(reach.to(torch.uint8))  # searchsorted(cdf, target, 'left')
    mid = lo + (first.to(torch.float32) + 0.5) * (span / HIST_BINS)
    thr = torch.where(reach[-1], mid, hi)
    return torch.where(total > 0, thr, torch.full_like(thr, float("nan")))


def bg_value(img: torch.Tensor, p1000: int,
             scope_mask: Optional[torch.Tensor] = None,
             mode: str = "percentile", stride: int = 4) -> torch.Tensor:
    """Scalar float32 background level of one 2-D frame (u8, u16 or float
    values, on any device)."""
    if mode not in ("percentile", "hist-mode"):
        return torch.zeros((), dtype=torch.float32, device=img.device)
    if scope_mask is None:
        # the strided subsample img.ravel()[::stride], sliced up front
        sub = img.reshape(-1)[::stride] if stride > 1 else img.reshape(-1)
        if mode == "hist-mode":
            return histogram_mode_value(
                as_float32(sub), torch.ones_like(sub, dtype=torch.bool), p1000)
        if img.dtype in INTEGRAL:
            # 16-step value-range bisection: exact order statistics with no
            # sort and no scatter (only u8/u16: wider integers would clip)
            xi = _as_int32(sub)[None]
            return bisect_masked_quantile(
                xi, torch.ones_like(xi, dtype=torch.bool), sub.numel(), p1000)[0]
        return quantile_from_sorted(torch.sort(as_float32(sub)).values,
                                    sub.numel(), p1000)
    eff = strided_submask(scope_mask.to(torch.bool), stride)
    if mode == "percentile":
        b = (integral_masked_quantile(img, eff, p1000) if img.dtype in INTEGRAL
             else masked_quantile(as_float32(img), eff, p1000))
    else:
        # binned in float32 (reference arithmetic): integral frames cast
        # first, so the binning matches the float path bit for bit
        b = histogram_mode_value(as_float32(img), eff, p1000)
    # empty scope -> 0.0 (reference: no values, no background)
    return torch.where(eff.any(), b, torch.zeros_like(b))


def bg_correct(img: torch.Tensor, p1000: int,
               scope_mask: Optional[torch.Tensor] = None,
               mode: str = "percentile", stride: int = 4,
               clip_neg: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corrected float32 image, background scalar)."""
    b = bg_value(img, p1000, scope_mask, mode, stride)
    out = as_float32(img) - b
    if clip_neg:
        out = torch.clamp(out, min=0.0)
    return out, b
