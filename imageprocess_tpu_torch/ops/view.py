"""View ops on the device (port of part of ``imageprocess_tpu/ops/view.py``):
the percentile stretch and the Gaussian blur that segmentation uses.

The rest of the JAX module (DoG band-pass, unsharp, Sobel, CLAHE,
pseudocolor) is still to port.
"""

from __future__ import annotations

import numpy as np
import torch

from .percentile import masked_quantile


def _gauss_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter kernel parity (default truncate=4.0)."""
    radius = max(1, int(truncate * float(sigma) + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each of n + 2r positions under numpy's 'symmetric'
    padding (= scipy's 'reflect': the edge pixel repeats), any r."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian with scipy's 'reflect' border and truncate=4.0
    kernel radius, as a float32 sum of shifted, weighted copies per axis
    (no convolution routine, so no TF32 rounding on a card)."""
    k = _gauss_kernel1d(sigma, truncate).tolist()
    r = (len(k) - 1) // 2
    x = img.to(torch.float32)
    for axis in (0, 1):
        n = x.shape[axis]
        xp = x.index_select(axis, _symmetric_index(n, r, x.device))
        acc = None
        for j, w in enumerate(k):
            term = xp.narrow(axis, j, n) * w
            acc = term if acc is None else acc + term
        x = acc
    return x


def stretch_view(img: torch.Tensor, p_lo1000: int, p_hi1000: int,
                 gamma: float = 1.0, invert: bool = False) -> torch.Tensor:
    """Percentile clip -> [0,1] normalize -> gamma -> optional invert
    (roi_manual_drawer.py:299-314), the quantiles over the finite pixels.
    Returns float32 in [0, 1]."""
    img = img.to(torch.float32)
    finite = torch.isfinite(img)
    lo = masked_quantile(img, finite, p_lo1000)
    hi = masked_quantile(img, finite, p_hi1000)
    # degenerate range: the reference divides by 1e-6
    den = torch.where(hi <= lo, torch.full_like(lo, 1e-6), hi - lo)
    x = ((img - lo) / den).clamp(0.0, 1.0)
    x = torch.pow(x, 1.0 / max(float(gamma), 1e-6))
    return 1.0 - x if invert else x
