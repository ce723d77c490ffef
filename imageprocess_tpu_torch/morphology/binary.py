"""Binary dilation / erosion / closing (port of
``imageprocess_tpu/morphology/binary.py``).

Semantics, as in the JAX module:

- ``disk(r)``: skimage's footprint ``x^2 + y^2 <= r^2``;
- ``binary_dilation``: out-of-image is False, in the (un-flipped)
  correlation convention ``out[x] = OR_{dx in SE} img[x + dx]``;
- ``binary_erosion``: out-of-image True (skimage, ``border_true=True``) or
  False (scipy);
- ``binary_closing_skimage``: dilation then border-True erosion;
- ``square_dilation``: a (2k+1)^2 all-ones dilation, border False.

Dilation and erosion count the footprint's True neighbours with one
single-channel ``F.conv2d`` (a cross-correlation, so the convention holds
as it is).  The counts are small integers, exact in float32 and far from
the 0.5 thresholds, so the result is exact whatever algorithm the backend
picks; the JAX module's run-max decomposition was a TPU workaround.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk parity (L2 ball, inclusive)."""
    r = int(radius)
    y, x = np.mgrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y) <= r * r


def _count(img: torch.Tensor, se: np.ndarray, border: bool,
           dilate: bool) -> torch.Tensor:
    """#True pixels under the footprint at each pixel, out-of-image pixels
    counting as *border*.  The footprint's anchor is the JAX module's: row
    ``n // 2`` for its dilation, ``(n - 1) // 2`` (XLA's SAME padding) for
    its erosion; the two differ only for even-sized footprints."""
    se = np.asarray(se, bool)
    if dilate:
        ry, rx = se.shape[0] // 2, se.shape[1] // 2
    else:
        ry, rx = (se.shape[0] - 1) // 2, (se.shape[1] - 1) // 2
    x = img.to(torch.float32)[None, None]
    x = F.pad(x, (rx, se.shape[1] - 1 - rx, ry, se.shape[0] - 1 - ry),
              value=float(border))
    k = torch.from_numpy(se.astype(np.float32)).to(img.device)[None, None]
    return F.conv2d(x, k)[0, 0]


def binary_dilation(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Binary dilation, out-of-image = False (skimage & scipy default)."""
    return _count(img, se, False, True) > 0.5


def binary_erosion(img: torch.Tensor, se: np.ndarray,
                   border_true: bool = True) -> torch.Tensor:
    """Binary erosion; ``border_true=True`` is skimage's convention
    (border doesn't erode), False is scipy's default."""
    n = int(np.asarray(se, bool).sum())
    return _count(img, se, border_true, False) > (n - 0.5)


def binary_closing_skimage(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """skimage.morphology.binary_closing parity (dilate border-False, then
    erode border-True)."""
    return binary_erosion(binary_dilation(img, se), se, True)


def square_dilation(img: torch.Tensor, k: int) -> torch.Tensor:
    """Dilation with a (2k+1)x(2k+1) all-ones structure, border False —
    scipy.ndimage.binary_dilation(img, np.ones(...)) parity, as one max
    pool (its padding never wins the max).  *img* is (..., H, W): every
    leading index is dilated on its own."""
    if k <= 0:
        return img.to(torch.bool)
    x = img.to(torch.float32).reshape(-1, 1, *img.shape[-2:])
    out = F.max_pool2d(x, 2 * k + 1, stride=1, padding=k) > 0.5
    return out.reshape(img.shape)


def annulus_mask(base: torch.Tensor, inner_px: int, outer_px: int) -> torch.Tensor:
    """Square-dilation annulus around *base*
    (src/FRET/Nesprin2_FRET_Builder.py:416-427): dilate(outer) & ~dilate(inner),
    with the reference's parameter clamping."""
    inner_px = max(1, int(inner_px))
    outer_px = int(outer_px)
    if outer_px <= inner_px:
        outer_px = inner_px + 1
    return square_dilation(base, outer_px) & ~square_dilation(base, inner_px)
