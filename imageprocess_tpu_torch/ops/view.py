"""View ops (port of ``imageprocess_tpu/ops/view.py``): the percentile
stretch, the Gaussian blur, the DoG band-pass, unsharp masking, Sobel edges
and CLAHE on the device, and the pseudocolor LUTs on the host.

Reference semantics: the interactive drawer's filter pipeline
(src/roi_manual_drawer.py:299-314, :870-946).  The filters are float32 sums
of shifted, weighted copies, not convolution routines, so a card computes
them without TF32 rounding; divisions by a constant divide by a float32
device tensor (CUDA's division by a host scalar is a reciprocal multiply).
"""

from __future__ import annotations

import os
import threading
from typing import Dict

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


def dog_bandpass(img: torch.Tensor, lo_sigma: float, hi_sigma: float) -> torch.Tensor:
    """Difference-of-Gaussians band-pass (drawer's bandpass filter)."""
    return gaussian_blur(img, lo_sigma) - gaussian_blur(img, hi_sigma)


def unsharp(img: torch.Tensor, sigma: float, amount) -> torch.Tensor:
    """img + amount * (img - gaussian(img)), *amount* as float32."""
    img = img.to(torch.float32)
    amount = torch.as_tensor(amount, dtype=torch.float32, device=img.device)
    return img + amount * (img - gaussian_blur(img, sigma))


# skimage's Sobel kernels / 4, as (row offset, column offset, weight) of the
# cross-correlation over the 1-pixel 'symmetric' pad (zero weights left out)
_SOBEL_X = ((0, 0, 0.25), (0, 2, -0.25), (1, 0, 0.5), (1, 2, -0.5),
            (2, 0, 0.25), (2, 2, -0.25))
_SOBEL_Y = tuple((c, r, w) for r, c, w in _SOBEL_X)


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude with skimage normalization (kernels /4,
    reflect border, hypot/sqrt(2))."""
    x = img.to(torch.float32)
    H, W = x.shape
    xp = x.index_select(0, _symmetric_index(H, 1, x.device)).index_select(
        1, _symmetric_index(W, 1, x.device))

    def correlate(taps):
        acc = None
        for r, c, w in taps:
            term = xp[r:r + H, c:c + W] * w
            acc = term if acc is None else acc + term
        return acc

    gx, gy = correlate(_SOBEL_X), correlate(_SOBEL_Y)
    sqrt2 = torch.tensor(2.0, dtype=torch.float32, device=x.device).sqrt()
    return torch.sqrt(gx * gx + gy * gy) / sqrt2


def _pad_index(n: int, p: int, mode: str, device) -> torch.Tensor:
    """Source index of each of n + p positions under numpy's end-only pad
    of width p: 'reflect' (the edge pixel not repeated, p < n) or
    'edge'."""
    i = torch.arange(n + p, device=device)
    if mode == "reflect":
        return torch.where(i >= n, 2 * (n - 1) - i, i)
    return i.clamp(max=n - 1)


def clahe(img01: torch.Tensor, clip_limit=0.01, ntiles_y: int = 8,
          ntiles_x: int = 8, nbins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization on [0,1] input, as
    the JAX package computes it (skimage.exposure.equalize_adapthist-style:
    per-tile clipped histogram -> redistributed CDF -> bilinear
    interpolation between tile mappings; skimage's exact kernel sizing and
    interpolation differ in minor details, which the port keeps)."""
    x = img01.to(torch.float32)
    dev = x.device
    H, W = x.shape
    th = -(-H // ntiles_y)
    tw = -(-W // ntiles_x)
    Hp, Wp = th * ntiles_y, tw * ntiles_x
    # numpy's reflect pad needs a width below the axis length (tiny crops
    # where th*ntiles overshoots several-fold); edge there, as JAX
    mode = "reflect" if (Hp - H) < H and (Wp - W) < W else "edge"
    x = x.index_select(0, _pad_index(H, Hp - H, mode, dev)).index_select(
        1, _pad_index(W, Wp - W, mode, dev))

    f32 = dict(dtype=torch.float32, device=dev)
    bins = (x * (nbins - 1)).to(torch.int32).clamp(0, nbins - 1).long()
    tile_id = ((torch.arange(Hp, device=dev) // th)[:, None] * ntiles_x
               + (torch.arange(Wp, device=dev) // tw)[None, :])
    n_tiles = ntiles_y * ntiles_x
    # counts of ones: exact in float32 whatever the order of the adds
    hist = torch.zeros(n_tiles * nbins, **f32).index_add_(
        0, (tile_id * nbins + bins).reshape(-1),
        torch.ones(Hp * Wp, **f32)).reshape(n_tiles, nbins)

    npx = torch.tensor(float(th * tw), **f32)
    limit = torch.clamp(torch.as_tensor(clip_limit, **f32) * npx, min=1.0)
    clipped = torch.minimum(hist, limit)
    excess = (hist - clipped).sum(dim=1, keepdim=True)
    clipped = clipped + excess / torch.tensor(float(nbins), **f32)
    cdf = torch.cumsum(clipped, dim=1)
    cdf = cdf / cdf[:, -1:]

    # bilinear interpolation between the 4 surrounding tile mappings
    def centres(n, t, nt):
        c = ((torch.arange(n, **f32) - torch.tensor((t - 1) / 2.0, **f32))
             / torch.tensor(float(t), **f32))
        lo = torch.floor(c).to(torch.int32).clamp(0, nt - 1)
        return lo.long(), (lo + 1).clamp(0, nt - 1).long(), (c - lo).clamp(0.0, 1.0)

    y0, y1, wy = centres(Hp, th, ntiles_y)
    x0, x1, wx = centres(Wp, tw, ntiles_x)
    wy, wx = wy[:, None], wx[None, :]

    def lookup(ty, tx):
        return cdf[ty[:, None] * ntiles_x + tx[None, :], bins]

    v00, v01 = lookup(y0, x0), lookup(y0, x1)
    v10, v11 = lookup(y1, x0), lookup(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return out[:H, :W]


# matplotlib 3.10.8's colormaps sampled as the JAX package samples them:
# ``plt.get_cmap(name)(np.linspace(0, 1, 256))[:, :3].astype(float32)``, one
# (256, 3) table per registered name, committed beside report/cmaps.py's
# uint8 tables (tests/test_torch_view.py regenerates them)
PSEUDO_LUT_TABLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "report",
    "_cmap_luts_f32.npz")
_PSEUDO_LUTS: Dict[str, np.ndarray] = {}
_PSEUDO_LOCK = threading.Lock()


def _pseudo_lut(cmap_name: str) -> np.ndarray:
    with _PSEUDO_LOCK:
        if not _PSEUDO_LUTS:
            with np.load(PSEUDO_LUT_TABLE) as z:
                _PSEUDO_LUTS.update({k: z[k] for k in z.files})
    lut = _PSEUDO_LUTS.get(cmap_name)
    if lut is None:
        raise ValueError(f"colormap {cmap_name!r} is not in the LUT table "
                         f"{PSEUDO_LUT_TABLE} (matplotlib 3.10.8's registered names)")
    return lut


def apply_pseudocolor(img01: np.ndarray, cmap_name: str) -> np.ndarray:
    """[0,1] grayscale -> RGB float32 via a matplotlib LUT (host; display
    only)."""
    lut = _pseudo_lut(cmap_name)
    idx = np.clip((np.asarray(img01) * 255).astype(np.int32), 0, 255)
    return lut[idx]
