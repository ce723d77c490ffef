"""Sort-free exact per-ROI statistics of u16 tiles, in plain PyTorch.

Port of ``imageprocess_tpu/ops/tilestats_u16.py``.  The three quantiles
need six exact order statistics of the raw u16 values; each is a 16-step
bisection on the value range, one masked compare-and-count per step over
all (tile, channel, quantile) lanes at once.  Background subtraction
(x - bg, optional clip at 0) is monotone, so the order statistics of the
corrected values are the corrected raw order statistics, and the
np.percentile interpolation runs after the transform.

This is the plain version of the hand kernel in
``kernels/tilestats_u16.cu``: the CPU path, and the reference that
``chip_smoke.py`` holds the kernel to on the card.  Tiles arrive as
``torch.uint16`` (compact transfer) and are cast to int32 here, since
PyTorch's uint16 arithmetic is thin.
"""

from __future__ import annotations

from typing import Dict

import torch

from .percentile import exact_quantile_pos

U16_MAX = 65535
P_MED1000 = 50000


def _order_stats_bisect(xi: torch.Tensor, mask: torch.Tensor,
                        ks: torch.Tensor) -> torch.Tensor:
    """Exact order statistics of masked u16 values by value-range bisection.

    xi:   (..., P) int32 in [0, 65535]
    mask: (..., P) bool
    ks:   (..., Q) int32 0-indexed positions (clipped by the caller to
          [0, n-1])
    returns (..., Q) int32: the (k+1)-th smallest masked value per lane
    (undefined where n == 0 — the caller guards).
    """
    lo = torch.zeros_like(ks)
    hi = torch.full_like(ks, U16_MAX)
    xe = xi.unsqueeze(-2)                                      # (..., 1, P)
    me = mask.unsqueeze(-2)
    for _ in range(16):
        mid = (lo + hi) >> 1                                   # (..., Q)
        le = me & (xe <= mid.unsqueeze(-1))                    # (..., Q, P)
        cnt = le.sum(dim=-1, dtype=torch.int32)
        ge = cnt >= ks + 1
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    return hi


def tile_stats_u16_batched(
    tiles: torch.Tensor,    # (B, N, C, t, t) uint16 RAW tile pixels
    masks: torch.Tensor,    # (B, N, t, t) bool (validity applied)
    bgs: torch.Tensor,      # (B, C) float32 background levels
    *,
    clip_neg: bool = True,
    p_lo1000: int = 5000,
    p_hi1000: int = 95000,
) -> Dict[str, torch.Tensor]:
    """:func:`tile_stats_u16` with the frame axis written out: every
    statistic comes back as (B, C, N)."""
    B, N, C, t, _ = tiles.shape
    xi = tiles.to(torch.int32)
    xf = xi.to(torch.float32) - bgs[:, None, :, None, None]
    if clip_neg:
        xf = torch.clamp(xf, min=0.0)
    m = masks[:, :, None]                                      # (B, N, 1, t, t)
    n = masks.sum(dim=(-2, -1), dtype=torch.int32)             # (B, N)
    n_nc = n[:, :, None].expand(B, N, C)
    nf = torch.clamp(n_nc.to(torch.float32), min=1.0)

    zero = torch.zeros((), dtype=torch.float32, device=tiles.device)
    inf = torch.tensor(float("inf"), device=tiles.device)
    total = torch.where(m, xf, zero).sum(dim=(-2, -1))         # (B, N, C)
    mean = total / nf
    var = torch.where(m, (xf - mean[..., None, None]) ** 2, zero).sum(
        dim=(-2, -1)) / nf
    vmin = torch.where(m, xf, inf).amin(dim=(-2, -1))
    vmax = torch.where(m, xf, -inf).amax(dim=(-2, -1))

    kgs = [exact_quantile_pos(n_nc, p) for p in (p_lo1000, P_MED1000, p_hi1000)]
    nm1 = torch.clamp(n_nc - 1, min=0)
    ks = torch.stack(
        [torch.minimum(torch.clamp(k, min=0), nm1) for k, _ in kgs]
        + [torch.minimum(torch.clamp(torch.minimum(k + 1, nm1), min=0), nm1)
           for k, _ in kgs],
        dim=-1,
    )                                                          # (B, N, C, 6)
    mflat = m.expand(B, N, C, t, t).reshape(B, N, C, t * t)
    os6 = _order_stats_bisect(xi.reshape(B, N, C, t * t), mflat, ks)

    osf = os6.to(torch.float32) - bgs[:, None, :, None]
    if clip_neg:
        osf = torch.clamp(osf, min=0.0)

    def interp(j, g):
        lo_v, hi_v = osf[..., j], osf[..., j + 3]
        return lo_v + g * (hi_v - lo_v)

    empty = n_nc == 0
    nan = torch.tensor(float("nan"), device=tiles.device)

    def nanify(v):
        return torch.where(empty, nan, v).transpose(1, 2)      # (B, C, N)

    return {
        "mean": nanify(mean),
        "median": nanify(interp(1, kgs[1][1])),
        "std": nanify(torch.sqrt(var)),
        "p5": nanify(interp(0, kgs[0][1])),
        "p95": nanify(interp(2, kgs[2][1])),
        "vmin": nanify(vmin),
        "vmax": nanify(vmax),
        "vsum": nanify(total),
        "npx": torch.where(empty, 0, n_nc).transpose(1, 2).to(torch.int32),
    }


def tile_stats_u16(
    tiles: torch.Tensor,    # (N, C, t, t) uint16 RAW tile pixels
    masks: torch.Tensor,    # (N, t, t) bool (validity applied)
    bgs: torch.Tensor,      # (C,) float32 background levels
    *,
    clip_neg: bool = True,
    p_lo1000: int = 5000,
    p_hi1000: int = 95000,
) -> Dict[str, torch.Tensor]:
    """All nine reference statistics of clip(x - bg)[mask] per (C, N),
    as the JAX ``tile_stats_u16`` computes them."""
    out = tile_stats_u16_batched(tiles[None], masks[None], bgs[None],
                                 clip_neg=clip_neg, p_lo1000=p_lo1000,
                                 p_hi1000=p_hi1000)
    return {k: v[0] for k, v in out.items()}
