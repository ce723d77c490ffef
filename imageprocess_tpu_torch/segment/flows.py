"""Cellpose-style flow-following instance separation on the device (port of
``imageprocess_tpu/segment/flows.py``).

1. :func:`follow_flows` integrates every pixel's position along the
   bilinear-sampled flow field by scaling and squaring: the one-step
   displacement map is composed with itself ceil(log2(n_iter)) times (7
   for ``n_iter=120``), each composition one bilinear sample of the
   accumulated map.
2. :func:`flow_label` scatters the landing points of foreground pixels,
   drops sinks with fewer than ``min_landings`` landings, dilates the rest
   with ``disk(sink_radius)`` so each cell's convergence cloud becomes one
   blob, labels the blobs with the exact CCL and reads each pixel's id at
   its landing point.

The bilinear sample is a plain four-tap gather with the JAX function's
clamps and interpolation expression; the JAX module packs the 2x2 corner
neighborhood into channels only because gathers are slow on a TPU.  The
landings agree with JAX's to ~3e-5 px, not bit for bit (XLA's CPU compiler
contracts the interpolation differently), and round to the same pixels.
"""

from __future__ import annotations

import math

import torch

from ..morphology.binary import binary_dilation, disk
from ..morphology.ccl import label
from ..timing import NO_TIMER


def _bilinear(F: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W, C) field at float (y, x), edge-clamped."""
    H, W, C = F.shape
    y = y.clamp(0.0, H - 1.0)
    x = x.clamp(0.0, W - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    iy0 = y0.to(torch.int64)
    ix0 = x0.to(torch.int64)
    iy1 = (iy0 + 1).clamp(max=H - 1)
    ix1 = (ix0 + 1).clamp(max=W - 1)
    flat = F.reshape(H * W, C)
    v00 = flat[iy0 * W + ix0]
    v01 = flat[iy0 * W + ix1]
    v10 = flat[iy1 * W + ix0]
    v11 = flat[iy1 * W + ix1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def follow_flows(flows: torch.Tensor, n_iter: int = 120,
                 step: float = 1.0) -> torch.Tensor:
    """Integrate pixel positions along *flows* (H, W, 2 as [dy, dx], unit
    vectors toward each cell's center).  Returns (H, W, 2) float landing
    positions after >= ``n_iter`` Euler steps of size *step* px.

    ``n_iter=120`` (7 squarings) is what the JAX module requires: fewer
    squarings over-segment the generalist's dense domain (see its
    ``flow_label`` docstring)."""
    H, W = flows.shape[:2]
    dev = flows.device
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    # one Euler step, positions clamped like the sequential integrator
    dy = (yy + step * flows[..., 0]).clamp(0.0, H - 1.0) - yy
    dx = (xx + step * flows[..., 1]).clamp(0.0, W - 1.0) - xx
    n_sq = max(1, int(math.ceil(math.log2(max(2, n_iter)))))
    D = torch.stack([dy, dx], dim=-1)
    lo = torch.stack([-yy, -xx], dim=-1)
    hi = torch.stack([H - 1.0 - yy, W - 1.0 - xx], dim=-1)
    for _ in range(n_sq):
        ty = yy + D[..., 0]
        tx = xx + D[..., 1]
        D = torch.minimum(torch.maximum(D + _bilinear(D, ty, tx), lo), hi)
    return torch.stack([yy + D[..., 0], xx + D[..., 1]], dim=-1)


def flow_label(
    fg: torch.Tensor,            # (H, W) bool foreground (already cleaned)
    flows: torch.Tensor,         # (H, W, 2) [dy, dx]
    *,
    n_iter: int = 120,
    sink_radius: int = 5,
    max_labels: int = 1024,
    min_landings: int = 3,
    with_overflow: bool = False,
    timer=NO_TIMER,
):
    """Instance labels (int32) from flow convergence: pixels that land in
    the same (dilated) sink blob share an id, numbered like the CCL's
    raster order of the sink blobs.  With ``with_overflow=True`` also the
    0-dim bool flag "more than *max_labels* sink blobs"."""
    H, W = fg.shape
    fg = fg.to(torch.bool)
    with timer.phase("follow_flows"):
        land = follow_flows(flows, n_iter=n_iter)
    with timer.phase("flow_label.histogram"):
        ly = torch.round(land[..., 0]).to(torch.int64)
        lx = torch.round(land[..., 1]).to(torch.int64)
        # landing histogram of FOREGROUND pixels only
        hist = torch.zeros(H * W, dtype=torch.int32, device=fg.device).index_add_(
            0, (ly * W + lx).reshape(-1), fg.reshape(-1).to(torch.int32))
        sinks = (hist >= min_landings).reshape(H, W)
    if sink_radius > 0:
        with timer.phase("flow_label.dilation"):
            sinks = binary_dilation(sinks, disk(sink_radius))
    with timer.phase("flow_label.ccl"):
        sink_lab, over = label(sinks, connectivity=2, max_labels=max_labels,
                               with_overflow=True, timer=timer)
    with timer.phase("flow_label.readback"):
        out = torch.where(fg, sink_lab[ly, lx], 0)
    if with_overflow:
        return out, over
    return out
