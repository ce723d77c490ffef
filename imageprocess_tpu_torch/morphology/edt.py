"""Radius-clamped Euclidean distance transform in plain PyTorch.

Port of ``imageprocess_tpu/morphology/edt.py``.  The rim-FRET pipeline
needs the EDT only for the nuclear-envelope rim mask,
``rim = (EDT(union) > 0) & (EDT(union) <= rim_px)`` with rim_px <= ~10
(the Nesprin2 FRET script of the reference, :409-414).

So the squared distance to the nearest background pixel is computed
exactly wherever it is <= r^2: dy^2 + dx^2 is additively separable over a
(2r+1)^2 window, so the min-convolution splits into a vertical and a
horizontal pass of 2r+1 shifted minima each.  A background pixel outside
the window is farther than r, so the clamp loses nothing.  Out-of-image is
NOT background (scipy computes distances within the array only): a shift
takes nothing from outside the frame, as if it held +inf.

Every value is a small integer or +inf in float32, so the result is
bit-equal to the JAX function's and, inside r, to
``scipy.ndimage.distance_transform_edt`` squared.
"""

from __future__ import annotations

import torch


def _axis_min_pass(d: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """min over offsets o in [-r, r] of (d shifted by o along axis) + o^2;
    the shifts are slices, so nothing comes in from outside the frame."""
    n = d.shape[axis]
    out = d.clone()  # o = 0 term
    for o in range(1, min(r, n - 1) + 1):
        sq = float(o * o)
        lo = out.narrow(axis, o, n - o)          # takes from index i - o
        torch.minimum(lo, d.narrow(axis, 0, n - o) + sq, out=lo)
        hi = out.narrow(axis, 0, n - o)          # takes from index i + o
        torch.minimum(hi, d.narrow(axis, o, n - o) + sq, out=hi)
    return out


def clamped_sq_edt(fg: torch.Tensor, r: int) -> torch.Tensor:
    """Squared distance from each pixel of (H, W) bool *fg* to its nearest
    False pixel, exact wherever <= r*r; larger distances return > r*r
    (possibly +inf)."""
    d0 = torch.zeros(fg.shape, dtype=torch.float32, device=fg.device)
    d0.masked_fill_(fg.to(torch.bool), float("inf"))
    return _axis_min_pass(_axis_min_pass(d0, r, 0), r, 1)


def rim_mask(union: torch.Tensor, rim_px: int) -> torch.Tensor:
    """``make_inside_rim_mask`` parity (the Nesprin2 FRET script, :409-414):
    pixels inside the union whose distance to the outside is in
    (0, rim_px]."""
    union = union.to(torch.bool)
    if rim_px <= 0:
        return union
    return union & (clamped_sq_edt(union, rim_px) <= float(rim_px * rim_px))
