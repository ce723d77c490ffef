"""Connected-component labeling on the device (port of
``imageprocess_tpu/morphology/ccl.py``).

Same algorithm and the same fixpoint as the JAX module: every foreground
pixel starts labeled with its own flat index; each round takes the min
over its (4/8-) neighborhood, floods contiguous straight runs along both
axes (segmented min-scans) and path-compresses once (``L <- L[L]``).  The
fixpoint label of a component is its minimum flat index, its first pixel
in raster order, so compacting the roots by rank gives skimage/scipy label
numbering exactly, and labels are bit-equal to the JAX functions.

The segmented run-scan, an associative scan in JAX, is one ``cummin`` per
direction here: with ``seg`` the running count of segment starts along the
axis, the key ``L - seg * 2**32`` is smaller in every later segment than
in any earlier one (labels are below 2**32), so a plain cumulative min of
the key never carries a value across a segment start.

JAX's ``while_loop`` becomes a Python loop whose convergence test reads
one flag from the device per round; ``timer.count("rounds", n)`` records
the number of rounds taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..timing import NO_TIMER

_SEG = 1 << 32


def _neighbor_min(L: torch.Tensor, sentinel: int, connectivity: int) -> torch.Tensor:
    """Min label over the pixel's neighborhood (out-of-image = sentinel)."""
    H, W = L.shape
    P = F.pad(L[None, None], (1, 1, 1, 1), value=sentinel)[0, 0]
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    out = L
    for dy, dx in offsets:
        out = torch.minimum(out, P[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return out


def _run_min(L: torch.Tensor, fg: torch.Tensor, sentinel: int, axis: int) -> torch.Tensor:
    """Min-propagate labels within contiguous foreground runs along *axis*
    (segmented min-scan, forward + reverse)."""
    out = L
    for reverse in (False, True):
        x, f = (L.flip(axis), fg.flip(axis)) if reverse else (L, fg)
        prev = torch.zeros_like(f)
        if axis == 0:
            prev[1:] = f[:-1]
        else:
            prev[:, 1:] = f[:, :-1]
        # a segment starts at every pixel but the second and later pixels
        # of a foreground run: background pixels are segments of their own
        seg = torch.cumsum(~(f & prev), axis)
        v = torch.cummin(x - seg * _SEG, axis).values + seg * _SEG
        out = torch.minimum(out, v.flip(axis) if reverse else v)
    return torch.where(fg, out, sentinel)


def _label_roots(fg: torch.Tensor, connectivity: int, timer) -> torch.Tensor:
    """int64 roots (flat index of each component's first pixel, sentinel
    H*W on background)."""
    H, W = fg.shape
    sentinel = H * W
    idx = torch.arange(H * W, dtype=torch.int64, device=fg.device).reshape(H, W)
    L = torch.where(fg, idx, sentinel)
    rounds = 0
    while True:
        Ln = torch.where(fg, _neighbor_min(L, sentinel, connectivity), sentinel)
        Ln = _run_min(Ln, fg, sentinel, 1)
        Ln = _run_min(Ln, fg, sentinel, 0)
        flat = Ln.reshape(-1)
        ptr = flat.clamp(0, H * W - 1)
        Ln = torch.where(fg, torch.minimum(flat, flat[ptr]).reshape(H, W),
                         sentinel)
        rounds += 1
        changed = bool((Ln != L).any())
        L = Ln
        if not changed:
            break
    timer.count("rounds", rounds)
    return L


def label_roots(fg: torch.Tensor, connectivity: int = 1,
                timer=NO_TIMER) -> torch.Tensor:
    """(H, W) bool -> (H, W) int32: for each foreground pixel, the flat index
    of its component's first (raster-order) pixel; background = H*W."""
    return _label_roots(fg.to(torch.bool), connectivity, timer).to(torch.int32)


def _root_sizes(roots: torch.Tensor) -> torch.Tensor:
    """(H*W + 1,) pixel count per root flat-index (index H*W = background)."""
    n = roots.numel()
    return torch.zeros(n + 1, dtype=torch.int32, device=roots.device).index_add_(
        0, roots.reshape(-1), torch.ones(n, dtype=torch.int32, device=roots.device))


def label(fg: torch.Tensor, connectivity: int = 2, max_labels: int = 1024,
          with_overflow: bool = False, timer=NO_TIMER):
    """skimage.measure.label parity: int32 labels 1..n in raster order of
    first pixels, 0 = background.  Labels are exact for any component
    count; *max_labels* only sets the overflow flag (a 0-dim bool tensor)
    returned with ``with_overflow=True``."""
    fg = fg.to(torch.bool)
    H, W = fg.shape
    flat = _label_roots(fg, connectivity, timer).reshape(-1)
    f = fg.reshape(-1)
    idx = torch.arange(H * W, dtype=torch.int64, device=fg.device)
    rank = torch.cumsum((f & (flat == idx)).to(torch.int32), 0,
                        dtype=torch.int32)
    comp = rank[flat.clamp(0, H * W - 1)]
    lab = torch.where(f, comp, 0).reshape(H, W)
    if with_overflow:
        return lab, rank[-1] > max_labels
    return lab


def remove_small_objects(fg: torch.Tensor, min_size: int,
                         connectivity: int = 1, timer=NO_TIMER) -> torch.Tensor:
    """skimage.morphology.remove_small_objects parity (default 4-connected,
    strict ``< min_size`` removal)."""
    fg = fg.to(torch.bool)
    roots = _label_roots(fg, connectivity, timer)
    keep = _root_sizes(roots)[roots.reshape(-1)].reshape(fg.shape) >= min_size
    return fg & keep


def fill_holes(fg: torch.Tensor, timer=NO_TIMER) -> torch.Tensor:
    """scipy.ndimage.binary_fill_holes parity: background components not
    connected (4-conn) to the image border become foreground."""
    fg = fg.to(torch.bool)
    H, W = fg.shape
    bg_roots = _label_roots(~fg, 1, timer)
    border = torch.zeros((H, W), dtype=torch.bool, device=fg.device)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True
    touched = _root_sizes(torch.where(border & ~fg, bg_roots, H * W))
    reachable = touched[bg_roots.reshape(-1)].reshape(H, W) > 0
    return fg | (~fg & ~reachable)


def largest_component(fg: torch.Tensor, connectivity: int = 1, timer=NO_TIMER):
    """(mask of the largest component, its size as a 0-dim int32 tensor).
    Ties break to the component whose first pixel comes first in raster
    order — matching ``np.argmax`` over scipy.ndimage label sizes
    (src/roi_manual_drawer.py:391-394)."""
    fg = fg.to(torch.bool)
    H, W = fg.shape
    roots = _label_roots(fg, connectivity, timer)
    sizes = _root_sizes(roots)
    sizes[H * W] = 0  # background doesn't compete
    best = torch.argmax(sizes)
    return (roots == best) & fg, sizes[best]
