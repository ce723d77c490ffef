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

Every function takes one image (H, W) or a stack (..., H, W), where the
JAX package runs the 2-D function under ``vmap``.  Each image of a stack is
labeled on its own: flat indices, the sentinel H*W, pointer jumps, sizes
and ranks are per image, and the operations are the same ones on a larger
tensor, with no loop over the images.  One convergence flag is read per
round for the whole stack: an image that has converged is at its fixpoint,
so further rounds leave it as it is, and every image's labels equal those
of labeling it alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..timing import NO_TIMER

_SEG = 1 << 32


def _neighbor_min(L: torch.Tensor, sentinel: int, connectivity: int) -> torch.Tensor:
    """Min label over the pixel's neighborhood (out-of-image = sentinel);
    *L* is (B, H, W)."""
    H, W = L.shape[-2:]
    P = F.pad(L, (1, 1, 1, 1), value=sentinel)
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    out = L
    for dy, dx in offsets:
        out = torch.minimum(out, P[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return out


def _run_min(L: torch.Tensor, fg: torch.Tensor, sentinel: int, axis: int) -> torch.Tensor:
    """Min-propagate labels within contiguous foreground runs along *axis*
    (1: rows, 2: columns of a (B, H, W) stack; segmented min-scan, forward
    + reverse)."""
    out = L
    for reverse in (False, True):
        x, f = (L.flip(axis), fg.flip(axis)) if reverse else (L, fg)
        prev = torch.zeros_like(f)
        if axis == 1:
            prev[:, 1:] = f[:, :-1]
        else:
            prev[:, :, 1:] = f[:, :, :-1]
        # a segment starts at every pixel but the second and later pixels
        # of a foreground run: background pixels are segments of their own
        seg = torch.cumsum(~(f & prev), axis)
        v = torch.cummin(x - seg * _SEG, axis).values + seg * _SEG
        out = torch.minimum(out, v.flip(axis) if reverse else v)
    return torch.where(fg, out, sentinel)


def _label_roots(fg: torch.Tensor, connectivity: int, timer) -> torch.Tensor:
    """int64 roots of a (B, H, W) bool stack (flat index, within its own
    image, of each component's first pixel; sentinel H*W on background)."""
    B, H, W = fg.shape
    sentinel = H * W
    idx = torch.arange(H * W, dtype=torch.int64, device=fg.device).reshape(H, W)
    L = torch.where(fg, idx, sentinel)
    rounds = 0
    while True:
        Ln = torch.where(fg, _neighbor_min(L, sentinel, connectivity), sentinel)
        Ln = _run_min(Ln, fg, sentinel, 2)
        Ln = _run_min(Ln, fg, sentinel, 1)
        flat = Ln.reshape(B, -1)
        ptr = flat.clamp(0, H * W - 1)
        Ln = torch.where(fg, torch.minimum(flat, flat.gather(1, ptr))
                         .reshape(B, H, W), sentinel)
        rounds += 1
        changed = bool((Ln != L).any())
        L = Ln
        if not changed:
            break
    timer.count("rounds", rounds)
    return L


def _stack(fg: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (B, H, W) bool."""
    return fg.to(torch.bool).reshape(-1, *fg.shape[-2:])


def label_roots(fg: torch.Tensor, connectivity: int = 1,
                timer=NO_TIMER) -> torch.Tensor:
    """(..., H, W) bool -> int32 of the same shape: for each foreground
    pixel, the flat index (within its image) of its component's first
    (raster-order) pixel; background = H*W."""
    return _label_roots(_stack(fg), connectivity, timer).to(torch.int32).reshape(
        fg.shape)


def _root_sizes(roots: torch.Tensor) -> torch.Tensor:
    """(..., H, W) roots -> (..., H*W + 1) pixel count per root flat-index
    of each image (index H*W = background)."""
    H, W = roots.shape[-2:]
    flat = roots.reshape(-1, H * W).to(torch.int64)
    B, n = flat.shape
    base = torch.arange(B, device=roots.device)[:, None] * (n + 1)
    sizes = torch.zeros(B * (n + 1), dtype=torch.int32, device=roots.device)
    sizes.index_add_(0, (flat + base).reshape(-1),
                     torch.ones(B * n, dtype=torch.int32, device=roots.device))
    return sizes.reshape(*roots.shape[:-2], n + 1)


def _sizes_at(sizes: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """``sizes[roots]`` image by image: (..., H*W + 1) looked up at
    (..., H, W) roots."""
    H, W = roots.shape[-2:]
    flat = roots.reshape(-1, H * W).to(torch.int64)
    return sizes.reshape(-1, H * W + 1).gather(1, flat).reshape(roots.shape)


def label(fg: torch.Tensor, connectivity: int = 2, max_labels: int = 1024,
          with_overflow: bool = False, timer=NO_TIMER):
    """skimage.measure.label parity: int32 labels 1..n in raster order of
    first pixels, 0 = background, for each image of (..., H, W).  Labels
    are exact for any component count; *max_labels* only sets the overflow
    flag (a bool tensor of the leading shape, 0-dim for one image)
    returned with ``with_overflow=True``."""
    f = _stack(fg)
    B, H, W = f.shape
    flat = _label_roots(f, connectivity, timer).reshape(B, -1)
    f = f.reshape(B, -1)
    idx = torch.arange(H * W, dtype=torch.int64, device=fg.device)
    rank = torch.cumsum((f & (flat == idx)).to(torch.int32), 1,
                        dtype=torch.int32)
    comp = rank.gather(1, flat.clamp(0, H * W - 1))
    lab = torch.where(f, comp, 0).reshape(fg.shape)
    if with_overflow:
        return lab, (rank[:, -1] > max_labels).reshape(fg.shape[:-2])
    return lab


def remove_small_objects(fg: torch.Tensor, min_size: int,
                         connectivity: int = 1, timer=NO_TIMER) -> torch.Tensor:
    """skimage.morphology.remove_small_objects parity (default 4-connected,
    strict ``< min_size`` removal), for each image of (..., H, W)."""
    f = _stack(fg)
    roots = _label_roots(f, connectivity, timer)
    keep = _sizes_at(_root_sizes(roots), roots) >= min_size
    return (f & keep).reshape(fg.shape)


def fill_holes(fg: torch.Tensor, timer=NO_TIMER) -> torch.Tensor:
    """scipy.ndimage.binary_fill_holes parity: background components not
    connected (4-conn) to the image border become foreground."""
    fg = fg.to(torch.bool)
    H, W = fg.shape
    bg_roots = _label_roots(~fg[None], 1, timer)[0]
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
    roots = _label_roots(fg[None], connectivity, timer)[0]
    sizes = _root_sizes(roots)
    sizes[H * W] = 0  # background doesn't compete
    best = torch.argmax(sizes)
    return (roots == best) & fg, sizes[best]
