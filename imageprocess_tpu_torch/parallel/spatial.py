"""Spatial sharding of one large frame over the mesh (port of
``imageprocess_tpu/parallel/spatial.py``).

A frame is split by rows into one block per shard of a ``runner.Mesh``
(:func:`shard_frame`, a :class:`RowShards`), each block on its shard's
device, and the frame-level ops run block by block.  JAX's collectives
become plain tensor moves between the shards' devices, driven by this one
process:

- ``psum``: the shards' partial results are moved to the first shard's
  device and summed there (histograms, sums, change flags, size tables);
- ``ppermute`` of boundary rows (the halo exchange): a shard's edge rows
  are copied to its neighbour's device;
- ``all_gather``: the shards' root sets are concatenated on the first
  shard's device.

So:

- global background percentile: exact for u16 data through per-shard
  65536-bin histograms summed once, then the exact order statistic with
  np.percentile interpolation -- no pixel leaves its shard;
- neighbourhood ops (square dilation / erosion, rim, annulus, closing):
  halo exchange of boundary rows, then the local window; the halo's fill is
  the identity of the window's reduction, so edge shards see the
  whole-frame op's border;
- connected components: each shard labels its block to a local fixpoint,
  then boundary label rows are exchanged and the local fixpoints rerun
  until no shard changes -- one flag read per outer round, as JAX's
  ``psum`` -- and the roots are ranked over the union of every shard's
  root set (raster order, the whole-frame ``morphology.ccl.label``
  numbering, bit for bit).

Every ``sharded_*`` function returns a function of a frame: a
:class:`RowShards` or a whole (H, W) array or tensor, which it shards
first; H must be a multiple of the mesh size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..morphology.binary import binary_dilation, binary_erosion, disk
from ..morphology.ccl import _neighbor_min, _run_min
from ..morphology.edt import clamped_sq_edt
from ..ops.percentile import exact_quantile_pos
from .runner import to_shard

U16_BINS = 65536


class RowShards(tuple):
    """A frame split by rows: one block per shard, each on its shard's
    device, in row order.  ``np.asarray`` gives the whole frame."""

    def gather(self, device=None) -> torch.Tensor:
        """The whole frame on *device* (default: the first block's)."""
        dev = self[0].device if device is None else torch.device(device)
        if self[0].dtype == torch.uint16:   # u16 travels as int16 storage
            return torch.cat([to_shard(b, dev).view(torch.int16) for b in self]).view(
                torch.uint16)
        return torch.cat([b.to(dev) for b in self])

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def shard_frame(mesh, img) -> RowShards:
    """Place an (H, W) frame (numpy array or tensor) row-sharded over the
    mesh (H must divide)."""
    x = torch.from_numpy(np.ascontiguousarray(img)) if isinstance(img, np.ndarray) \
        else img
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"shard_frame: {x.shape[0]} rows do not divide over "
                         f"the {n} shards of the mesh")
    h = x.shape[0] // n
    return RowShards(to_shard(x[i * h:(i + 1) * h], d) for i, d in enumerate(mesh.devices))


def _shards(mesh, x) -> RowShards:
    """*x* as the mesh's row shards: a sequence of one block per shard
    (moved to its device), or a whole frame to shard."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh.devices):
            raise ValueError(f"{len(x)} blocks for a mesh of {len(mesh.devices)}")
        return RowShards(to_shard(b, d) for b, d in zip(x, mesh.devices))
    return shard_frame(mesh, x)


def _halo_exchange_rows(blocks, halo: int, fill):
    """Each block with *halo* rows from each neighbour appended.  Edge
    blocks (which have no neighbour on that side) get rows filled with
    *fill*, which must be the identity of the window reduction that will
    consume the halo (-inf for max/dilation, +inf for min/erosion, 0 for
    sum) -- the single-device op's border, whose implicit padding is that
    identity."""
    out = []
    n = len(blocks)
    for i, x in enumerate(blocks):
        pad = torch.full((halo,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        top = blocks[i - 1][-halo:].to(x.device) if i > 0 else pad
        bot = blocks[i + 1][:halo].to(x.device) if i < n - 1 else pad
        out.append(torch.cat([top, x, bot]))
    return out


def _u16_hist(x: torch.Tensor, weights=None) -> torch.Tensor:
    """(65536,) int64 histogram of a u16-valued block, optionally
    weighted -- the shard-local half of every summed-histogram
    percentile here."""
    if x.is_floating_point():
        x = torch.nan_to_num(x.to(torch.float32), nan=0.0, posinf=U16_BINS - 1,
                             neginf=0.0)
    xi = x.to(torch.int64).clamp(0, U16_BINS - 1).reshape(-1)
    w = (torch.ones_like(xi) if weights is None
         else weights.reshape(-1).to(torch.int64))
    return torch.zeros(U16_BINS, dtype=torch.int64, device=x.device).index_add_(0, xi, w)


def _psum(parts) -> torch.Tensor:
    """The shards' partial tensors summed on the first shard's device."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _psum_hist_quantile(hists, p1000: int) -> torch.Tensor:
    """Exact global percentile from per-shard u16 histograms: one sum, then
    the (k, g) order-statistic interpolation (the value of the j-th order
    statistic is the first bin whose cdf exceeds j).  A 0-dim float32
    tensor on the first shard's device; NaN for an empty global
    histogram."""
    hist = _psum(hists)
    n = hist.sum()
    k, g = exact_quantile_pos(n, p1000)
    cdf = torch.cumsum(hist, 0)
    k = k.to(torch.int64)
    lo_v = torch.searchsorted(cdf, k, right=True).to(torch.float32)
    hi_v = torch.searchsorted(cdf, torch.minimum(k + 1, n - 1),
                              right=True).to(torch.float32)
    val = lo_v + g * (hi_v - lo_v)
    return torch.where(n > 0, val, torch.full_like(val, float("nan")))


def sharded_quantile_u16(mesh, p1000: int):
    """Exact global percentile (np.percentile linear rule) of a row-sharded
    u16-valued frame through summed histograms; a 0-dim float32 tensor."""
    def run(img):
        return _psum_hist_quantile([_u16_hist(b) for b in _shards(mesh, img)], p1000)

    return run


def sharded_bg_correct_u16(mesh, p1000: int, clip_neg: bool = True):
    """Row-sharded background subtraction: exact global percentile (summed
    histograms) then an elementwise correct on each shard -- the frame
    never leaves the shards."""
    def run(img):
        xs = _shards(mesh, img)
        b = _psum_hist_quantile([_u16_hist(x) for x in xs], p1000)
        out = []
        for x in xs:
            y = x.to(torch.float32) - b.to(x.device)
            out.append(torch.clamp(y, min=0.0) if clip_neg else y)
        return RowShards(out)

    return run


def _guard_halo(fn, mesh, halo: int, what: str):
    """Refuse windows whose halo exceeds the rows a shard holds: the
    exchange can only ship one neighbour's rows, so a too-large window
    would silently produce a wrong (row-shifted / truncated) result --
    surface it as an actionable error instead."""
    n = len(mesh.devices)

    def run(x, *a, **k):
        H = (sum(b.shape[0] for b in x) if isinstance(x, (list, tuple))
             else x.shape[0])
        rows = H // n
        if halo > rows:
            raise ValueError(
                f"{what}: window needs a {halo}-row halo but each of the "
                f"{n} shards holds only {rows} rows of the {H}-row "
                f"frame — use fewer devices or a single-device op")
        return fn(x, *a, **k)

    return run


def _window(mesh, k: int, dilate: bool, what: str):
    """Row-sharded (2k+1)^2 all-ones binary dilation (max, -inf fill) or
    erosion (min, +inf fill: out-of-frame acts as foreground)."""
    def run(x):
        xs = _shards(mesh, x)
        if k <= 0:
            return RowShards(b.to(torch.bool) for b in xs)
        sign = 1.0 if dilate else -1.0
        halo = _halo_exchange_rows([sign * b.to(torch.float32) for b in xs], k,
                                   -float("inf"))
        # max_pool2d pads the columns with -inf: the reduction's identity
        out = [sign * F.max_pool2d(h[None, None], 2 * k + 1, stride=1,
                                   padding=(0, k))[0, 0] > 0.5 for h in halo]
        return RowShards(out)

    return _guard_halo(run, mesh, k, what)


def sharded_square_dilation(mesh, k: int):
    """Row-sharded binary dilation with a (2k+1)^2 all-ones window: halo
    exchange + a local max window.  Matches
    ``morphology.binary.square_dilation`` on the whole frame."""
    return _window(mesh, k, True, "sharded_square_dilation")


def sharded_square_erosion(mesh, k: int):
    """Row-sharded binary erosion with a (2k+1)^2 all-ones window -- the
    min-window dual of :func:`sharded_square_dilation`.  The halo identity
    is +inf, so out-of-frame pixels act as foreground
    (``morphology.binary.binary_erosion(border_true=True)`` on the whole
    frame)."""
    return _window(mesh, k, False, "sharded_square_erosion")


def sharded_rim_mask(mesh, rim_px: int):
    """Row-sharded nuclear-envelope rim mask -- exact parity with the
    whole-frame ``morphology.edt.rim_mask``.

    The radius-clamped squared EDT only looks rim_px pixels away, so a
    rim_px-row halo makes each shard's local EDT exact.  The halo fill for
    edge shards is True (foreground): out-of-image is NOT background, and
    only background pixels act as distance sources."""
    def run(x):
        us = [b.to(torch.bool) for b in _shards(mesh, x)]
        if rim_px <= 0:
            return RowShards(us)
        halo = _halo_exchange_rows(us, rim_px, True)
        return RowShards(
            u & (clamped_sq_edt(h, rim_px)[rim_px:-rim_px] <= float(rim_px * rim_px))
            for u, h in zip(us, halo))

    return _guard_halo(run, mesh, rim_px, "sharded_rim_mask")


def sharded_annulus_mask(mesh, inner_px: int, outer_px: int):
    """Row-sharded square-dilation annulus -- parity with
    ``morphology.binary.annulus_mask``, one halo exchange sized for the
    OUTER window shared by both dilations."""
    inner_px = max(1, int(inner_px))
    outer_px = int(outer_px)
    if outer_px <= inner_px:
        outer_px = inner_px + 1
    o = outer_px

    def run(x):
        xs = [b.to(torch.float32) for b in _shards(mesh, x)]
        halo = _halo_exchange_rows(xs, o, -float("inf"))

        def dilate(xh, L, k):
            y = xh[o - k:o + L + k][None, None]
            return F.max_pool2d(y, 2 * k + 1, stride=1, padding=(0, k))[0, 0] > 0.5

        return RowShards(dilate(h, x.shape[0], outer_px) & ~dilate(h, x.shape[0], inner_px)
                         for x, h in zip(xs, halo))

    return _guard_halo(run, mesh, outer_px, "sharded_annulus_mask")


def _local_round(L, fg, top, bot, base: int, sentinel: int, connectivity: int):
    """One round of a shard's local propagation: neighbour min (with the
    halo rows), straight-run min scans within the block, two pointer jumps
    through labels homed in this shard.  Returns (L', changed flag)."""
    h, W = L.shape
    ext = torch.cat([top[None], L, bot[None]])
    Ln = torch.where(fg, _neighbor_min(ext[None], sentinel, connectivity)[0, 1:-1],
                     sentinel)
    Ln = _run_min(_run_min(Ln[None], fg[None], sentinel, 2), fg[None], sentinel, 1)[0]
    for _ in range(2):
        flat = Ln.reshape(-1)
        local = flat - base
        ours = (local >= 0) & (local < h * W)
        hop = torch.where(ours, flat[local.clamp(0, h * W - 1)], flat)
        Ln = torch.where(fg, torch.minimum(flat, hop).reshape(h, W), sentinel)
    return Ln, (Ln != L).any()


def _local_fix(Ls, fgs, tops, bots, bases, sentinel: int, connectivity: int):
    """Every shard's local fixpoint against fixed halo rows, the shards in
    lockstep (each round is enqueued on every still-active shard before
    any flag is read)."""
    Ls = list(Ls)
    active = list(range(len(Ls)))
    while active:
        flags = []
        for i in active:
            Ls[i], ch = _local_round(Ls[i], fgs[i], tops[i], bots[i], bases[i],
                                     sentinel, connectivity)
            flags.append(ch)
        active = [i for i, ch in zip(active, flags) if bool(ch)]
    return Ls


def _sharded_roots(fgs, connectivity: int):
    """The shard-local pieces of distributed CCL: every foreground pixel
    ends up labelled with its component's GLOBAL minimum flat index.

    Local propagation runs to a fixpoint with no exchange; an outer loop
    exchanges one boundary label row per neighbour and reruns the local
    fixpoints until no shard changed (one flag read per outer round) -- a
    component snaking across k shards converges in <= k rounds and the
    frame is never gathered.  Returns (roots int64 per shard, sentinel)."""
    n = len(fgs)
    h, W = fgs[0].shape
    sentinel = h * n * W
    bases = [i * h * W for i in range(n)]
    Ls = [torch.where(fg, base + torch.arange(h * W, dtype=torch.int64,
                                             device=fg.device).reshape(h, W),
                      sentinel)
          for fg, base in zip(fgs, bases)]
    sent = [torch.full((W,), sentinel, dtype=torch.int64, device=fg.device)
            for fg in fgs]
    Ls = _local_fix(Ls, fgs, sent, sent, bases, sentinel, connectivity)
    while True:
        ext = _halo_exchange_rows(Ls, 1, sentinel)
        Ln = _local_fix(Ls, fgs, [e[0] for e in ext], [e[-1] for e in ext], bases,
                        sentinel, connectivity)
        changed = _psum([(a != b).any().to(torch.int64) for a, b in zip(Ln, Ls)])
        Ls = Ln
        if not bool(changed > 0):
            return Ls, sentinel


def _rank_roots(Ls, fgs, max_labels: int):
    """Consecutive 1..K raster-order numbering (skimage parity): rank each
    root within the sorted union of every shard's root set (gathered on
    the first shard's device).  Returns (labels int32 per shard, overflow:
    the component count exceeds *max_labels*)."""
    dev0 = Ls[0].device
    ug = torch.unique(torch.cat([torch.unique(L[fg]).to(dev0)
                                 for L, fg in zip(Ls, fgs)]))
    labs = []
    for L, fg in zip(Ls, fgs):
        comp = torch.searchsorted(ug.to(L.device), L)
        labs.append(torch.where(fg, comp + 1, 0).to(torch.int32))
    return labs, ug.numel() > max_labels


def sharded_label(mesh, connectivity: int = 2, max_labels: int = 1024):
    """Row-sharded connected-component labelling -- EXACT skimage
    ``label`` numbering, bit-equal to the whole-frame
    ``morphology.ccl.label`` (components numbered 1..K in raster order of
    their first pixel).  More than *max_labels* components raise."""
    def run(fg):
        fgs = [b.to(torch.bool) for b in _shards(mesh, fg)]
        roots, _ = _sharded_roots(fgs, connectivity)
        lab, over = _rank_roots(roots, fgs, max_labels)
        if over:
            raise ValueError(
                f"sharded_label: component count exceeded max_labels="
                f"{max_labels}; labels would alias — raise max_labels")
        return RowShards(lab)

    return run


def sharded_remove_small(mesh, min_size: int, connectivity: int = 1,
                         max_labels: int = 1024):
    """Row-sharded ``remove_small_objects`` (skimage parity: strict
    ``< min_size`` removal, 4-connected default): distributed roots, the
    component sizes summed over the shards, a lookup per pixel.  More than
    *max_labels* components raise."""
    def run(fg):
        fgs = [b.to(torch.bool) for b in _shards(mesh, fg)]
        roots, _ = _sharded_roots(fgs, connectivity)
        dev0 = roots[0].device
        per = [torch.unique(L[f], return_counts=True) for L, f in zip(roots, fgs)]
        ug, inv = torch.unique(torch.cat([u.to(dev0) for u, _ in per]),
                               return_inverse=True)
        if ug.numel() > max_labels:
            raise ValueError(
                f"sharded_remove_small: component count exceeded max_labels="
                f"{max_labels}; sizes would alias — raise max_labels")
        sizes = torch.zeros(ug.numel() + 1, dtype=torch.int64, device=dev0)
        sizes.index_add_(0, inv, torch.cat([c.to(dev0) for _, c in per]))
        out = []
        for L, f in zip(roots, fgs):
            comp = torch.searchsorted(ug.to(L.device), L)   # background: K
            out.append(f & (sizes.to(L.device)[comp] >= min_size))
        return RowShards(out)

    return run


def sharded_closing_disk(mesh, radius: int):
    """Row-sharded skimage binary_closing with a disk SE (the FA chain's
    smoothing pass): one 2r-row halo serves both the dilation (out-of-
    frame = False) and the erosion (out-of-frame = True, skimage's
    border_true) -- after dilating the haloed block, the rows BEYOND the
    frame on edge shards are forced True so the erosion sees skimage's
    border convention; interior block edges only corrupt rows within r of
    the halo boundary, which the 2r crop discards."""
    if radius <= 0:
        return lambda x: RowShards(b.to(torch.bool) for b in _shards(mesh, x))
    se = disk(radius)
    r2 = 2 * radius

    def run(x):
        xs = [b.to(torch.bool) for b in _shards(mesh, x)]
        out = []
        for i, (b, xh) in enumerate(zip(xs, _halo_exchange_rows(xs, r2, False))):
            h = b.shape[0]
            d = binary_dilation(xh, se)
            if i == 0:
                d[:r2] = True
            if i == len(xs) - 1:
                d[r2 + h:] = True
            out.append(binary_erosion(d, se, True)[r2:r2 + h])
        return RowShards(out)

    return _guard_halo(run, mesh, r2, "sharded_closing_disk")


def sharded_fa_stats(mesh):
    """Row-sharded FA global statistics (FA_Analyzer.py:624-626
    semantics): whole-image nan-mean / nan-std for the threshold,
    background = exact p1 of the GLOBAL ``img[::10, ::10]`` subsample --
    summed partial sums and a summed histogram, the frame never leaves the
    shards.  The sums are float64 partials, summed in float64 and rounded
    once, as ``pipelines.fa`` takes the whole frame's.  Input must be
    u16-integral-valued (microscopy frames are).  Returns floats (mean,
    std, bg)."""
    def run(img):
        xs = _shards(mesh, img)
        xf = [b.to(torch.float32) for b in xs]
        fin = [torch.isfinite(x) for x in xf]
        n = torch.clamp(_psum([f.sum() for f in fin]).to(torch.float32), min=1.0)
        zero = torch.zeros((), dtype=torch.float32)
        m = _psum([torch.where(f, x, zero.to(x.device)).sum(dtype=torch.float64)
                   for x, f in zip(xf, fin)]).to(torch.float32) / n
        var = _psum([torch.where(f, (x - m.to(x.device)) ** 2, zero.to(x.device))
                     .sum(dtype=torch.float64)
                     for x, f in zip(xf, fin)]).to(torch.float32) / n
        hists, row0 = [], 0
        for b, f in zip(xs, fin):
            h, W = b.shape
            rows = torch.arange(row0, row0 + h, device=b.device) % 10 == 0
            cols = torch.arange(W, device=b.device) % 10 == 0
            hists.append(_u16_hist(b, weights=rows[:, None] & cols[None, :] & f))
            row0 += h
        bg = _psum_hist_quantile(hists, 1000)
        return float(m), float(torch.sqrt(var)), float(bg)

    return run


def sharded_fa_segment(mesh, alpha: float, min_px: float, close_radius: int,
                       max_labels: int = 1024):
    """The FA segmentation chain (threshold mu + alpha*sigma inside the
    cell mask -> remove_small_objects -> binary_closing(disk) -> label,
    src/INT/FA_Analyzer.py:123-195) on a row-sharded frame, composed from
    the sharded primitives.  Returns (labels, threshold, bg)."""
    stats = sharded_fa_stats(mesh)
    rm = sharded_remove_small(mesh, int(np.ceil(min_px)), 1, max_labels)
    close = sharded_closing_disk(mesh, close_radius)
    lab = sharded_label(mesh, 2, max_labels)

    def run(img, roi_mask):
        xs, rois = _shards(mesh, img), _shards(mesh, roi_mask)
        mu, sigma, bg = stats(xs)
        thr = mu + alpha * sigma
        bw = [(x.to(torch.float32) > torch.tensor(thr, dtype=torch.float32))
              & r.to(torch.bool) for x, r in zip(xs, rois)]
        return lab(close(rm(bw))), thr, bg

    return run
