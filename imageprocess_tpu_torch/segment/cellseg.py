"""Learned full-frame cell segmentation: tiled network inference (port of
``imageprocess_tpu/segment/cellseg.py``, for the bundled U-Net and for
Cellpose-SAM, ``models.cpsam``).

Per frame: 1/99-percentile stretch (bounds from a host u16 histogram for
integer-valued frames, a device sort otherwise; clamped to [0, 1] for the
U-Net, unclamped for Cellpose-SAM as Cellpose's ``normalize99``), a grid of
overlapping tiles, the network's forward over the tiles that hold
foreground plus one all-zero tile whose response stands in for every
culled background tile, feathered recomposition of the probability and
flow maps (:func:`frame_maps`), threshold, ``remove_small_objects``, flow
following (or the CCL with ``flow_follow=False``) and cv2
external-contour polygons.  Only the raw frame goes up and the label map
comes back.

The JAX module fuses the device work into one jitted program; here it is
two functions, :func:`forward_tiles` and :func:`postprocess`, so that both
packages' post-processes can be fed the same network output.  The JAX
module forwards a batch rounded up to a multiple of 16 tiles to spare XLA
recompiles; this one forwards exactly the kept tiles.  With ``mesh=`` the
tile batch is padded to a multiple of the mesh size and split over its
devices, one U-Net replica per device (:func:`forward_tiles_sharded`); the
frame's own work stays on *device*.

Host phases (``timing.HostPhases``, :func:`seg_phases`): ``seg_read`` (the
TIFF read, ``segment.auto``), ``seg_prepass`` (histogram, bounds, cull),
``seg_upload`` (upload, normalisation, tile cut), ``seg_forward``,
``seg_recompose`` and ``seg_fetch`` (the frame's one device-to-host wait);
counters ``seg_tiles``, ``seg_tokens`` and ``seg_bias_mb`` (a model's
``counts(n_tiles)``, where it has one), besides the ``PhaseTimer`` phases
of ``timer=``.
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..morphology import contours
from ..device import no_tf32, resolve_device
from ..morphology.ccl import label, remove_small_objects
from ..ops.percentile import masked_quantile
from ..timing import NO_TIMER, HostPhases
from .flows import flow_label

SEG_PHASES = ("seg_read", "seg_prepass", "seg_upload", "seg_forward", "seg_recompose",
              "seg_fetch")
SEG_COUNTERS = ("seg_tiles", "seg_tokens", "seg_bias_mb")


def seg_phases() -> HostPhases:
    """Host phases and counters of one segmentation call (a frame, or a
    ``roi-auto`` run), tagged ``[IP_TIMING:seg]``."""
    return HostPhases(SEG_PHASES, tag="[IP_TIMING:seg]", counters=SEG_COUNTERS)


def _host_stretch_lohi(
    img: np.ndarray,
) -> Optional[Tuple[float, float, np.ndarray]]:
    """(lo, hi, u16_frame): 1/99-percentile stretch bounds from a host u16
    histogram plus the uint16 view of the frame, or None when the frame
    isn't u16-valued (the device sort path then keeps exact generality).
    np.percentile-linear-exact, like the JAX function."""
    if img.dtype == np.uint16:
        iv = img
    else:
        if not np.isfinite(img).all():
            return None
        iv = img.astype(np.uint16)
        if not np.array_equal(iv.astype(img.dtype, copy=False), img):
            return None
    hist = native.u16_hist(iv)
    return (native.percentile_from_hist(hist, 1000),
            native.percentile_from_hist(hist, 99000), iv)


def tile_grid(H: int, W: int, tile: int, overlap: int
              ) -> Tuple[List[int], List[int]]:
    """Tile origins (ys, xs); the last tile of each axis ends at the frame's
    edge.  An overlap of half the tile or more is clamped to tile // 4
    (small checkpoints with the default overlap would get a stride <= 0)."""
    if 2 * overlap >= tile:
        overlap = tile // 4
    stride = tile - 2 * overlap
    ys = list(range(0, max(H - tile, 0) + 1, stride)) or [0]
    xs = list(range(0, max(W - tile, 0) + 1, stride)) or [0]
    if ys[-1] + tile < H:
        ys.append(H - tile)
    if xs[-1] + tile < W:
        xs.append(W - tile)
    return ys, xs


def keep_tiles(lohi, ys: Sequence[int], xs: Sequence[int], tile: int,
               cull_margin: float) -> np.ndarray:
    """Ids of the tiles to forward (ys outer, xs inner): those whose u16
    max lies above ``lo + cull_margin * (hi - lo)``, or every tile when
    culling is off (no host stretch bounds, ``cull_margin <= 0``, or a
    single tile).  Empty when no tile is above background."""
    T = len(ys) * len(xs)
    if lohi is None or cull_margin <= 0 or T <= 1:
        return np.arange(T)
    lo_f, hi_f, u16 = lohi
    den = 1e-6 if hi_f <= lo_f else hi_f - lo_f
    thr = lo_f + float(cull_margin) * den
    tmax = np.array([u16[y:y + tile, x0:x0 + tile].max()
                     for y in ys for x0 in xs], np.float64)
    return np.flatnonzero(tmax > thr)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of n + pad positions under numpy's 'reflect'
    padding at the end of an axis (edge pixel not repeated), any pad."""
    if n == 1:
        return torch.zeros(n + pad, dtype=torch.int64, device=device)
    i = torch.arange(n + pad, device=device) % (2 * n - 2)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def cut_tiles(x: torch.Tensor, ys: Sequence[int], xs: Sequence[int],
              tile: int) -> torch.Tensor:
    """(T, 1, tile, tile) tiles of the stretched frame, ys outer, xs inner;
    a frame smaller than the tile is reflect-padded at its end first."""
    H, W = x.shape
    if H < tile:
        x = x.index_select(0, _reflect_index(H, tile - H, x.device))
    if W < tile:
        x = x.index_select(1, _reflect_index(W, tile - W, x.device))
    return torch.stack([x[y:y + tile, x0:x0 + tile]
                        for y in ys for x0 in xs])[:, None]


def forward_tiles(model, tiles: torch.Tensor) -> torch.Tensor:
    """(n, 1, t, t) float32 tiles -> (n, C, t, t) float32 network output.
    An ``nn.Module`` is moved to the tiles' device; any other callable is
    called as it is."""
    if isinstance(model, torch.nn.Module):
        model.to(tiles.device)
    with torch.no_grad(), no_tf32():
        return model(tiles).to(torch.float32)


#: per model, its replicas on other devices: {model: {device: replica}}
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _replica(model, dev: torch.device):
    """*model* where its weights lie on *dev*, else its copy on *dev*,
    made once per device and cached for as long as the model lives."""
    if not isinstance(model, torch.nn.Module):
        return model
    p = next(model.parameters(), None)
    if p is None or p.device == dev:
        return model
    per_dev = _REPLICAS.setdefault(model, {})
    if dev not in per_dev:
        per_dev[dev] = copy.deepcopy(model).to(dev)
    return per_dev[dev]


def forward_tiles_sharded(model, tiles: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`forward_tiles` with the tile batch split over *mesh*: the
    batch is zero-padded to a multiple of the mesh size, each device
    forwards its contiguous block with its own replica (every block is
    enqueued before any output is gathered), and the outputs come back to
    the tiles' device in tile order.  Per-tile math does not depend on
    the batch, so the output is the single-device one."""
    from ..parallel.runner import shard_bounds

    t = tiles.shape[0]
    pad = (-t) % len(mesh.devices)
    if pad:
        tiles = torch.cat([tiles, tiles.new_zeros((pad,) + tiles.shape[1:])])
    outs = []
    for dev, (lo, hi) in zip(mesh.devices, shard_bounds(mesh, tiles.shape[0])):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(forward_tiles(_replica(model, dev),
                                      tiles[lo:hi].to(dev, non_blocking=True)))
    return torch.cat([o.to(tiles.device) for o in outs])[:t]


def _feather(tile: int, device) -> torch.Tensor:
    w = torch.arange(tile, device=device)
    wy = torch.minimum(w + 1, tile - w)
    return torch.minimum(wy[:, None], wy[None, :]).to(torch.float32)


def postprocess(
    out: torch.Tensor,
    keep: Optional[np.ndarray],
    *,
    ys: Sequence[int],
    xs: Sequence[int],
    tile: int,
    shape: Tuple[int, int],
    prob_threshold: float = 0.5,
    min_size_px: int = 100,
    max_labels: int = 1024,
    flow_follow: bool = True,
    timer=NO_TIMER,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Network output -> (label map, overflow flag), on *out*'s device:
    :func:`recompose`, then :func:`labels_from_maps`."""
    with timer.phase("recomposition"):
        maps = recompose(out, keep, ys=ys, xs=xs, tile=tile, shape=shape)
    return labels_from_maps(maps, prob_threshold=prob_threshold, min_size_px=min_size_px,
                            max_labels=max_labels, flow_follow=flow_follow, timer=timer)


def recompose(
    out: torch.Tensor,
    keep: Optional[np.ndarray],
    *,
    ys: Sequence[int],
    xs: Sequence[int],
    tile: int,
    shape: Tuple[int, int],
) -> torch.Tensor:
    """Network output -> (C, H, W) float32 maps on *out*'s device: the
    feathered blend of the tiles' sigmoid(channel 0) (the probability) and
    of their other channels (the y/x flows).

    *out* is (n, C, tile, tile) in tile order (ys outer, xs inner): every
    tile when *keep* is None, else the tiles of ascending ids *keep*
    followed by the all-zero tile's response, which every other tile gets.
    Channel 0 is the probability logit, 1..2 the y/x flows."""
    H, W = shape
    T = len(ys) * len(xs)
    if keep is not None:
        full_out = out[-1:].expand(T, *out.shape[1:]).clone()
        full_out[torch.as_tensor(keep, device=out.device)] = out[:-1]
        out = full_out
    n_ch = out.shape[1]
    wtile = _feather(tile, out.device)
    blend = torch.cat([torch.sigmoid(out[:, :1]), out[:, 1:]], 1) * wtile
    Hp, Wp = max(H, tile), max(W, tile)
    acc = torch.zeros((n_ch, Hp, Wp), dtype=torch.float32, device=out.device)
    wacc = torch.zeros((Hp, Wp), dtype=torch.float32, device=out.device)
    # the JAX module's order of float additions: ys outer, xs inner
    k = 0
    for y in ys:
        for x0 in xs:
            acc[:, y:y + tile, x0:x0 + tile] += blend[k]
            wacc[y:y + tile, x0:x0 + tile] += wtile
            k += 1
    full = acc / wacc.clamp(min=1e-6)
    return full[:, :H, :W]


def labels_from_maps(
    maps: torch.Tensor,
    *,
    prob_threshold: float = 0.5,
    min_size_px: int = 100,
    max_labels: int = 1024,
    flow_follow: bool = True,
    timer=NO_TIMER,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, H, W) maps of :func:`recompose` -> (label map, overflow flag), on
    their device: threshold of the probability, small-object removal,
    flow following (or the CCL).  The label map is uint16 when
    ``max_labels <= 0xFFFF``, else int32."""
    bw = maps[0] > prob_threshold
    if min_size_px > 0:
        with timer.phase("remove_small_objects"):
            bw = remove_small_objects(bw, min_size_px, connectivity=1,
                                      timer=timer)
    if flow_follow and maps.shape[0] >= 3:
        lab, over = flow_label(bw, maps[1:3].permute(1, 2, 0),
                               max_labels=max_labels, with_overflow=True,
                               timer=timer)
    else:
        with timer.phase("ccl"):
            lab, over = label(bw, connectivity=2, max_labels=max_labels,
                              with_overflow=True, timer=timer)
    if max_labels <= 0xFFFF:
        lab = lab.to(torch.uint16)   # halves the label map's D2H copy
    return lab, over


def _normalized(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                clamp: bool) -> torch.Tensor:
    """(x - lo) / (hi - lo), the reference's 1e-6 for a degenerate range,
    clipped to [0, 1] when *clamp*."""
    den = torch.where(hi <= lo, torch.full_like(lo, 1e-6), hi - lo)
    x = (x - lo) / den
    return x.clamp(0.0, 1.0) if clamp else x


def frame_tiles(
    img: np.ndarray,
    tile: int = 256,
    overlap: int = 32,
    cull_margin: float = 0.05,
    *,
    clamp: bool = True,
    device="cuda",
    timer=NO_TIMER,
    phases=None,
):
    """Host prepass, upload, 1/99-percentile stretch (clipped to [0, 1]
    when *clamp*) and tile cut of one frame -> (tiles to forward (n, 1,
    tile, tile) float32 on *device*, keep, ys, xs), with *keep* as
    :func:`postprocess` takes it; None when the cull prepass finds no tile
    above background."""
    dev = resolve_device(device)
    phases = seg_phases() if phases is None else phases
    H, W = img.shape
    ys, xs = tile_grid(H, W, tile, overlap)
    img_np = np.asarray(img)
    with timer.phase("host_prepass"), phases("seg_prepass"):
        lohi = _host_stretch_lohi(img_np)
        kept = keep_tiles(lohi, ys, xs, tile, cull_margin)
    if kept.size == 0:
        return None              # nothing above background anywhere
    keep = kept if kept.size < len(ys) * len(xs) else None
    with phases("seg_upload"):
        with timer.phase("upload_stretch"):
            if lohi is not None:
                # raw u16 up (half the bytes of f32), cast on the device: exact
                x = torch.from_numpy(lohi[2]).to(dev).to(torch.float32)
                lo = torch.tensor(lohi[0], dtype=torch.float32, device=dev)
                hi = torch.tensor(lohi[1], dtype=torch.float32, device=dev)
            else:
                x = torch.from_numpy(np.ascontiguousarray(img_np, np.float32)).to(dev)
                finite = torch.isfinite(x)
                lo = masked_quantile(x, finite, 1000)
                hi = masked_quantile(x, finite, 99000)
            x = _normalized(x, lo, hi, clamp)
        with timer.phase("tile_cut"):
            tiles = cut_tiles(x, ys, xs, tile)
            if keep is not None:
                tiles = torch.cat([tiles[torch.as_tensor(keep, device=dev)],
                                   torch.zeros_like(tiles[:1])])
    return tiles, keep, ys, xs


def frame_maps(
    img: np.ndarray,
    model,
    tile: int = 256,
    overlap: int = 32,
    cull_margin: float = 0.05,
    *,
    mesh=None,
    device="cuda",
    timer=NO_TIMER,
    phases=None,
) -> Optional[torch.Tensor]:
    """Full frame -> its stitched network maps, (3, H, W) float32 on
    *device*: the probability, the y flow and the x flow (:func:`recompose`
    of :func:`forward_tiles` over :func:`frame_tiles`); None when the cull
    prepass finds no tile above background.  *model* maps (n, 1, t, t)
    float32 tiles to (n, C, t, t) outputs, channel 0 the probability
    logit (a ``UNet`` from ``models.checkpoint.load_unet``, or the
    ``TileMaps`` of ``load_cpsam``).  The stretch is clipped to [0, 1]
    unless the model's ``clamp`` is False (Cellpose-SAM).  With a *mesh*
    the forward's tile batch is split over its devices.  Nothing is
    fetched: the maps stay on the device."""
    phases = seg_phases() if phases is None else phases
    cut = frame_tiles(img, tile, overlap, cull_margin, clamp=getattr(model, "clamp", True),
                      device=device, timer=timer, phases=phases)
    if cut is None:
        return None
    tiles, keep, ys, xs = cut
    n = tiles.shape[0]
    with timer.phase("forward"), phases("seg_forward"):
        out = (forward_tiles(model, tiles) if mesh is None
               else forward_tiles_sharded(model, tiles, mesh))
        timer.count("tiles", n)
    counts = getattr(model, "counts", None)
    phases.count({"seg_tiles": n, **(counts(n) if counts is not None else {})})
    with timer.phase("recomposition"), phases("seg_recompose"):
        return recompose(out, keep, ys=ys, xs=xs, tile=tile, shape=img.shape)


def label_frame_unet(
    img: np.ndarray,
    model,
    tile: int = 256,
    overlap: int = 32,
    prob_threshold: float = 0.5,
    min_size_px: int = 100,
    max_labels: int = 1024,
    flow_follow: bool = True,
    cull_margin: float = 0.05,
    *,
    mesh=None,
    device="cuda",
    timer=NO_TIMER,
    phases=None,
) -> Optional[np.ndarray]:
    """Full frame -> host (H, W) instance label map: :func:`frame_maps`,
    then :func:`labels_from_maps`; None when the cull prepass finds no
    tile above background (the JAX function then returns no polygons).
    Raises ValueError when more than *max_labels* components were
    found."""
    phases = seg_phases() if phases is None else phases
    maps = frame_maps(img, model, tile, overlap, cull_margin, mesh=mesh, device=device,
                      timer=timer, phases=phases)
    if maps is None:
        return None
    lab, over = labels_from_maps(
        maps, prob_threshold=float(prob_threshold), min_size_px=int(min_size_px),
        max_labels=int(max_labels), flow_follow=bool(flow_follow), timer=timer)
    with timer.phase("d2h"), phases("seg_fetch"):
        lab_np = lab.cpu().numpy()
        over = bool(over)
    if over:
        raise ValueError(
            f"component count exceeded max_labels={max_labels} — downstream "
            "per-label buffers are sized by it; raise AutoSegConfig.max_labels")
    return lab_np


def segment_frame_unet(
    img: np.ndarray,
    model,
    tile: int = 256,
    overlap: int = 32,
    prob_threshold: float = 0.5,
    min_size_px: int = 100,
    max_labels: int = 1024,
    min_poly_area: float = 20.0,
    flow_follow: bool = True,
    mesh=None,
    cull_margin: float = 0.05,
    *,
    device="cuda",
    timer=NO_TIMER,
    phases=None,
) -> List[np.ndarray]:
    """Full frame -> instance polygons ([x, y] float arrays) via tiled
    network inference; the JAX function's arguments with *model* in place
    of (apply_fn, params).

    ``mesh``: optional ``parallel.runner.Mesh`` -- the tile batch is split
    across it (results identical to single-device).

    ``cull_margin``: tiles whose stretched max is <= this skip the forward
    (their response is the network's all-zero-tile response); 0 disables
    culling.  Only active on u16-valued frames."""
    labels = label_frame_unet(
        img, model, tile=tile, overlap=overlap, prob_threshold=prob_threshold,
        min_size_px=min_size_px, max_labels=max_labels,
        flow_follow=flow_follow, cull_margin=cull_margin, mesh=mesh,
        device=device, timer=timer, phases=phases)
    if labels is None:
        return []
    with timer.phase("polygons"):
        return contours.masks_to_polygons(labels, min_poly_area)
