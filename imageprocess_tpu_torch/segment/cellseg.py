"""Learned full-frame cell segmentation: tiled U-Net inference (port of
``imageprocess_tpu/segment/cellseg.py``).

Per frame: 1/99-percentile stretch (bounds from a host u16 histogram for
integer-valued frames, a device sort otherwise), a grid of overlapping
tiles, the U-Net forward over the tiles that hold foreground plus one
all-zero tile whose response stands in for every culled background tile,
feathered recomposition of the probability and flow maps, threshold,
``remove_small_objects``, flow following (or the CCL with
``flow_follow=False``) and cv2 external-contour polygons.  Only the raw
frame goes up and the label map comes back.

The JAX module fuses the device work into one jitted program; here it is
two functions, :func:`forward_tiles` and :func:`postprocess`, so that both
packages' post-processes can be fed the same network output.  The JAX
module forwards a batch rounded up to a multiple of 16 tiles to spare XLA
recompiles; this one forwards exactly the kept tiles.  With ``mesh=`` the
tile batch is padded to a multiple of the mesh size and split over its
devices, one U-Net replica per device (:func:`forward_tiles_sharded`); the
frame's own work stays on *device*.
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
from ..ops.view import stretch_view
from ..timing import NO_TIMER
from .flows import flow_label


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
    """Network output -> (label map, overflow flag), on *out*'s device.

    *out* is (n, C, tile, tile) in tile order (ys outer, xs inner): every
    tile when *keep* is None, else the tiles of ascending ids *keep*
    followed by the all-zero tile's response, which every other tile gets.
    Channel 0 is the probability logit, 1..2 the y/x flows.  The label map
    is uint16 when ``max_labels <= 0xFFFF``, else int32."""
    H, W = shape
    T = len(ys) * len(xs)
    with timer.phase("recomposition"):
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
        bw = full[0, :H, :W] > prob_threshold
    if min_size_px > 0:
        with timer.phase("remove_small_objects"):
            bw = remove_small_objects(bw, min_size_px, connectivity=1,
                                      timer=timer)
    if flow_follow and n_ch >= 3:
        lab, over = flow_label(bw, full[1:3, :H, :W].permute(1, 2, 0),
                               max_labels=max_labels, with_overflow=True,
                               timer=timer)
    else:
        with timer.phase("ccl"):
            lab, over = label(bw, connectivity=2, max_labels=max_labels,
                              with_overflow=True, timer=timer)
    if max_labels <= 0xFFFF:
        lab = lab.to(torch.uint16)   # halves the label map's D2H copy
    return lab, over


def frame_tiles(
    img: np.ndarray,
    tile: int = 256,
    overlap: int = 32,
    cull_margin: float = 0.05,
    *,
    device="cuda",
    timer=NO_TIMER,
):
    """Host prepass, upload, stretch and tile cut of one frame ->
    (tiles to forward (n, 1, tile, tile) float32 on *device*, keep, ys,
    xs), with *keep* as :func:`postprocess` takes it; None when the cull
    prepass finds no tile above background."""
    dev = resolve_device(device)
    H, W = img.shape
    ys, xs = tile_grid(H, W, tile, overlap)
    img_np = np.asarray(img)
    with timer.phase("host_prepass"):
        lohi = _host_stretch_lohi(img_np)
        kept = keep_tiles(lohi, ys, xs, tile, cull_margin)
    if kept.size == 0:
        return None              # nothing above background anywhere
    keep = kept if kept.size < len(ys) * len(xs) else None
    with timer.phase("upload_stretch"):
        if lohi is not None:
            # raw u16 up (half the bytes of f32), cast on the device: exact
            x = torch.from_numpy(lohi[2]).to(dev).to(torch.float32)
            lo = torch.tensor(lohi[0], dtype=torch.float32, device=dev)
            hi = torch.tensor(lohi[1], dtype=torch.float32, device=dev)
            den = torch.where(hi <= lo, torch.full_like(lo, 1e-6), hi - lo)
            x = ((x - lo) / den).clamp(0.0, 1.0)
        else:
            x = stretch_view(torch.from_numpy(
                np.ascontiguousarray(img_np, np.float32)).to(dev), 1000, 99000)
    with timer.phase("tile_cut"):
        tiles = cut_tiles(x, ys, xs, tile)
        if keep is not None:
            tiles = torch.cat([tiles[torch.as_tensor(keep, device=dev)],
                               torch.zeros_like(tiles[:1])])
    return tiles, keep, ys, xs


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
) -> Optional[np.ndarray]:
    """Full frame -> host (H, W) instance label map, or None when the cull
    prepass finds no tile above background (the JAX function then returns
    no polygons).  Raises ValueError when more than *max_labels*
    components were found.  *model* maps (n, 1, t, t) float32 tiles to
    (n, C, t, t) outputs (a ``UNet`` from ``models.checkpoint.load_unet``).
    With a *mesh* the forward's tile batch is split over its devices."""
    cut = frame_tiles(img, tile, overlap, cull_margin, device=device,
                      timer=timer)
    if cut is None:
        return None
    tiles, keep, ys, xs = cut
    with timer.phase("forward"):
        out = (forward_tiles(model, tiles) if mesh is None
               else forward_tiles_sharded(model, tiles, mesh))
        timer.count("tiles", tiles.shape[0])
    lab, over = postprocess(
        out, keep, ys=ys, xs=xs, tile=tile, shape=img.shape,
        prob_threshold=float(prob_threshold), min_size_px=int(min_size_px),
        max_labels=int(max_labels), flow_follow=bool(flow_follow), timer=timer)
    with timer.phase("d2h"):
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
) -> List[np.ndarray]:
    """Full frame -> instance polygons ([x, y] float arrays) via tiled U-Net
    inference; the JAX function's arguments with *model* in place of
    (apply_fn, params).

    ``mesh``: optional ``parallel.runner.Mesh`` -- the tile batch is split
    across it (results identical to single-device).

    ``cull_margin``: tiles whose stretched max is <= this skip the forward
    (their response is the network's all-zero-tile response); 0 disables
    culling.  Only active on u16-valued frames."""
    labels = label_frame_unet(
        img, model, tile=tile, overlap=overlap, prob_threshold=prob_threshold,
        min_size_px=min_size_px, max_labels=max_labels,
        flow_follow=flow_follow, cull_margin=cull_margin, mesh=mesh,
        device=device, timer=timer)
    if labels is None:
        return []
    with timer.phase("polygons"):
        return contours.masks_to_polygons(labels, min_poly_area)
