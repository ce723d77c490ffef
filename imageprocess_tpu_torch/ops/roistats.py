"""ROI-local (tiled) per-ROI statistics.

Port of ``imageprocess_tpu/ops/roistats.py``: the host helpers that size,
place and gather each ROI's square tile (numpy, unchanged);
``roi_stats_tiled``, the statistics of bbox tiles sliced out of float
frames on the device; and ``tile_stats_from_gathered``, the per-frame
statistics of host-gathered raw tiles with a host-computed background.
Each tile covers its polygon's image-clipped bbox, and the rasterizer is
shift-exact on the half-integer vertex lattice, so tile statistics equal
full-frame ones.

u16 tiles take the u16 statistics (``ops.tilestats_u16``); float tiles
take ``ops.roi_stats_kernel``: on CUDA tensors its hand kernel, on CPU
tensors its plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geom import polygon
from ..geom.rasterize import rasterize_polygons
from . import roi_stats_kernel as rsk
from .tilestats_u16 import tile_stats_u16


def choose_tile(
    polys, H: int, W: int, min_tile: int = 32, margin: int = 0
) -> Optional[int]:
    """Smallest multiple-of-16 tile covering every polygon's image-clipped
    bbox grown by *margin* (with a 1 px guard), clamped to the frame, or
    None if some ROI needs the full frame."""
    need = min_tile
    for p in polys:
        p = np.asarray(p)
        x0 = max(0.0, np.floor(p[:, 0].min()) - margin)
        x1 = min(float(W), np.ceil(p[:, 0].max()) + 1 + margin)
        y0 = max(0.0, np.floor(p[:, 1].min()) - margin)
        y1 = min(float(H), np.ceil(p[:, 1].max()) + 1 + margin)
        need = max(need, int(x1 - x0) + 2, int(y1 - y0) + 2)
    if need > min(H, W):
        return None
    tile = ((need + 15) // 16) * 16
    return min(tile, min(H, W))


def tile_offsets(polys, H: int, W: int, tile: int, margin: int = 0) -> np.ndarray:
    """(N, 2) int32 [row, col] tile origins placing each margin-grown bbox
    inside its tile, clamped to the image."""
    offs = np.zeros((len(polys), 2), np.int32)
    for i, p in enumerate(polys):
        p = np.asarray(p)
        y0 = int(max(0, np.floor(p[:, 1].min()) - margin))
        x0 = int(max(0, np.floor(p[:, 0].min()) - margin))
        offs[i, 0] = min(max(y0, 0), max(H - tile, 0))
        offs[i, 1] = min(max(x0, 0), max(W - tile, 0))
    return offs


def pad_local_polys(polys, offsets: np.ndarray, n_bucket: int, v_bucket: int):
    """Shift polygons into tile-local [x, y] coords and pad to
    (n_bucket, v_bucket, 2) float32 + validity flags."""
    pv = np.zeros((n_bucket, v_bucket, 2), np.float32)
    valid = np.zeros(n_bucket, bool)
    if len(polys):
        shift = np.asarray(offsets[: len(polys), ::-1], np.float32)
        pv[: len(polys)] = polygon.pad_polygons(
            [np.asarray(p, np.float32) - shift[i]
             for i, p in enumerate(polys)], v_bucket)
        valid[: len(polys)] = True
    offs_pad = np.zeros((n_bucket, 2), np.int32)
    offs_pad[: len(polys)] = offsets
    return pv, offs_pad, valid


def gather_tiles(imgs: np.ndarray, offsets: np.ndarray, n_bucket: int,
                 tile: int) -> np.ndarray:
    """Host-side tile gather: (N_valid tiles of (C, tile, tile)) padded to
    (n_bucket, C, tile, tile), dtype preserved (compact u16 transfer)."""
    C = imgs.shape[0]
    out = np.zeros((n_bucket, C, tile, tile), imgs.dtype)
    for i, (oy, ox) in enumerate(np.asarray(offsets, np.int64)):
        out[i] = imgs[:, oy:oy + tile, ox:ox + tile]
    return out


def roi_stat_rows(frames: torch.Tensor, masks: torch.Tensor,
                  offs: torch.Tensor) -> torch.Tensor:
    """(R, C, 9) float32 statistics of float tiles (``ops.roi_stats_kernel``
    form): the hand kernel for CUDA tensors, its plain version for CPU
    tensors."""
    if frames.device.type == "cpu":
        return rsk.roi_stat_rows_plain(frames, masks, offs)
    return rsk.roi_stat_rows(frames, masks, offs)


def roi_stats_tiled(
    imgs: torch.Tensor,         # (C, H, W) float32 (already bg-corrected)
    local_polys: torch.Tensor,  # (N, V, 2) float32, tile-local coords
    offsets: torch.Tensor,      # (N, 2) int32 [row, col]
    roi_valid: torch.Tensor,    # (N,) bool
    tile: int,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Per-(channel, ROI) stats + per-ROI pixel areas, computed on
    tile x tile bbox tiles of *imgs* (origins clamped into the frame).
    Returns (stats dict of (C, N), area_px (N,) int32)."""
    masks = rasterize_polygons(local_polys, (tile, tile)) & roi_valid[:, None, None]
    offs = torch.nn.functional.pad(offsets.to(torch.int32), (1, 0))
    rows = roi_stat_rows(imgs.to(torch.float32).contiguous()[None],
                         masks.contiguous(), offs.contiguous())
    return rsk.rows_to_stats(rows), masks.sum(dim=(1, 2), dtype=torch.int32)


def tile_stats_from_gathered(
    tiles: torch.Tensor,        # (N, C, t, t) RAW tile pixels
    local_polys: torch.Tensor,  # (N, V, 2) float32, tile-local coords
    roi_valid: torch.Tensor,    # (N,) bool
    bgs: torch.Tensor,          # (C,) float32 background levels
    *,
    clip_neg: bool = True,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Per-(channel, ROI) stats of host-gathered tiles with a
    host-computed background: clip(x - bg) over each mask.  uint16 tiles
    take the sort-free u16 statistics, other dtypes the float statistics.
    Returns (stats dict of (C, N), area_px (N,) int32)."""
    t = tiles.shape[-1]
    masks = rasterize_polygons(local_polys, (t, t)) & roi_valid[:, None, None]
    area = masks.sum(dim=(1, 2), dtype=torch.int32)
    if tiles.dtype == torch.uint16:
        return tile_stats_u16(tiles, masks, bgs, clip_neg=clip_neg), area
    x = tiles.to(torch.float32) - bgs[None, :, None, None]
    if clip_neg:
        x = torch.clamp(x, min=0.0)
    rows = roi_stat_rows(x.contiguous(), masks.contiguous(),
                         rsk.stack_offsets(tiles.shape[0], tiles.device))
    return rsk.rows_to_stats(rows), area
