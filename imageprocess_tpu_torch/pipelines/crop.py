"""Per-ROI channel cropping and export (the reference's roi_channel_cropper).

Port of ``imageprocess_tpu/pipelines/crop.py``.  Reference semantics:
src/roi_channel_cropper.py ``run_crop`` (:778-989) -- bbox + max(10, 5%)
pad, percentile-cut normalization (``low_cut`` / ``100 - high_cut`` with a
min/max fallback), gamma ``x^(1/g)``, optional single-colour tint,
ROI-outside masking; PNG (fixed output size), normalized TIFF16 and
raw-value TIFF crops named ``{S}[_t]_roi{i}_ch{c}``.

Device part, plain PyTorch as it is XLA in the JAX package: one call per
frame (``crop_view_tiled``) cuts every selected ROI's square tile from the
frame, rasterizes the polygons on the tiles, takes the two masked
quantiles of each crop from one sort, and forms the clipped, gamma-mapped
view; one copy brings views, masks and flags back.  The host writes the
files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core import i18n, naming, roiio, tiffio
from ..device import resolve_device
from ..geom.polygon import pad_polygons
from ..geom.rasterize import rasterize_polygons
from ..ops.background import as_float32
from ..ops.percentile import p1000_of, quantile_from_sorted
from .intensity import to_device

t = i18n.t
ChannelGrammar = naming.ChannelGrammar

COLOR_MAP = {
    "Grayscale": None,
    "Cyan": (0.0, 1.0, 1.0),
    "Blue": (0.0, 0.0, 1.0),
    "Red": (1.0, 0.0, 0.0),
    "Yellow": (1.0, 1.0, 0.0),
    "Green": (0.0, 1.0, 0.0),
    "Magenta": (1.0, 0.0, 1.0),
}


@dataclass
class CropConfig:
    """The JAX package's ``CropConfig``, field for field (names and
    defaults)."""

    channel: int = 1
    timelapse: bool = False
    color: str = "Grayscale"
    gamma: float = 1.0
    low_cut: float = 0.5        # lo = percentile(vals, low_cut)
    high_cut: float = 0.5       # hi = percentile(vals, 100 - high_cut)
    mask_outside: bool = False
    save_png: bool = True
    save_tiff16: bool = False
    save_tiff_raw: bool = False
    fixed_crop: bool = True
    crop_w: int = 500
    crop_h: int = 500
    add_scalebar: bool = False
    px_um: Optional[float] = None
    sb_len_um: Optional[float] = None
    png_dpi: int = 300
    subset_stage: Optional[int] = None
    subset_time: Optional[int] = None
    subset_roi: Optional[int] = None
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST


def crop_view_tiled(
    img: torch.Tensor,           # (H, W) raw frame (u8 / u16 / float)
    local_polys: torch.Tensor,   # (N, V, 2) [x, y] relative to the tile origin
    offsets: torch.Tensor,       # (N, 2) [row, col] tile origins inside the frame
    crop_start: torch.Tensor,    # (N, 2) crop origin within the tile
    crop_size: torch.Tensor,     # (N, 2) crop [h, w]
    lo_p1000: int,
    hi_p1000: int,
    gamma: float,
    *,
    tile: int,
    mask_outside: bool,
):
    """(norm_gamma (N, T, T) float32, local_mask (N, T, T) bool, ok (N,)
    bool): the cropper's normalize-cut-gamma view of each ROI tile.  The
    quantiles are over the crop's finite pixels; when they are not finite
    or not increasing, the crop's min / max take their place; ``ok`` is
    False for a crop that still has no range."""
    dev = img.device
    N = offsets.shape[0]
    masks = rasterize_polygons(local_polys, (tile, tile))
    ar = torch.arange(tile, device=dev)
    offs = offsets.to(torch.int64)
    rows = offs[:, 0, None] + ar                                   # (N, T)
    cols = offs[:, 1, None] + ar
    tl = as_float32(img)[rows[:, :, None], cols[:, None, :]]       # (N, T, T)
    cs, cz = crop_start.to(torch.int64), crop_size.to(torch.int64)
    in_r = (ar >= cs[:, 0, None]) & (ar < (cs[:, 0] + cz[:, 0])[:, None])
    in_c = (ar >= cs[:, 1, None]) & (ar < (cs[:, 1] + cz[:, 1])[:, None])
    fin_px = torch.isfinite(tl)
    finite = in_r[:, :, None] & in_c[:, None, :] & fin_px
    n = finite.sum(dim=(1, 2), dtype=torch.int32)
    inf = torch.full((), float("inf"), device=dev)
    kept = torch.where(finite, tl, inf)
    xs = torch.sort(kept.reshape(N, -1), dim=1).values   # both quantiles
    lo = quantile_from_sorted(xs, n, lo_p1000)
    hi = quantile_from_sorted(xs, n, hi_p1000)
    vmin = kept.amin(dim=(1, 2))
    vmax = torch.where(finite, tl, -inf).amax(dim=(1, 2))
    bad = ~torch.isfinite(lo) | ~torch.isfinite(hi) | (hi <= lo)
    lo = torch.where(bad, vmin, lo)
    hi = torch.where(bad, vmax, hi)
    ok = (n > 0) & torch.isfinite(lo) & torch.isfinite(hi) & (hi > lo)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    norm = torch.clamp((tl - lo[:, None, None]) / span[:, None, None], 0.0, 1.0)
    if mask_outside:
        # a select, not a product: a NaN pixel outside the ROI becomes 0, as
        # XLA's rewrite of the JAX package's ``norm * mask`` gives it
        norm = torch.where(masks, norm, torch.zeros((), device=dev))
    g = torch.tensor(gamma, dtype=torch.float32, device=dev)
    return torch.pow(norm, 1.0 / g), masks, ok


def crop_tile(boxes, H: int, W: int) -> int:
    """The square tile of a frame's crops: 128, doubled while smaller than
    the largest crop side, then clipped to the frame's short side (a crop
    larger than that is cut to the tile)."""
    need = max(max(b[2], b[3]) for b in boxes)
    tile = 128
    while tile < need:
        tile *= 2
    return min(tile, min(H, W))


def run_crop(
    raw_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: CropConfig,
    log=print,
    device="cuda",
) -> List[str]:
    """run_crop parity (roi_channel_cropper.py:778-989): the crops of every
    frame of ``cfg.channel`` under *raw_dir* with an ROI bundle in
    *roi_dir*, written under *out_root* (``PNG/``, ``TIFF16/``, ``TIFF/``).
    Returns the written paths.  *device* is ``"cuda"`` (default; raises
    without a card) or ``"cpu"``."""
    from ..parallel.runner import LoadError, PrefetchLoader
    from ..report.render import save_png_image

    dev = resolve_device(device)
    fmap = {}
    for p in naming.list_tifs(raw_dir):
        k = naming.parse_tokens(os.path.basename(p), cfg.timelapse, cfg.grammar)
        if k.stage is None or k.channel != cfg.channel:
            continue
        s = naming.fmt_stage(k.stage)
        t_code = naming.fmt_time(k.time) if (cfg.timelapse and k.time is not None) else None
        fmap[(s, t_code)] = p
    if not fmap:
        log(t("crop_no_channel").format(ch=cfg.channel))
        return []

    if cfg.subset_stage is not None:
        s_code = naming.fmt_stage(cfg.subset_stage)
        if not cfg.timelapse or cfg.subset_time is None:
            fmap = {k: v for k, v in fmap.items() if k[0] == s_code}
        else:
            t_code = naming.fmt_time(cfg.subset_time)
            fmap = {k: v for k, v in fmap.items() if k == (s_code, t_code)}
        if not fmap:
            log(t("crop_subset_no_match"))
            return []

    png_dir = os.path.join(out_root, "PNG")
    tif16_dir = os.path.join(out_root, "TIFF16")
    tif_dir = os.path.join(out_root, "TIFF")
    for d, on in ((png_dir, cfg.save_png), (tif16_dir, cfg.save_tiff16),
                  (tif_dir, cfg.save_tiff_raw)):
        if on:
            os.makedirs(d, exist_ok=True)

    out_px = ((cfg.crop_w, cfg.crop_h)
              if cfg.fixed_crop and cfg.crop_w and cfg.crop_h else None)
    color_rgb = COLOR_MAP.get(cfg.color)
    lo_p = p1000_of(cfg.low_cut)
    hi_p = p1000_of(100.0 - cfg.high_cut)
    written: List[str] = []

    def _load(item):
        (s, t_code), ipath = item
        raw = tiffio.squeeze_first_channel(tiffio.read_tiff(ipath))
        keytag = f"{s}{('_' + t_code) if (cfg.timelapse and t_code) else ''}"
        base = os.path.join(roi_dir, keytag)
        polys = (roiio.load_roi_polygons(base + ".json")
                 if os.path.exists(base + ".json") else None)
        return keytag, raw, polys

    for item in PrefetchLoader(_load, sorted(fmap.items()), workers=8):
        if isinstance(item, LoadError):
            log(t("err_worker").format(key=item.item[0], error=item.error))
            continue
        keytag, raw_full, polys = item
        H, W = raw_full.shape
        if not polys:
            log(t("crop_no_roi").format(tag=keytag))
            continue

        roi_indices = list(range(1, len(polys) + 1))
        if cfg.subset_roi is not None:
            k = int(cfg.subset_roi)
            if 1 <= k <= len(polys):
                roi_indices = [k]
            else:
                log(t("crop_subset_warn").format(tag=keytag, k=k))
                continue
        sel_polys = [np.asarray(polys[i - 1], float) for i in roi_indices]

        # reference crop boxes: bbox +- max(10, 5% of max dim), clamped
        pad = max(10, int(0.05 * max(W, H)))
        boxes = []
        for P in sel_polys:
            x0 = max(int(P[:, 0].min()) - pad, 0)
            x1 = min(int(P[:, 0].max()) + pad, W - 1)
            y0 = max(int(P[:, 1].min()) - pad, 0)
            y1 = min(int(P[:, 1].max()) + pad, H - 1)
            boxes.append((y0, x0, y1 - y0 + 1, x1 - x0 + 1))
        tile = crop_tile(boxes, H, W)
        if tile < max(max(b[2], b[3]) for b in boxes):
            log(t("crop_warn_too_large").format(tag=keytag))

        n = len(sel_polys)
        offs = np.zeros((n, 2), np.int32)
        cstart = np.zeros((n, 2), np.int32)
        csize = np.zeros((n, 2), np.int32)
        locals_ = []
        for i, (P, (y0, x0, ch_, cw_)) in enumerate(zip(sel_polys, boxes)):
            oy, ox = min(y0, H - tile), min(x0, W - tile)
            offs[i] = (oy, ox)
            cstart[i] = (y0 - oy, x0 - ox)
            csize[i] = (min(ch_, tile), min(cw_, tile))
            locals_.append((P - np.array([ox, oy], float)).astype(np.float32))

        def up(arr):
            return to_device(arr, dev, None, [])

        norm_g, masks_t, oks = crop_view_tiled(
            up(raw_full), up(pad_polygons(locals_)), up(offs), up(cstart),
            up(csize), lo_p, hi_p, float(cfg.gamma), tile=tile,
            mask_outside=cfg.mask_outside)
        # one copy brings the views, the masks and the flags back
        flat = torch.cat([norm_g.reshape(-1), masks_t.reshape(-1).to(torch.float32),
                          oks.to(torch.float32)]).cpu().numpy()
        norm_g = flat[:n * tile * tile].reshape(n, tile, tile)
        masks_t = flat[n * tile * tile:2 * n * tile * tile].reshape(n, tile, tile) > 0
        oks = flat[2 * n * tile * tile:] > 0

        for i, (roi_i, (y0, x0, ch_, cw_)) in enumerate(zip(roi_indices, boxes)):
            if not oks[i]:
                log(t("crop_warn_norm").format(tag=f"{keytag}_roi{roi_i}"))
                continue
            sy, sx = cstart[i]
            ng = norm_g[i, sy:sy + ch_, sx:sx + cw_]
            lm = masks_t[i, sy:sy + ch_, sx:sx + cw_]
            name = f"{keytag}_roi{roi_i}_ch{cfg.channel}"

            if cfg.save_png:
                out_img = ng if color_rgb is None else np.clip(
                    ng[..., None] * np.asarray(color_rgb, np.float32), 0, 1)
                out_png = os.path.join(png_dir, name + ".png")
                save_png_image(out_img, out_png, dpi=cfg.png_dpi, out_px=out_px,
                               scalebar_um=cfg.sb_len_um if cfg.add_scalebar else None,
                               px_um=cfg.px_um)
                written.append(out_png)
            if cfg.save_tiff16:
                p16 = os.path.join(tif16_dir, name + ".tif")
                tiffio.write_tiff16(p16, (np.clip(ng, 0, 1) * 65535).astype(np.uint16))
                written.append(p16)
            if cfg.save_tiff_raw:
                raw_out = raw_full[y0:y0 + ch_, x0:x0 + cw_].copy()
                if cfg.mask_outside:
                    raw_out[~lm] = 0
                praw = os.path.join(tif_dir, name + ".tif")
                if raw_out.dtype == np.uint16:
                    tiffio.write_tiff16(praw, raw_out)
                else:
                    tiffio.write_tiff32(praw, raw_out.astype(np.float32))
                written.append(praw)
    log(t("done_all"))
    return written
