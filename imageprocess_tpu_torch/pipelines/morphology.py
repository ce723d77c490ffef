"""Per-ROI shape metrics (the reference's MOR_by_ROI) and their overlay PNGs.

Port of ``imageprocess_tpu/pipelines/morphology.py``.  Reference
semantics: src/MOR_by_ROI.py -- ``morphology_from_polygon`` (:211-241),
``second_moments`` / ``major_minor_axes_um`` (:193-209, np.cov ddof=1 +
eigh, a = 4*sqrt(lambda)), hull / shoelace / perimeter (:166-191), ``main``
(:379-517).  The reference mixes pixel areas (the rasterized mask) with
polygon perimeters and hull areas (vertex math); kept as it is.

Device part, plain PyTorch: the masks rasterized on ROI bbox tiles and
their pixel-moment sums, two-pass (centroid first, then centred squares)
for float32 accuracy; one packed copy per frame brings them back.  The
vertex math (perimeter, hull, shoelace) stays on the host, and so do the
overlay PNGs (``save_full``: the frame with numbered outlines; ``save_crop``:
the titled per-ROI crops), drawn by ``report.render.save_morphology_images``
from the decoded host frame.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import i18n, naming, roiio, tiffio
from ..device import resolve_device
from ..geom.polygon import convex_hull, polygon_perimeter, shoelace_area
from ..geom.rasterize import rasterize_polygons
from ..ops.roistats import choose_tile, pad_local_polys, tile_offsets
from ..parallel.runner import LoadError, PrefetchLoader
from ..report.render import save_morphology_images
from .intensity import _bucket, _device_inputs, to_device

t = i18n.t
ChannelGrammar = naming.ChannelGrammar
MOMENT_FIELDS = ("area", "yc", "xc", "sxx", "syy", "sxy")


@dataclass
class MorConfig:
    """The JAX package's ``MorConfig``, field for field (names and
    defaults)."""

    px_um: float = 0.223
    sel_ch: int = 1
    include_no_channel: bool = False
    timelapse: bool = False
    save_full: bool = True
    save_crop: bool = True
    mask_outside: bool = False
    add_scalebar: bool = False
    scale_bar_um: Optional[float] = None
    do_xls: bool = True
    grammar: ChannelGrammar = ChannelGrammar.END_ANCHORED
    mpl_canvas: bool = False


def roi_moments_tiled(local_polys: torch.Tensor, offsets: torch.Tensor,
                      roi_valid: torch.Tensor, tile: int) -> Dict[str, torch.Tensor]:
    """Per-ROI pixel-moment sums on tiles: area, global centroid (yc, xc),
    and the centred second-moment sums (sxx, syy, sxy), (N,) float32 each,
    from (N, V, 2) tile-local polygons, (N, 2) [row, col] origins and (N,)
    validity.

    Two-pass: centroid first, then centred squares -- keeps the float32
    sums at ~1e-6 relative."""
    masks = rasterize_polygons(local_polys, (tile, tile)) & roi_valid[:, None, None]
    m = masks.to(torch.float32)
    n = m.sum(dim=(1, 2))
    nf = torch.clamp(n, min=1.0)
    ar = torch.arange(tile, dtype=torch.float32, device=masks.device)
    ys, xs = ar[None, :, None], ar[None, None, :]
    yc = (ys * m).sum(dim=(1, 2)) / nf
    xc = (xs * m).sum(dim=(1, 2)) / nf
    zero = torch.zeros((), dtype=torch.float32, device=masks.device)
    dy = torch.where(masks, ys - yc[:, None, None], zero)
    dx = torch.where(masks, xs - xc[:, None, None], zero)
    offs = offsets.to(torch.float32)
    return {
        "area": n,
        "yc": yc + offs[:, 0],
        "xc": xc + offs[:, 1],
        "sxx": (dx * dx).sum(dim=(1, 2)),
        "syy": (dy * dy).sum(dim=(1, 2)),
        "sxy": (dx * dy).sum(dim=(1, 2)),
    }


def morphology_rows(polys, shape, px_um: float, device="cuda") -> List[dict]:
    """All metric rows for one frame's polygons -- morphology_from_polygon
    parity for every ROI, the mask moments computed on *device*."""
    dev = resolve_device(device)
    H, W = shape
    n = len(polys)
    tile = choose_tile(polys, H, W)
    if tile is not None:
        offs = tile_offsets(polys, H, W, tile)
        pv, offs_pad, valid = pad_local_polys(
            polys, offs, _bucket(n), _bucket(max(len(p) for p in polys), 32)
        )
    else:  # oversized ROI: one full-frame tile per ROI
        pv, valid, _, _ = _device_inputs(np.zeros((1, H, W), np.float32), polys, None)
        offs_pad = np.zeros((pv.shape[0], 2), np.int32)
        tile = max(H, W)
    out = roi_moments_tiled(*(to_device(a, dev, None, []) for a in (pv, offs_pad, valid)),
                            tile)
    packed = torch.stack([out[f] for f in MOMENT_FIELDS]).cpu().numpy()
    moments = dict(zip(MOMENT_FIELDS, packed))

    rows = []
    for i, poly in enumerate(polys):
        area_px = float(moments["area"][i])
        if area_px == 0:
            rows.append({
                "area_px": 0, "area_um2": 0,
                "perimeter_px": np.nan, "perimeter_um": np.nan,
                "circularity": np.nan, "roundness": np.nan, "solidity": np.nan,
                "major_um": np.nan, "minor_um": np.nan,
                "aspect_ratio": np.nan, "orientation_deg": np.nan,
                "centroid_x": np.nan, "centroid_y": np.nan,
            })
            continue
        area_um2 = area_px * px_um ** 2
        perimeter_px = polygon_perimeter(poly)
        hull = convex_hull(np.asarray(poly, float))
        if hull.shape[0] >= 3:
            hull_area = shoelace_area(hull)
            solidity = area_px / hull_area if hull_area > 0 else np.nan
        else:
            solidity = np.nan
        # np.cov ddof=1 over pixel coords (MOR_by_ROI.py:193-209)
        denom = max(area_px - 1.0, 1e-12)
        cov = np.array([
            [moments["sxx"][i] / denom, moments["sxy"][i] / denom],
            [moments["sxy"][i] / denom, moments["syy"][i] / denom],
        ])
        w, v = np.linalg.eigh(cov)
        lam1, lam2 = w[1], w[0]
        orientation = math.degrees(math.atan2(v[1, 1], v[0, 1]))
        major_um = 4.0 * math.sqrt(max(lam1, 0.0)) * px_um
        minor_um = 4.0 * math.sqrt(max(lam2, 0.0)) * px_um
        aspect = (major_um / minor_um
                  if np.isfinite(major_um) and np.isfinite(minor_um) and minor_um > 0
                  else np.nan)
        circularity = (4.0 * math.pi * area_px / perimeter_px ** 2
                       if perimeter_px > 0 else np.nan)
        roundness = (4.0 * area_um2 / (math.pi * major_um ** 2)
                     if np.isfinite(major_um) and major_um > 0 else np.nan)
        rows.append({
            "area_px": area_px, "area_um2": area_um2,
            "perimeter_px": perimeter_px, "perimeter_um": perimeter_px * px_um,
            "circularity": circularity, "roundness": roundness,
            "solidity": solidity,
            "major_um": major_um, "minor_um": minor_um,
            "aspect_ratio": aspect, "orientation_deg": orientation,
            "centroid_x": float(moments["xc"][i]),
            "centroid_y": float(moments["yc"][i]),
        })
    return rows


MOR_COLS = ["stage", "time", "roi", "img", "channel", "px_um",
            "area_px", "area_um2", "perimeter_px", "perimeter_um",
            "major_um", "minor_um", "aspect_ratio", "orientation_deg",
            "circularity", "roundness", "solidity",
            "centroid_x", "centroid_y"]


def morphology_table(rows: List[dict]) -> List[list]:
    """The rows as ``MOR_COLS`` cells (a missing column NaN), sorted by
    (stage, time, roi) with missing times last."""
    def order(r):
        return (r["stage"], r.get("time") is None, r.get("time") or "", r["roi"])

    return [[r.get(c, float("nan")) for c in MOR_COLS]
            for r in sorted(rows, key=order)]


def run_morphology(
    folder: str,
    cfg: MorConfig,
    roi_dir: Optional[str] = None,
    out_root: Optional[str] = None,
    log=print,
    device="cuda",
) -> List[dict]:
    """MOR_by_ROI main loop (src/MOR_by_ROI.py:379-517): the per-ROI rows
    of every frame of the selected channel,
    ``RES_MOR/xls/morphology_perROI.{xlsx,csv}`` and the overlay PNGs under
    ``RES_MOR/PNG/overlay_{full,crop}``.  *device* is ``"cuda"`` (default;
    raises without a card) or ``"cpu"``."""
    from ..report.excel import _write_csv
    from ..report.xlsxlite import write_xlsx

    dev = resolve_device(device)
    roi_dir = roi_dir or os.path.join(folder, "roi")
    out_root = out_root or os.path.join(folder, "RES_MOR")
    png_full_dir = os.path.join(out_root, "PNG", "overlay_full")
    png_crop_dir = os.path.join(out_root, "PNG", "overlay_crop")

    files_all = naming.list_tifs(folder)
    files, meta = [], {}
    skipped_noch = skipped_mismatch = 0
    for p in files_all:
        k = naming.parse_tokens(os.path.basename(p), cfg.timelapse, cfg.grammar)
        if k.channel is None:
            if cfg.include_no_channel:
                files.append(p)
                meta[p] = k
            else:
                skipped_noch += 1
        elif k.channel == cfg.sel_ch:
            files.append(p)
            meta[p] = k
        else:
            skipped_mismatch += 1
    log(t("mor_info_files").format(
        total=len(files_all), used=len(files),
        extra=f"no-channel: {skipped_noch} | "
              f"other-channel: {skipped_mismatch}"))

    def _load(img_path):
        base = os.path.basename(img_path)
        roi_base = naming.find_roi_basepath(
            roi_dir, base, cfg.timelapse, cfg.grammar, exts=(".json",)
        )
        polys = (roiio.load_roi_polygons(roi_base + ".json")
                 if os.path.exists(roi_base + ".json") else None)
        return img_path, tiffio.read_2d(img_path), polys

    rows: List[dict] = []
    for item in PrefetchLoader(_load, files, workers=8):
        if isinstance(item, LoadError):
            log(t("err_worker").format(key=os.path.basename(str(item.item)), error=item.error))
            continue
        img_path, img, polys = item
        base = os.path.basename(img_path)
        k = meta[img_path]
        if k.stage is None:
            log(t("mor_skip_parse").format(base=base))
            continue
        S = naming.fmt_stage(k.stage)
        t_code = naming.fmt_time(k.time) if (cfg.timelapse and k.time is not None) else None
        tag = f"{S}_{t_code}" if (cfg.timelapse and t_code is not None) else S
        if not polys:
            log(t("mor_no_roi").format(tag=tag))
            continue

        mets = morphology_rows(polys, img.shape, cfg.px_um, device=dev)
        for i, met in enumerate(mets, 1):
            met.update({
                "stage": S, "time": t_code if cfg.timelapse else None,
                "roi": i, "px_um": cfg.px_um, "img": base,
                "channel": cfg.sel_ch,
            })
            rows.append(met)
        if cfg.save_full or cfg.save_crop:
            save_morphology_images(img=img, polys=polys, mets=mets, tag=tag,
                                   cfg=cfg, png_full_dir=png_full_dir,
                                   png_crop_dir=png_crop_dir)

    if not rows:
        log(t("mor_no_results"))
        return rows

    if cfg.do_xls:
        table = morphology_table(rows)
        xls_dir = os.path.join(out_root, "xls")
        os.makedirs(xls_dir, exist_ok=True)
        write_xlsx(os.path.join(xls_dir, "morphology_perROI.xlsx"),
                   {"per_ROI": [MOR_COLS] + table})
        _write_csv(os.path.join(xls_dir, "morphology_perROI.csv"), MOR_COLS, table)
        log(t("mor_saved").format(path=f"{xls_dir}/morphology_perROI.csv"))
    return rows
