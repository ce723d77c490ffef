"""Two-channel ratiometric FRET: the serial runner and the batched,
tables-only runner.

Port of ``imageprocess_tpu/pipelines/fret.py``.

The serial runner (``run_fret``) takes one (stage, time) pair at a time:
the host decodes both channels (the native decoder, ``core.tiffio`` per
file for frames it does not take) and loads the ROI polygons;
``process_pair`` uploads the raw frames and runs the device program:

- ``fret_step_tiled`` when every polygon fits a tile: each channel's
  background from its raw frame (stride 1, ``ops.background.bg_value``),
  clip(x - bg), eps = max(eps_abs, the eps percentile of the corrected
  denominator), the ratio (numer + eps) / (denom + eps), and the
  statistics of [ratio, donor, acceptor] in each ROI's tile
  (``ops.roistats.roi_stats_tiled``, the ``roistats_f32`` kernel on CUDA
  tensors);
- ``fret_step`` when an ROI needs the full frame: the same over full-frame
  masks (``ops.roistats.roi_stats_full``, the same kernel).

Only the statistics, areas and the three scalars come back; a pair with no
ROI file logs ``fret_roi_missing`` and gives no rows.  With ``do_tif`` or
``do_png`` the ratio frame and the ROI union also come back (page-locked
staging on a card, and only then) and ``report.render.save_fret_images``
writes the RAT / RAT_ROI_masked TIFFs and the ``PNG_RAT`` full and crop
PNGs, for a pair without ROIs too (its full-frame outputs).

The batched runner (``run_fret_batched``), per chunk of pairs:

1. host, prefetch threads: one native call decodes both channels, builds
   their full-frame u16 histograms and cuts each ROI's tile
   (``native.decode_tiff_batch_hist_tiles``, stride 1 as the reference FRET
   pipeline takes its percentiles over the whole frame); the backgrounds and the
   epsilon come from those histograms, exactly (``_host_fret_scalars``);
2. device, once per chunk of pairs: the tiles are copied into page-locked
   staging, sent with one non-blocking copy on a side stream, and
   ``parallel.runner.batched_fret_tile_stats_step`` rasterizes the
   polygons, forms [ratio, donor, acceptor] and launches the
   ``roistats_f32`` kernel on that stream; one non-blocking copy brings the
   packed (B, 10, 3, N) result back into page-locked memory, and a CUDA
   event marks the chunk done;
3. ``finalize`` waits on that event, turns the result into rows
   (``_fret_row``) and only then recycles the chunk's host buffers;
   ``report.excel.save_fret_excel`` writes the tables.

Pairs the batch cannot take (another frame shape, non-u16 frames, no ROI
file, an ROI that needs the full frame) run ``process_pair`` in key order;
a config the batch does not cover (``bg_scope != "full"``, a ``bg_mode``
other than ``percentile``/``none``, ``do_tif``, ``do_png``) runs
``run_fret`` throughout.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import native
from ..core import i18n, naming
from ..core import roiio, tiffio
from ..device import resolve_device
from ..geom.polygon import pad_polygons
from ..geom.rasterize import rasterize_polygons
from ..ops.background import as_float32, bg_correct
from ..ops.percentile import masked_quantile, p1000_of
from ..ops.ratio import ratio_with_eps
from ..ops.roistats import (
    choose_tile, pad_local_polys, roi_stats_full, roi_stats_tiled, tile_offsets,
)
from ..ops.stats import STAT_FIELDS
from ..parallel import runner
from ..report.render import save_fret_images
from .intensity import PinnedPool, _bucket, _pack_key, frames_on_host, to_device

t = i18n.t
ChannelGrammar = naming.ChannelGrammar


@dataclass
class FretConfig:
    """The JAX package's ``FretConfig``, field for field (names and
    defaults)."""

    donor_ch: int = 1
    acceptor_ch: int = 2
    timelapse: bool = False
    ratio_mode: str = "FRET/Donor"      # or "Donor/FRET"
    bg_mode: str = "percentile"
    bg_scope: str = "full"
    percentile: float = 1.0
    per_channel_p: bool = False
    donor_p: float = 1.0
    fret_p: float = 1.0
    clip_neg: bool = True
    eps_percentile: float = 1.0
    eps_abs: float = 5.0
    subset_stage: Optional[int] = None
    subset_time: Optional[int] = None
    # outputs
    do_xls: bool = True
    do_tif: bool = False
    do_png: bool = False
    save_full: bool = True
    save_crop: bool = True
    mask_outside: bool = True
    apply_cmap: bool = True
    cmap_name: str = "jet"
    show_colorbar: bool = True
    cmin_txt: str = ""
    cmax_txt: str = ""
    png_dpi: int = 300
    add_scalebar: bool = False
    scale_bar_um: Optional[float] = None
    px_um: Optional[float] = None
    fixed_crop: bool = True
    crop_w: int = 500
    crop_h: int = 500
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST


def _stage_sort_key(key):
    s, t_code = key
    return (int(re.search(r"\d+", s).group()),
            int(re.search(r"\d+", t_code).group()) if t_code else -1)


def build_fret_pairs(folder: str, cfg: FretConfig):
    """(key, donor_path, acceptor_path) sorted by (stage, time)."""
    files = naming.list_tifs(folder)
    donors, accs = {}, {}
    for path in files:
        k = naming.parse_tokens(os.path.basename(path), cfg.timelapse, cfg.grammar)
        if k.stage is None or k.channel is None:
            continue
        s = naming.fmt_stage(k.stage)
        t_code = (naming.fmt_time(k.time)
                  if (cfg.timelapse and k.time is not None) else None)
        if k.channel == cfg.donor_ch:
            donors[(s, t_code)] = path
        elif k.channel == cfg.acceptor_ch:
            accs[(s, t_code)] = path
    keys = sorted(set(donors) & set(accs), key=_stage_sort_key)
    pairs = [(k, donors[k], accs[k]) for k in keys]
    if cfg.subset_stage is not None:
        s_code = naming.fmt_stage(cfg.subset_stage)
        if not cfg.timelapse or cfg.subset_time is None:
            pairs = [p for p in pairs if p[0][0] == s_code]
        else:
            t_code = naming.fmt_time(cfg.subset_time)
            pairs = [p for p in pairs if p[0] == (s_code, t_code)]
    return pairs


def _roi_base(roi_dir: str, dpath: str, cfg: FretConfig) -> str:
    return naming.find_roi_basepath(roi_dir, os.path.basename(dpath),
                                    cfg.timelapse, cfg.grammar, exts=(".json",))


def load_pair(key, dpath, apath, roi_dir, cfg: FretConfig,
              with_hists: bool = False, pool=None):
    """Host side: decode both channels (one native call; ``core.tiffio``
    per file when the decoder does not take the pair, e.g. RGB or frames
    of two shapes) + load the ROI polygons.  Returns (D, A, polys or None),
    and with *with_hists* the decoder's full-frame u16 histograms (None
    for non-u16 frames and the per-file reads) as a 4th element."""
    res = native.decode_tiff_batch_hist([dpath, apath], 1 if with_hists else 0,
                                        pool=pool)
    if res is not None and res[0].ndim == 3:
        both, hists = res
        D, A = both[0], both[1]
    else:
        D = tiffio.read_2d(dpath, dtype=None)
        A = tiffio.read_2d(apath, dtype=None)
        hists = None
    base = _roi_base(roi_dir, dpath, cfg)
    polys = (roiio.load_roi_polygons(base + ".json")
             if os.path.exists(base + ".json") else None)
    if with_hists:
        return D, A, polys or None, hists
    return D, A, polys or None


def _fret_row(s, t_code, i, get, area_i, eps_f, cfg: FretConfig,
              d_p: float, a_p: float) -> dict:
    """One per-ROI table row; ``get(field, c)`` returns ROI *i*'s scalar
    for stat *field* of channel slot ``c`` (0=ratio, 1=donor, 2=yFRET).
    The one place the FRET row schema lives."""
    return {
        "roi": i + 1,
        "area_px": int(area_i),
        "ratio_mean": float(get("mean", 0)),
        "ratio_median": float(get("median", 0)),
        "ratio_std": float(get("std", 0)),
        "ratio_p5": float(get("p5", 0)),
        "ratio_p95": float(get("p95", 0)),
        "donor_mean": float(get("mean", 1)),
        "donor_median": float(get("median", 1)),
        "yfret_mean": float(get("mean", 2)),
        "yfret_median": float(get("median", 2)),
        "stage": s,
        "time": t_code if cfg.timelapse else None,
        "eps": eps_f,
        "p": cfg.percentile,
        "donor_p": d_p,
        "fret_p": a_p,
        "ratio_mode": cfg.ratio_mode,
        "bg_scope": cfg.bg_scope,
        "bg_mode": cfg.bg_mode,
        "clip_neg": cfg.clip_neg,
        "eps_p": cfg.eps_percentile,
    }


def _channel_ps(cfg: FretConfig):
    """(donor percentile, acceptor percentile) of the background."""
    if cfg.per_channel_p:
        return cfg.donor_p, cfg.fret_p
    return cfg.percentile, cfg.percentile


def _correct(img: torch.Tensor, p1000: int, scope, bg_mode: str,
             clip_neg: bool):
    """(float32 clip(x - bg), bg) with bg from the raw frame at stride 1
    (u16 frames keep the exact integer path); "none": the frame as it is,
    unclipped."""
    if bg_mode == "none":
        return as_float32(img), torch.zeros((), dtype=torch.float32,
                                            device=img.device)
    return bg_correct(img, p1000, scope, bg_mode, stride=1, clip_neg=clip_neg)


def _ratio(Dbc, Abc, scope, eps_p1000: int, eps_abs: float, flip: bool):
    """(ratio frame, eps): eps = max(eps_abs, the eps percentile of the
    corrected denominator over the scope, eps_abs where that is NaN)."""
    numer, denom = (Dbc, Abc) if flip else (Abc, Dbc)
    scope_eps = torch.ones_like(denom, dtype=torch.bool) if scope is None else scope
    eps_q = masked_quantile(denom, scope_eps, eps_p1000)
    ea = torch.tensor(eps_abs, dtype=torch.float32, device=denom.device)
    eps = torch.maximum(ea, torch.where(torch.isnan(eps_q), ea, eps_q))
    return ratio_with_eps(numer, denom, eps), eps


def fret_step(
    D: torch.Tensor,            # (H, W) raw donor (u8 / u16 / float)
    A: torch.Tensor,            # (H, W) raw acceptor
    polys: torch.Tensor,        # (N, V, 2) float32, padded
    roi_valid: torch.Tensor,    # (N,) bool
    d_p1000: int, a_p1000: int, eps_p1000: int, eps_abs: float,
    *,
    bg_mode: str = "percentile",
    bg_scope: str = "full",
    clip_neg: bool = True,
    flip: bool = False,         # False: FRET/Donor, True: Donor/FRET
):
    """One pair on the device over full-frame masks.  Returns (stats dict
    of (3, N) for [ratio, donor, yfret], area_px (N,), (Db, Ab, eps)
    scalars, R_full, Dbc, Abc, union)."""
    H, W = D.shape
    masks = rasterize_polygons(polys, (H, W)) & roi_valid[:, None, None]
    union = masks.any(dim=0)
    scope = union if bg_scope == "roi_union" else None
    Dbc, Db = _correct(D, d_p1000, scope, bg_mode, clip_neg)
    Abc, Ab = _correct(A, a_p1000, scope, bg_mode, clip_neg)
    R_full, eps = _ratio(Dbc, Abc, scope, eps_p1000, eps_abs, flip)
    stats, area = roi_stats_full(torch.stack([R_full, Dbc, Abc]), masks)
    return stats, area, (Db, Ab, eps), R_full, Dbc, Abc, union


def fret_step_tiled(
    D, A, full_polys, local_polys, offsets, roi_valid,
    d_p1000: int, a_p1000: int, eps_p1000: int, eps_abs: float,
    *,
    tile: int,
    bg_mode: str = "percentile", bg_scope: str = "full", clip_neg: bool = True,
    flip: bool = False,
):
    """:func:`fret_step` with the per-ROI statistics on bbox tiles: the
    backgrounds, eps and ratio stay full-frame (elementwise + one
    percentile).  The full-frame union is rasterized only for the
    ``roi_union`` scope (None otherwise: the tables never read it)."""
    H, W = D.shape
    union = (rasterize_polygons(full_polys, (H, W)).any(dim=0)
             if bg_scope == "roi_union" else None)
    Dbc, Db = _correct(D, d_p1000, union, bg_mode, clip_neg)
    Abc, Ab = _correct(A, a_p1000, union, bg_mode, clip_neg)
    R_full, eps = _ratio(Dbc, Abc, union, eps_p1000, eps_abs, flip)
    stats, area = roi_stats_tiled(torch.stack([R_full, Dbc, Abc]), local_polys,
                                  offsets, roi_valid, tile)
    return stats, area, (Db, Ab, eps), R_full, Dbc, Abc, union


def _host_fret_scalars(D: np.ndarray, A: np.ndarray, cfg: FretConfig,
                       hists=None):
    """(bg_donor, bg_acceptor, eps) computed on the host for u16 frames.

    Backgrounds are the exact full-frame percentiles (stride 1, the
    reference FRET pipeline's convention).  eps = max(eps_abs, percentile of the
    bg-corrected denominator over the full frame): the correction is
    monotone, so the exact raw-u16 order statistics are transformed first
    and interpolated after, as sorting the corrected frame would give.
    *hists*: optional (2, 65536) decoder histograms [D, A]; without them
    one counting pass per needed channel builds them."""
    flip = cfg.ratio_mode != "FRET/Donor"
    d_p, a_p = _channel_ps(cfg)
    need_bg = cfg.bg_mode != "none"
    if hists is not None:
        hist_d, hist_a = hists[0], hists[1]
    else:
        hist_d = native.u16_hist(D) if (need_bg or not flip) else None
        hist_a = native.u16_hist(A) if (need_bg or flip) else None
    if need_bg:
        bgd = native.percentile_from_hist(hist_d, p1000_of(d_p))
        bga = native.percentile_from_hist(hist_a, p1000_of(a_p))
    else:
        bgd = bga = 0.0
    denom_hist, denom_bg = (hist_a, bga) if flip else (hist_d, bgd)

    lo, hi, g = native.hist_order_stats(denom_hist, p1000_of(cfg.eps_percentile))

    def tf(v):
        v = np.float32(v) - np.float32(denom_bg)
        return float(max(v, 0.0) if cfg.clip_neg else v)

    eps_q = tf(lo) + g * (tf(hi) - tf(lo))
    return float(bgd), float(bga), float(max(cfg.eps_abs, eps_q))


def fret_dirs(out_root: str) -> Dict[str, str]:
    """The folders of the FRET image outputs under *out_root*."""
    return {
        "RAT32": os.path.join(out_root, "RAT", "32bit"),
        "RAT16": os.path.join(out_root, "RAT", "16bit"),
        "RROI32": os.path.join(out_root, "RAT_ROI_masked", "32bit"),
        "RROI16": os.path.join(out_root, "RAT_ROI_masked", "16bit"),
        "PNG_FULL": os.path.join(out_root, "PNG_RAT", "full"),
        "PNG_CROP": os.path.join(out_root, "PNG_RAT", "crop"),
    }


def process_pair(key, dpath, apath, roi_dir, cfg: FretConfig, out_dirs=None,
                 log=print, loaded=None, device="cuda",
                 staging: Optional[PinnedPool] = None) -> List[dict]:
    """One (stage, time) pair synchronously -> its per-ROI rows.  One copy
    brings back the statistics, areas and the three scalars; the ratio and
    corrected frames stay on the device unless ``cfg.do_tif`` or
    ``cfg.do_png`` is on: then the ratio frame and the ROI union come back
    too (through *staging* on a card) and the images go to *out_dirs*
    (:func:`fret_dirs`).  A pair without ROIs logs ``fret_roi_missing`` and
    gives no rows."""
    dev = resolve_device(device)
    s, t_code = key
    stid = f"{s}_{t_code}" if (cfg.timelapse and t_code is not None) else s
    D, A, polys = loaded if loaded is not None else load_pair(
        key, dpath, apath, roi_dir, cfg)
    if not polys:
        polys = None
        log(t("fret_roi_missing").format(tag=stid))
        if not (cfg.do_tif or cfg.do_png):
            return []
    H, W = D.shape
    n = len(polys) if polys else 0
    nb = _bucket(n) if polys else 1
    vb = _bucket(max(len(p) for p in polys), 32) if polys else 32
    pv = np.zeros((nb, vb, 2), np.float32)
    valid = np.zeros(nb, bool)
    if polys:
        pv[:n] = pad_polygons([np.asarray(p, np.float32) for p in polys], vb)
        valid[:n] = True

    def up(arr):
        return to_device(arr, dev, None, [])

    flip = cfg.ratio_mode != "FRET/Donor"
    d_p, a_p = _channel_ps(cfg)
    common = dict(bg_mode=cfg.bg_mode, bg_scope=cfg.bg_scope,
                  clip_neg=cfg.clip_neg, flip=flip)
    scalars = (p1000_of(d_p), p1000_of(a_p), p1000_of(cfg.eps_percentile),
               cfg.eps_abs)
    tile = choose_tile(polys, H, W) if polys else None
    if tile is not None:
        offs = tile_offsets(polys, H, W, tile)
        lpv, offs_pad, lvalid = pad_local_polys(polys, offs, nb, vb)
        stats, area, (_, _, eps), R_full, _, _, union = fret_step_tiled(
            up(D), up(A), up(pv), up(lpv), up(offs_pad), up(lvalid), *scalars,
            tile=tile, **common)
    else:
        stats, area, (_, _, eps), R_full, _, _, union = fret_step(
            up(D), up(A), up(pv), up(valid), *scalars, **common)
    vals = _pack_key(stats, area, eps[None]).cpu().numpy()
    packed = vals[:len(STAT_FIELDS) * 3 * nb].reshape(len(STAT_FIELDS), 3, nb)
    area_px = vals[len(STAT_FIELDS) * 3 * nb:][:nb]
    eps_f = float(vals[-1])
    rows = [_fret_row(s, t_code, i,
                      lambda f, c, i=i: packed[STAT_FIELDS.index(f), c, i],
                      area_px[i], eps_f, cfg, d_p, a_p)
            for i in range(n)]
    if cfg.do_tif or cfg.do_png:
        # the megapixel ratio frame leaves the device only for the images;
        # the tiled step rasterizes no full-frame union for the tables
        if not polys:
            union = None
        elif union is None:
            union = rasterize_polygons(up(pv), (H, W)).any(dim=0)
        with frames_on_host([R_full, union], dev, staging) as (R_np, union_np):
            save_fret_images(stid=stid, suffix="DoverF" if flip else "FoverD",
                             R_full=R_np, union=union_np, polys=polys, cfg=cfg,
                             dirs=out_dirs)
    return rows


def run_fret(
    folder: str,
    cfg: FretConfig,
    out_root: Optional[str] = None,
    log=print,
    prefetch_workers: int = 8,
    cancel=None,
    device="cuda",
) -> List[dict]:
    """The FRET workload over an experiment *folder*, one pair at a time:
    per-ROI rows of every (stage, time) pair, the tables under
    ``RES/xls``.  TIFF decode runs in a thread pool *prefetch_workers*
    wide; *cancel* (a zero-argument callable) is checked between pairs.
    *device* is ``"cuda"`` (default; raises without a card) or ``"cpu"``."""
    from ..report.excel import save_fret_excel

    dev = resolve_device(device)
    out_root = out_root or os.path.join(folder, "RES")
    dirs = fret_dirs(out_root)
    roi_dir = os.path.join(folder, "roi")
    pairs = build_fret_pairs(folder, cfg)
    if not pairs:
        log(t("fret_no_pairs").format(donor=cfg.donor_ch,
                                      acceptor=cfg.acceptor_ch))
        return []
    # page-locked buffers only for the frames that the images bring back
    staging = (PinnedPool() if (dev.type == "cuda" and (cfg.do_tif or cfg.do_png))
               else None)
    loader = runner.PrefetchLoader(
        lambda kv: (kv, load_pair(kv[0], kv[1], kv[2], roi_dir, cfg)),
        pairs, workers=max(1, prefetch_workers))
    rows_all: List[dict] = []
    for item in loader:
        if cancel is not None and cancel():
            log(t("cancelled"))
            break
        if isinstance(item, runner.LoadError):
            log(t("err_worker").format(key=item.item[0], error=item.error))
            continue
        (key, dpath, apath), loaded = item
        tag = key[0] if key[1] is None else f"{key[0]}_{key[1]}"
        log(t("msg_processing").format(tag=tag))
        rows_all.extend(process_pair(key, dpath, apath, roi_dir, cfg, dirs,
                                     log=log, loaded=loaded, device=dev,
                                     staging=staging))
    if cfg.do_xls and rows_all:
        save_fret_excel(rows_all, os.path.join(out_root, "xls"), cfg.timelapse)
        log(t("fret_saved"))
    elif cfg.do_xls:
        log(t("fret_no_roi"))
    return rows_all


def batched_fret_tile_stats(tiles, local_polys, roi_valid, bgs, eps, *,
                            clip_neg: bool = True, flip: bool = False):
    """Per-ROI stats over [ratio, donor_bc, acceptor_bc] of host-gathered
    (B, N, 2, t, t) u16 tiles: (stats dict of (B, 3, N), area (B, N)
    int32), as the JAX function returns them.  CUDA tensors go through the
    hand kernel, CPU tensors through its plain version."""
    packed = runner.batched_fret_tile_stats_step(
        tiles, local_polys, roi_valid, bgs, eps, clip_neg=clip_neg, flip=flip)
    stats = {f: packed[:, k] for k, f in enumerate(STAT_FIELDS)}
    stats["npx"] = stats["npx"].to(torch.int32)
    return stats, packed[:, len(STAT_FIELDS), 0].to(torch.int32)


def run_fret_batched(
    folder: str,
    cfg: FretConfig,
    out_root: Optional[str] = None,
    log=print,
    batch_size: int = 4,
    prefetch_workers: int = 8,
    cancel=None,
    device="cuda",
) -> List[dict]:
    """Tables-only batched FRET run over an experiment *folder*: host
    backgrounds + eps, ROI tiles of both channels shipped per chunk, one
    device step and one packed result fetch per chunk, two chunks in
    flight.  *device* is ``"cuda"`` (default; raises without a card) or
    ``"cpu"`` (the plain PyTorch version, for tests).  Returns the rows in
    key order.  A config the batch does not cover runs :func:`run_fret`."""
    from ..ops.roistats import (
        choose_tile, gather_tiles, pad_local_polys, tile_offsets,
    )
    from ..report.excel import save_fret_excel

    dev = resolve_device(device)
    if (cfg.do_tif or cfg.do_png or cfg.bg_scope != "full"
            or cfg.bg_mode not in ("percentile", "none")):
        return run_fret(folder, cfg, out_root=out_root, log=log,
                        prefetch_workers=prefetch_workers, cancel=cancel,
                        device=dev)

    out_root = out_root or os.path.join(folder, "RES")
    roi_dir = os.path.join(folder, "roi")
    pairs = build_fret_pairs(folder, cfg)
    if not pairs:
        log(t("fret_no_pairs").format(donor=cfg.donor_ch,
                                      acceptor=cfg.acceptor_ch))
        return []

    flip = cfg.ratio_mode != "FRET/Donor"
    d_p, a_p = _channel_ps(cfg)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    staging = PinnedPool() if cuda else None
    tile_hint: Dict[str, int] = {}
    # recycled decode buffers: finalize()/run_serial() return each pair's
    # (2, H, W) frames and host tiles once nothing reads them
    frame_pool = native.FrameBufferPool()

    def _fit_hint(polys, H, W):
        """(tile, n_bucket) of the run's tile hint (set by the first pair)
        when this pair fits it, else None (another frame shape or a hint
        miss: classify routes the pair to the serial path)."""
        t_need = choose_tile(polys, H, W)
        if t_need is None:
            return None
        t_used = tile_hint.setdefault("tile", t_need)
        nb_used = tile_hint.setdefault("nb", _bucket(len(polys), 2))
        if t_need <= t_used <= min(H, W) and len(polys) <= nb_used:
            return t_used, nb_used
        return None

    def _pre_pad(polys, offs, nb_used):
        """Tile-local polygons padded to the run's vertex hint, or
        (None, None) when the pair outgrows it (dispatch pads then)."""
        max_v = max(len(p) for p in polys)
        vb_used = tile_hint.setdefault("vb", _bucket(max_v, 32))
        if max_v > vb_used:
            return None, None
        lp, _, valid = pad_local_polys(polys, offs, nb_used, vb_used)
        return lp, valid

    def _load_fused(kv):
        """ROI json first (so tile offsets are known), then ONE GIL-free
        native call doing both channels' decode + full-frame histograms +
        ROI-tile extraction.  None -> the decode-then-gather path."""
        _, dpath, apath = kv
        info = native.tiff_info(dpath)
        if info is None or info[2] != 16 or info[3] != 1:
            return None
        H, W = info[0], info[1]
        base = _roi_base(roi_dir, dpath, cfg)
        if not os.path.exists(base + ".json"):
            return None
        polys = roiio.load_roi_polygons(base + ".json")
        fit = _fit_hint(polys, H, W) if polys else None
        if fit is None:
            return None
        t_used, nb_used = fit
        offs = tile_offsets(polys, H, W, t_used)
        res = native.decode_tiff_batch_hist_tiles(
            [dpath, apath], 1, np.asarray(offs, np.int32), t_used,
            pad_tiles=nb_used - len(polys), pool=frame_pool)
        if res is None:
            return None
        both, hists, tiles_np = res
        scalars = _host_fret_scalars(both[0], both[1], cfg, hists=hists)
        lp, valid = _pre_pad(polys, offs, nb_used)
        return kv, (both[0], both[1], polys), scalars, (
            t_used, tiles_np, offs, lp, valid)

    def _load(kv):
        """Fused path first; else decode, then gather the tiles with numpy
        at the run's tile hint (when the pair fits it)."""
        try:
            item = _load_fused(kv)
        except Exception:  # noqa: BLE001 — any fused-path surprise falls
            item = None    # back to the general loader below
        if item is not None:
            return item
        key, dpath, apath = kv
        D, A, polys, hists = load_pair(key, dpath, apath, roi_dir, cfg,
                                       with_hists=True, pool=frame_pool)
        if not polys or hists is None:
            # no ROIs, or not one native decode of two u16 frames (whose
            # (2, H, W) buffer the batch gathers from): process_pair
            return kv, (D, A, polys), None, None
        scalars = _host_fret_scalars(D, A, cfg, hists=hists)
        fit = _fit_hint(polys, *D.shape)
        if fit is None:
            return kv, (D, A, polys), scalars, None
        t_used, nb_used = fit
        offs = tile_offsets(polys, *D.shape, t_used)
        tiles = gather_tiles(D.base, offs, nb_used, t_used)
        return kv, (D, A, polys), scalars, (
            t_used, tiles, offs, *_pre_pad(polys, offs, nb_used))

    loader = runner.PrefetchLoader(_load, pairs, workers=max(1, prefetch_workers),
                                   ahead=32)
    _cur_bs, _maybe_grow_chunk = runner.make_autoscaler(loader, batch_size)
    rows_all: List[dict] = []
    n_done = 0

    def _emit_rows(kv, n_roi, packed, eps_f):
        """Rows of one pair from its packed (10, 3, N) result."""
        s, t_code = kv[0]
        for i in range(n_roi):
            rows_all.append(_fret_row(
                s, t_code, i,
                lambda f, c, i=i: packed[STAT_FIELDS.index(f), c, i],
                packed[len(STAT_FIELDS), 0, i], eps_f, cfg, d_p, a_p))

    def _to_device(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(dev, non_blocking=True)

    def _step(tiles_b, lp_b, val_b, bgs_b, eps_b):
        return runner.batched_fret_tile_stats_step(
            tiles_b, _to_device(lp_b), _to_device(val_b), _to_device(bgs_b),
            _to_device(eps_b), clip_neg=cfg.clip_neg, flip=flip)

    def run_serial(entry):
        """A pair the batch program can't take: :func:`process_pair`,
        synchronously."""
        nonlocal n_done
        (key, dpath, apath), loaded = entry[:2]  # a batch entry has more
        rows_all.extend(process_pair(key, dpath, apath, roi_dir, cfg, None,
                                     log=log, loaded=loaded, device=dev))
        n_done += 1
        base = loaded[0].base
        if base is not None and base.shape == (2,) + loaded[0].shape:
            frame_pool.put(base)  # the native (2, H, W) decode buffer

    def dispatch(chunk):
        """Build the padded chunk and launch its device step WITHOUT
        synchronizing; None when the chunk can't take the batch step."""
        all_p = [poly for _, (_, _, polys), *_ in chunk for poly in polys]
        H, W = chunk[0][1][0].shape
        tile = choose_tile(all_p, H, W)
        if tile is None:
            return None
        # the loader's pre-gather hint, clamped to this chunk's frame
        tile = min(max(tile, tile_hint.get("tile", tile)), min(H, W))
        max_n = max(len(c[1][2]) for c in chunk)
        nb_hint = tile_hint.get("nb")
        nb = nb_hint if nb_hint is not None and max_n <= nb_hint \
            else _bucket(max_n, 8)
        max_v = max(len(poly) for poly in all_p)
        vb_hint = tile_hint.get("vb")
        vb = vb_hint if vb_hint is not None and max_v <= vb_hint \
            else _bucket(max_v, 32)
        B = len(chunk)
        lp_b = np.zeros((B, nb, vb, 2), np.float32)
        val_b = np.zeros((B, nb), bool)
        bgs_b = np.zeros((B, 2), np.float32)
        eps_b = np.zeros((B,), np.float32)
        shape = (B, nb, 2, tile, tile)
        if cuda:
            # int16 storage read as uint16: the staging buffer is filled
            # through numpy and reinterpreted on the device
            tiles_buf = staging.get(shape, torch.int16)
            tiles_np = tiles_buf.numpy().view(np.uint16)
        else:
            tiles_np = np.empty(shape, np.uint16)
        for bi, (kv, (D, _, polys), (bgd, bga, eps_f), pre) in enumerate(chunk):
            if pre is not None and pre[0] == tile:
                tiles_i, offs = pre[1], pre[2]
            else:  # hint missed (first pairs raced / ROI outgrew it)
                offs = tile_offsets(polys, H, W, tile)
                tiles_i = gather_tiles(D.base, offs, nb, tile)
            k = min(tiles_i.shape[0], nb)
            tiles_np[bi, :k] = tiles_i[:k]
            tiles_np[bi, k:] = 0
            if (pre is not None and pre[0] == tile and pre[3] is not None
                    and pre[3].shape == (nb, vb, 2)):
                lp, valid = pre[3], pre[4]  # loader pre-padded
            else:
                lp, _, valid = pad_local_polys(polys, offs, nb, vb)
            lp_b[bi], val_b[bi] = lp, valid
            bgs_b[bi] = (bgd, bga)
            eps_b[bi] = eps_f
        if not cuda:
            packed = _step(torch.from_numpy(tiles_np), lp_b, val_b, bgs_b, eps_b)
            return chunk, packed.numpy(), None, ()
        with torch.cuda.stream(side):
            tiles_d = tiles_buf.to(dev, non_blocking=True).view(torch.uint16)
            packed = _step(tiles_d, lp_b, val_b, bgs_b, eps_b)
            out = staging.get(tuple(packed.shape), torch.float32)
            out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return chunk, out, done, (tiles_buf, out)

    def finalize(rec):
        """Wait for a dispatched chunk, emit its rows, recycle its host
        buffers."""
        nonlocal n_done
        chunk, packed, done, staged = rec
        try:  # no side effects yet, so a failure is safe to retry serially
            if done is not None:
                done.synchronize()
                packed = packed.numpy()
        except Exception as e:  # noqa: BLE001
            raise runner.EmitFetchError(str(e)) from e
        for bi, (kv, (_, _, polys), (_, _, eps_f), _) in enumerate(chunk):
            _emit_rows(kv, len(polys), packed[bi], eps_f)
        n_done += len(chunk)
        # the chunk's copies are complete: its frames, host tiles and
        # staging buffers can be reused
        for _, (D, _, _), _, pre in chunk:
            frame_pool.put(D.base)
            if pre is not None:
                frame_pool.put(pre[1])
        for buf in staged:
            staging.put(buf)
        _maybe_grow_chunk()
        log(t("batch_progress").format(done=n_done))

    sig = None        # dominant frame shape, set by the first pair

    def classify(item):
        nonlocal sig
        kv, loaded, scalars, pre = item
        D, A, polys = loaded
        if scalars is None or not polys or D.shape != A.shape:
            return "serial", (kv, loaded)
        if sig is None:
            sig = D.shape
        if D.shape != sig:
            return "serial", (kv, loaded)
        return "batch", (kv, loaded, scalars, pre)

    def _err_key(it):
        # the raw (key, dpath, apath) loader item on a load failure, or an
        # entry whose [0] is that triple when a serial fallback failed
        return it[0] if isinstance(it[1], str) else it[0][0]

    if runner.stream_batches(
        loader, _cur_bs, classify, dispatch, finalize, run_serial,
        lambda err: log(t("err_worker").format(key=_err_key(err.item),
                                               error=err.error)),
        cancel=cancel,
    ):
        log(t("cancelled"))

    if cfg.do_xls and rows_all:
        save_fret_excel(rows_all, os.path.join(out_root, "xls"), cfg.timelapse)
        log(t("fret_saved"))
    elif cfg.do_xls:
        log(t("fret_no_roi"))
    return rows_all
