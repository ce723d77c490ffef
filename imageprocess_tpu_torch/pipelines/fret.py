"""Two-channel ratiometric FRET: the batched, tables-only runner.

Port of ``imageprocess_tpu/pipelines/fret.py`` (``FretConfig``,
``build_fret_pairs``, ``load_pair``, ``_fret_row``, ``_host_fret_scalars``,
``batched_fret_tile_stats``, ``run_fret_batched``).  Per (stage, time)
pair:

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

Pairs the batch cannot take (another frame shape, a tile-size hint miss)
run the same tile step as a batch of one, in key order.  A pair with no
ROI file logs ``fret_roi_missing`` and gives no rows.  Pairs that need the
full-frame program — non-u16 frames, an ROI that needs the full frame —
raise ``NotImplementedError`` (the serial FRET path), which the streaming
protocol logs per key; so do, at entry, the configs the JAX runner sends
to ``run_fret`` (image outputs, ``bg_scope != "full"``, a ``bg_mode``
other than ``percentile``/``none``).
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
from ..core import roiio
from ..device import resolve_device
from ..ops.percentile import p1000_of
from ..ops.stats import STAT_FIELDS
from ..parallel import runner
from .intensity import PinnedPool, _bucket

t = i18n.t
ChannelGrammar = naming.ChannelGrammar
SERIAL_FRET = "the serial FRET path (run_fret, ROADMAP Queue 1 item 8)"


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
    """Host side: decode both channels with one native call + load the ROI
    polygons.  Returns (D, A, polys or None), and with *with_hists* the
    decoder's full-frame u16 histograms (or None for non-u16 frames) as a
    4th element.  Raises when the native decoder cannot take the pair."""
    res = native.decode_tiff_batch_hist([dpath, apath], 1 if with_hists else 0,
                                        pool=pool)
    if res is None or res[0].ndim != 3:
        raise RuntimeError(
            f"{key}: the native TIFF decoder is unavailable or does not "
            f"support {dpath} / {apath} (same-shaped single-sample frames "
            "only)")
    both, hists = res
    base = _roi_base(roi_dir, dpath, cfg)
    polys = (roiio.load_roi_polygons(base + ".json")
             if os.path.exists(base + ".json") else None)
    if with_hists:
        return both[0], both[1], polys or None, hists
    return both[0], both[1], polys or None


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
    key order."""
    from ..ops.roistats import (
        choose_tile, gather_tiles, pad_local_polys, tile_offsets,
    )
    from ..report.excel import save_fret_excel

    dev = resolve_device(device)
    if cfg.do_tif or cfg.do_png:
        raise NotImplementedError(f"TIF/PNG image outputs need {SERIAL_FRET}")
    if cfg.bg_scope != "full":
        raise NotImplementedError(
            f"bg_scope={cfg.bg_scope!r} needs {SERIAL_FRET}")
    if cfg.bg_mode not in ("percentile", "none"):
        raise NotImplementedError(f"bg_mode={cfg.bg_mode!r} needs {SERIAL_FRET}")

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
        if not polys or D.dtype != np.uint16:
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
        """A pair the batch program can't take: the same tile step as a
        batch of one, with its own tile size, synchronously."""
        nonlocal n_done
        kv, (D, A, polys), scalars = entry[:3]  # a batch entry also has pre
        stid = kv[0][0] if kv[0][1] is None else f"{kv[0][0]}_{kv[0][1]}"
        if D.dtype != np.uint16:
            raise NotImplementedError(f"{stid}: {D.dtype} frames need {SERIAL_FRET}")
        H, W = D.shape
        tile = choose_tile(polys, H, W)
        if tile is None:
            raise NotImplementedError(
                f"{stid}: an ROI needs the full frame: {SERIAL_FRET}")
        offs = tile_offsets(polys, H, W, tile)
        nb = _bucket(len(polys))
        lp, _, valid = pad_local_polys(
            polys, offs, nb, _bucket(max(len(p) for p in polys), 32))
        tiles = torch.from_numpy(gather_tiles(D.base, offs, nb, tile)[None])
        bgd, bga, eps_f = scalars
        packed = _step(tiles.to(dev), lp[None], valid[None],
                       np.array([[bgd, bga]], np.float32),
                       np.array([eps_f], np.float32))
        _emit_rows(kv, len(polys), packed[0].cpu().numpy(), eps_f)
        n_done += 1
        frame_pool.put(D.base)

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
        kv, (D, A, polys), scalars, pre = item
        if not polys:
            stid = kv[0][0] if kv[0][1] is None else f"{kv[0][0]}_{kv[0][1]}"
            log(t("fret_roi_missing").format(tag=stid))
            frame_pool.put(D.base)
            return "skip", None
        if scalars is None:
            return "serial", (kv, (D, A, polys), scalars)
        if sig is None:
            sig = D.shape
        if D.shape != sig:
            return "serial", (kv, (D, A, polys), scalars)
        return "batch", (kv, (D, A, polys), scalars, pre)

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
