"""Per-ROI fluorescence intensity: the batched, tables-only runner.

Port of ``imageprocess_tpu/pipelines/intensity.py`` (``IntensityConfig``,
``run_intensity_batched``).  Per (stage, time) key:

1. host, prefetch threads: one native call decodes the channel TIFFs,
   builds the strided u16 histogram and cuts each ROI's tile
   (``native.decode_tiff_batch_hist_tiles``); the per-channel background
   comes from that histogram (``_host_bg``);
2. device, once per chunk of keys: the tiles are copied into page-locked
   staging, sent with one non-blocking copy on a side stream, and
   ``parallel.runner.batched_tile_stats_step`` rasterizes the polygons and
   launches the tile-statistics kernel on that stream; one non-blocking
   copy brings the packed (B, 10, C, N) result back into page-locked
   memory, and a CUDA event marks the chunk done;
3. ``finalize`` waits on that event, turns the result into rows and only
   then recycles the chunk's host buffers (the copies read them late);
   ``report.excel`` writes the tables.

Keys the batch program cannot take (another frame shape, a tile-size hint
miss) run the same tile step as a batch of one, in key order.  Keys that
need the full-frame program — mask-only ROIs, whole-frame ROI 0, an ROI
that needs the full frame, non-u16 frames — raise ``NotImplementedError``
(the serial intensity slice, ROADMAP Queue 1 item 7), which the streaming
protocol logs per key.  So do, at entry, a ``bg_scope`` other than
``"full"`` and the image outputs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..core import i18n, naming
from ..core import roiio
from ..device import resolve_device
from ..ops.percentile import p1000_of
from ..ops.stats import STAT_FIELDS

t = i18n.t
ChannelGrammar = naming.ChannelGrammar
SERIAL_SLICE = "the serial intensity path (ROADMAP Queue 1 item 7)"


@dataclass
class IntensityConfig:
    """The JAX package's ``IntensityConfig``, field for field (names and
    defaults); the PNG option objects stay ``None`` (image outputs are not
    ported)."""

    channels: Tuple[int, ...] = (1,)          # chs_to_quant
    timelapse: bool = False
    bg_mode: str = "percentile"               # "percentile" | "hist-mode" | "none"
    bg_scope: str = "full"                    # "full" | "roi_union"
    percentile: float = 1.0
    per_channel_p: Dict[int, float] = field(default_factory=dict)
    clip_neg: bool = True
    bg_stride: int = 4
    skip_no_roi: bool = True
    channel_colors: Dict[int, str] = field(default_factory=dict)
    subset_stage: Optional[int] = None
    subset_time: Optional[int] = None
    subset_roi: Optional[int] = None
    do_xls: bool = True
    do_tif: bool = False
    do_png: bool = False
    save_raw_crop_tif: bool = False
    tif_mask_outside: bool = False
    auto_lo: float = 1.0
    auto_hi: float = 99.0
    px_um: Optional[float] = None
    png_full: "object" = None
    png_crop: "object" = None
    fixed_crop: bool = True
    crop_size: int = 500
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST


def _bucket(n: int, step: int = 8) -> int:
    """Round up to a multiple of *step*."""
    return max(step, ((n + step - 1) // step) * step)


def _apply_subset(keymap, cfg: IntensityConfig, log):
    """Stage/time subset filter."""
    if cfg.subset_stage is None:
        return keymap
    s_code = naming.fmt_stage(cfg.subset_stage)
    if not cfg.timelapse or cfg.subset_time is None:
        keymap = {k: v for k, v in keymap.items() if k[0] == s_code}
    else:
        t_code = naming.fmt_time(cfg.subset_time)
        keymap = {k: v for k, v in keymap.items() if k == (s_code, t_code)}
    if not keymap:
        log(t("subset_no_match").format(stage=s_code))
    return keymap


def _host_bg(imgs: np.ndarray, chs, cfg: IntensityConfig,
             hists=None) -> np.ndarray:
    """Per-channel background on the host: the exact np.percentile of the
    strided subsample (a 65536-bin lookup when the decoder already built
    the strided histograms), or the reference's hist-mode; 0.0 for "none"
    and unknown modes."""
    C = imgs.shape[0]
    bgs = np.zeros(C, np.float32)
    if cfg.bg_mode not in ("percentile", "hist-mode"):
        return bgs
    for ci, ch in enumerate(chs):
        p1000 = p1000_of(cfg.per_channel_p.get(ch, cfg.percentile))
        if cfg.bg_mode == "hist-mode":
            if hists is not None:
                bgs[ci] = native.hist_mode_from_hist(hists[ci], p1000)
            else:
                vals = imgs[ci].ravel()[::max(1, cfg.bg_stride)]
                bgs[ci] = native.hist_mode_from_values(vals, p1000)
        elif hists is not None:
            bgs[ci] = native.percentile_from_hist(hists[ci], p1000)
        elif imgs.dtype == np.uint16:
            bgs[ci] = native.u16_percentile_strided(imgs[ci], cfg.bg_stride,
                                                    p1000)
        else:
            vals = imgs[ci].ravel()[::max(1, cfg.bg_stride)]
            bgs[ci] = np.percentile(vals.astype(np.float64), p1000 / 1000.0)
    return bgs


def _key_channels(chmap, cfg: IntensityConfig):
    chs, paths = [], []
    for ch in cfg.channels:
        p = chmap.get(ch)
        if p is not None:
            chs.append(ch)
            paths.append(p)
    return chs, paths


def load_key(key, chmap: Dict[int, str], roi_dir: str, cfg: IntensityConfig,
             hist_stride: int = 0, pool=None):
    """Host side of one (stage, time) key: native TIFF decode (with the
    strided histograms when *hist_stride* >= 1) + ROI polygons.  Returns
    (stid, payload, hists): payload is (chs, imgs, polys, None) or a skip
    message.  Raises NotImplementedError for ROIs given only as a mask and
    for the whole-frame ROI 0."""
    s, t_code = key
    stid = s if t_code is None else f"{s}_{t_code}"
    chs, paths = _key_channels(chmap, cfg)
    if not chs:
        return stid, t("log_no_ch").format(stid=stid), None
    res = native.decode_tiff_batch_hist(paths, hist_stride, pool=pool)
    if res is None or res[0].ndim != 3:
        raise RuntimeError(
            f"{stid}: the native TIFF decoder is unavailable or does not "
            f"support {paths[0]} (single-sample frames only)")
    imgs, hists = res
    base = naming.find_roi_basepath(
        roi_dir, os.path.basename(paths[0]), cfg.timelapse, cfg.grammar)
    polys = (roiio.load_roi_polygons(base + ".json")
             if os.path.exists(base + ".json") else [])
    if polys:
        return stid, (chs, imgs, polys, None), hists
    if os.path.exists(base + ".png"):
        raise NotImplementedError(
            f"{stid}: mask-only ROIs need {SERIAL_SLICE}")
    if cfg.skip_no_roi:
        return stid, t("log_no_roi").format(stid=stid), None
    raise NotImplementedError(
        f"{stid}: the whole-frame ROI 0 needs {SERIAL_SLICE}")


class PinnedPool:
    """Page-locked host buffers keyed by (shape, dtype).  A buffer goes
    back only after the chunk that used it completed: a non-blocking copy
    from or into page-locked memory runs after the call that issued it
    returns."""

    def __init__(self):
        self._free: Dict[tuple, List[torch.Tensor]] = {}

    def get(self, shape, dtype) -> torch.Tensor:
        lst = self._free.get((tuple(shape), dtype))
        if lst:
            return lst.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def put(self, buf: torch.Tensor) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)


def run_intensity_batched(
    folder: str,
    cfg: IntensityConfig,
    out_root: Optional[str] = None,
    log=print,
    batch_size: int = 8,
    prefetch_workers: int = 8,
    cancel=None,
    device="cuda",
) -> List[dict]:
    """Batched, tables-only (XLS/CSV) intensity run over an experiment
    *folder*: chunks of keys quantify in ONE device step each, with two
    chunks in flight so host decode of chunk k+1 overlaps the device work
    of chunk k.  *device* is ``"cuda"`` (default; raises without a card)
    or ``"cpu"`` (the plain PyTorch version, for tests).  Returns the rows
    in key order."""
    from ..ops.roistats import (
        choose_tile, gather_tiles, pad_local_polys, tile_offsets,
    )
    from ..parallel import runner
    from ..parallel.runner import PrefetchLoader, make_autoscaler, stream_batches
    from ..report.excel import save_intensity_excel

    dev = resolve_device(device)
    if cfg.bg_scope != "full":
        raise NotImplementedError(
            f"bg_scope={cfg.bg_scope!r} needs {SERIAL_SLICE}")
    if cfg.do_tif or cfg.do_png or cfg.save_raw_crop_tif:
        raise NotImplementedError(f"TIF/PNG image outputs need {SERIAL_SLICE}")

    files = naming.list_tifs(folder)
    keymap = naming.build_keymap(files, cfg.timelapse, cfg.grammar)
    keymap = _apply_subset(keymap, cfg, log)
    roi_dir = os.path.join(folder, "roi")
    out_root = out_root or os.path.join(folder, "RES")

    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    staging = PinnedPool() if cuda else None
    hist_stride = (max(1, cfg.bg_stride)
                   if cfg.bg_mode in ("percentile", "hist-mode") else 0)
    tile_hint: Dict[str, int] = {}
    # recycled decode buffers: finalize()/run_serial() return each key's
    # frames and host tiles once nothing reads them
    frame_pool = native.FrameBufferPool()

    def _fit_hint(polys, H, W):
        """(tile, n_bucket) of the session hint (set by the first key) when
        this key fits it, else None.  A key whose FRAME is smaller than the
        hint tile does not fit: classify routes it to the serial path."""
        t_need = choose_tile(polys, H, W)
        if t_need is None:
            return None
        t_used = tile_hint.setdefault("tile", t_need)
        nb_used = tile_hint.setdefault("nb", _bucket(len(polys), 2))
        if t_need <= t_used <= min(H, W) and len(polys) <= nb_used:
            return t_used, nb_used
        return None

    def _pre_pad(polys, offs, nb_used):
        """Tile-local polygons padded to the session vertex hint, or
        (None, None) when the key outgrows it (dispatch pads then)."""
        max_v = max(len(p) for p in polys)
        vb_used = tile_hint.setdefault("vb", _bucket(max_v, 32))
        if max_v > vb_used:
            return None, None
        lp, _, valid = pad_local_polys(polys, offs, nb_used, vb_used)
        return lp, valid

    def _load_fused(kv):
        """ROI json first (so tile offsets are known), then ONE GIL-free
        native call doing decode + strided histogram + ROI-tile extraction.
        Returns a loader item, or None to fall back to the
        decode-then-gather path (non-u16 frames, no ROI json, hint misses,
        native missing)."""
        key, chmap = kv
        s, t_code = key
        stid = s if t_code is None else f"{s}_{t_code}"
        chs, paths = _key_channels(chmap, cfg)
        if not chs:
            return None
        info = native.tiff_info(paths[0])
        if info is None or info[2] != 16 or info[3] != 1:
            return None
        H, W = info[0], info[1]
        base = naming.find_roi_basepath(
            roi_dir, os.path.basename(paths[0]), cfg.timelapse, cfg.grammar)
        if not os.path.exists(base + ".json"):
            return None
        polys = roiio.load_roi_polygons(base + ".json")
        fit = _fit_hint(polys, H, W) if polys else None
        if fit is None:
            return None
        t_used, nb_used = fit
        offs = tile_offsets(polys, H, W, t_used)
        res = native.decode_tiff_batch_hist_tiles(
            paths, hist_stride, np.asarray(offs, np.int32), t_used,
            pad_tiles=nb_used - len(polys), pool=frame_pool)
        if res is None:
            return None
        imgs, hists, tiles_np = res
        bgs = _host_bg(imgs, chs, cfg, hists)
        lp, valid = _pre_pad(polys, offs, nb_used)
        return key, (stid, (chs, imgs, polys, None)), bgs, (
            t_used, tiles_np, offs, lp, valid)

    def _load(kv):
        """Fused path first; else decode, then gather the tiles with numpy
        at the session's tile hint (when the key fits it)."""
        try:
            item = _load_fused(kv)
        except Exception:  # noqa: BLE001 — any fused-path surprise falls
            item = None    # back to the general loader below
        if item is not None:
            return item
        key = kv[0]
        stid, payload, hists = load_key(key, kv[1], roi_dir, cfg,
                                        hist_stride=hist_stride,
                                        pool=frame_pool)
        if isinstance(payload, str):
            return key, (stid, payload), None, None
        chs, imgs, polys, _ = payload
        bgs = _host_bg(imgs, chs, cfg, hists)
        fit = _fit_hint(polys, *imgs.shape[1:])
        if fit is None:
            return key, (stid, payload), bgs, None
        t_used, nb_used = fit
        offs = tile_offsets(polys, *imgs.shape[1:], t_used)
        tiles = gather_tiles(imgs, offs, nb_used, t_used)
        return key, (stid, payload), bgs, (
            t_used, tiles, offs, *_pre_pad(polys, offs, nb_used))

    loader = PrefetchLoader(
        _load, list(keymap.items()), workers=max(1, prefetch_workers),
        ahead=32,
    )
    _cur_bs, _maybe_grow_chunk = make_autoscaler(loader, batch_size)
    rows_all: List[dict] = []
    n_done = 0

    def _emit_rows(key, chs, n_roi, packed, bgs):
        """Rows of one key from its packed (10, C, N) result."""
        s, t_code = key
        for i in range(n_roi):
            row = {
                "stage": s,
                "time": t_code if cfg.timelapse else None,
                "roi": i + 1,
                "area_px": int(packed[len(STAT_FIELDS), 0, i]),
                "bg_mode": cfg.bg_mode,
                "bg_scope": cfg.bg_scope,
                "clip_neg": bool(cfg.clip_neg),
                "bg_stride": int(cfg.bg_stride),
            }
            for ci, ch in enumerate(chs):
                for k, f in enumerate(STAT_FIELDS):
                    v = packed[k, ci, i]
                    row[f"ch{ch}_{f}"] = int(v) if f == "npx" else float(v)
                row[f"ch{ch}_bg"] = float(bgs[ci])
                row[f"ch{ch}_p"] = float(
                    cfg.per_channel_p.get(ch, cfg.percentile))
                row[f"ch{ch}_color"] = cfg.channel_colors.get(ch, "Grayscale")
            rows_all.append(row)

    def _to_device(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(dev, non_blocking=True)

    def _step(tiles_b, lp_b, val_b, bgs_b):
        return runner.batched_tile_stats_step(
            tiles_b, _to_device(lp_b), _to_device(val_b), _to_device(bgs_b),
            clip_neg=cfg.clip_neg)

    def run_serial(entry):
        """A key the batch program can't take: the same tile step as a
        batch of one, with its own tile size, synchronously."""
        nonlocal n_done
        key, stid, (chs, imgs, polys, _), bgs = entry
        if imgs.dtype != np.uint16:
            raise NotImplementedError(
                f"{stid}: {imgs.dtype} frames need {SERIAL_SLICE}")
        H, W = imgs.shape[1:]
        tile = choose_tile(polys, H, W)
        if tile is None:
            raise NotImplementedError(
                f"{stid}: an ROI needs the full frame: {SERIAL_SLICE}")
        offs = tile_offsets(polys, H, W, tile)
        nb = _bucket(len(polys))
        lp, _, valid = pad_local_polys(
            polys, offs, nb, _bucket(max(len(p) for p in polys), 32))
        tiles = torch.from_numpy(gather_tiles(imgs, offs, nb, tile)[None])
        packed = _step(tiles.to(dev), lp[None], valid[None], bgs[None])
        _emit_rows(key, chs, len(polys), packed[0].cpu().numpy(), bgs)
        log(t("log_done_quant").format(stid=stid, roi_count=len(polys)))
        n_done += 1
        frame_pool.put(imgs)

    def dispatch(chunk):
        """Build the padded chunk and launch its device step WITHOUT
        synchronizing; None when the chunk can't take the batch step."""
        all_p = [poly for _, _, (_, _, polys, _), *_ in chunk for poly in polys]
        H, W = chunk[0][2][1].shape[1:]
        tile = choose_tile(all_p, H, W)
        if tile is None:
            return None
        # the loader's pre-gather hint, clamped to this chunk's frame
        tile = min(max(tile, tile_hint.get("tile", tile)), min(H, W))
        max_n = max(len(c[2][2]) for c in chunk)
        nb_hint = tile_hint.get("nb")
        nb = nb_hint if nb_hint is not None and max_n <= nb_hint \
            else _bucket(max_n, 8)
        max_v = max(len(poly) for poly in all_p)
        vb_hint = tile_hint.get("vb")
        vb = vb_hint if vb_hint is not None and max_v <= vb_hint \
            else _bucket(max_v, 32)
        B = len(chunk)
        C = chunk[0][2][1].shape[0]
        lp_b = np.zeros((B, nb, vb, 2), np.float32)
        val_b = np.zeros((B, nb), bool)
        bgs_b = np.zeros((B, C), np.float32)
        shape = (B, nb, C, tile, tile)
        if cuda:
            # int16 storage read as uint16: the staging buffer is filled
            # through numpy and reinterpreted on the device
            tiles_buf = staging.get(shape, torch.int16)
            tiles_np = tiles_buf.numpy().view(np.uint16)
        else:
            tiles_np = np.empty(shape, np.uint16)
        for bi, (key, _, (chs, imgs, polys, _), bgs_pre, pre) in enumerate(
                chunk):
            if pre is not None and pre[0] == tile:
                tiles_i, offs = pre[1], pre[2]
            else:  # hint missed (first keys raced / ROI outgrew it)
                offs = tile_offsets(polys, H, W, tile)
                tiles_i = gather_tiles(imgs, offs, nb, tile)
            k = min(tiles_i.shape[0], nb)
            tiles_np[bi, :k] = tiles_i[:k]
            tiles_np[bi, k:] = 0
            if (pre is not None and pre[0] == tile and pre[3] is not None
                    and pre[3].shape == (nb, vb, 2)):
                lp, valid = pre[3], pre[4]  # loader pre-padded
            else:
                lp, _, valid = pad_local_polys(polys, offs, nb, vb)
            lp_b[bi], val_b[bi] = lp, valid
            bgs_b[bi] = bgs_pre if bgs_pre is not None else _host_bg(
                imgs, chs, cfg)
        if not cuda:
            packed = _step(torch.from_numpy(tiles_np), lp_b, val_b, bgs_b)
            return chunk, packed.numpy(), bgs_b, None, ()
        with torch.cuda.stream(side):
            tiles_d = tiles_buf.to(dev, non_blocking=True).view(torch.uint16)
            packed = _step(tiles_d, lp_b, val_b, bgs_b)
            out = staging.get(tuple(packed.shape), torch.float32)
            out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return chunk, out, bgs_b, done, (tiles_buf, out)

    def finalize(rec):
        """Wait for a dispatched chunk, emit its rows, recycle its host
        buffers."""
        nonlocal n_done
        chunk, packed, bgs, done, staged = rec
        try:  # no side effects yet, so a failure is safe to retry serially
            if done is not None:
                done.synchronize()
                packed = packed.numpy()
        except Exception as e:  # noqa: BLE001
            raise runner.EmitFetchError(str(e)) from e
        for bi, (key, _, (chs, _, polys, _), *_) in enumerate(chunk):
            _emit_rows(key, chs, len(polys), packed[bi], bgs[bi])
        n_done += len(chunk)
        # the chunk's copies are complete: its frames, host tiles and
        # staging buffers can be reused
        for entry in chunk:
            frame_pool.put(entry[2][1])
            pre = entry[4]
            if pre is not None:
                frame_pool.put(pre[1])
        for buf in staged:
            staging.put(buf)
        _maybe_grow_chunk()
        log(t("batch_progress").format(done=n_done))

    sig = None        # dominant (shape, channel set), set by the first key

    def classify(item):
        nonlocal sig
        key, (stid, payload), bgs_pre, pre = item
        if isinstance(payload, str):
            log(payload)
            return "skip", None
        chs, imgs, _, _ = payload
        if sig is None:
            sig = (imgs.shape, tuple(chs))
        if imgs.dtype != np.uint16 or (imgs.shape, tuple(chs)) != sig:
            return "serial", (key, stid, payload, bgs_pre)
        return "batch", (key, stid, payload, bgs_pre, pre)

    was_cancelled = stream_batches(
        loader, _cur_bs, classify, dispatch, finalize, run_serial,
        lambda err: log(t("err_worker").format(key=err.item[0],
                                               error=err.error)),
        cancel=cancel,
    )
    if was_cancelled:
        log(t("cancelled"))

    if cfg.do_xls and rows_all:
        xls_dir = os.path.join(out_root, "xls")
        os.makedirs(xls_dir, exist_ok=True)
        save_intensity_excel(rows_all, keymap, xls_dir)
    return rows_all
