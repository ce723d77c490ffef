"""Per-ROI fluorescence intensity: the serial runner and the batched,
tables-only runner.

Port of ``imageprocess_tpu/pipelines/intensity.py``.

The serial runner (``run_intensity``, the CLI's default) takes one
(stage, time) key at a time, with one key in flight: the host decodes the
channel TIFFs (the native decoder, PIL for files it does not take) and
loads the ROIs (polygons, a PNG union mask, or none: the whole frame as
ROI 0); ``submit_key`` uploads the raw frames through page-locked staging
and runs the device program without synchronising:

- ``intensity_step_tiled`` when every polygon fits a tile and the
  background scope is the full frame: the background per channel from the
  strided raw frame (``ops.background.bg_value``), clip(x - bg), and the
  statistics of each ROI's tile (``ops.roistats.roi_stats_tiled``, the
  ``roistats_f32`` kernel on CUDA tensors);
- ``intensity_step`` otherwise (an ROI-union background scope, a mask, the
  whole frame, an ROI that needs the full frame): the same over full-frame
  masks (``ops.roistats.roi_stats_full``, the kernel's frame form
  ``roistats_f32_frame`` on CUDA tensors).

``finalize_key`` brings the statistics, areas and backgrounds back in one
copy and makes the rows.

The batched runner (``run_intensity_batched``), per chunk of keys:

1. host, prefetch threads: one native call decodes the channel TIFFs,
   builds the strided u16 histogram and cuts each ROI's tile
   (``native.decode_tiff_batch_hist_tiles``); the per-channel background
   comes from that histogram (``_host_bg``);
2. device, once per chunk: the tiles are copied into page-locked staging,
   sent with one non-blocking copy on a side stream, and
   ``parallel.runner.batched_tile_stats_step`` rasterizes the polygons and
   launches the tile-statistics kernel on that stream; one non-blocking
   copy brings the packed (B, 10, C, N) result back into page-locked
   memory, and a CUDA event marks the chunk done.  With a ``mesh=`` the
   chunk's batch axis is split over its devices: every shard's block goes
   up and launches on its own device (``parallel.runner.dispatch_shards``)
   before any result is fetched;
3. ``finalize`` waits on the events, turns the result into rows and only
   then recycles the chunk's host buffers (the copies read them late);
   ``report.excel`` writes the tables.

Keys the batch program cannot take (another frame shape, non-u16 frames,
no polygons, an ROI that needs the full frame) run ``process_key`` in key
order; a ``bg_scope`` other than ``"full"`` runs the serial runner
throughout.

Image outputs: with ``do_tif`` or ``do_png`` the serial runner copies each
key's corrected frames to the host (page-locked staging on a card, and only
then) and ``report.render.save_intensity_images`` writes the float32 TIFFs
and their 16-bit previews, the full-frame and per-ROI crop PNGs and, with
``save_raw_crop_tif``, the raw-value crop TIFFs (they come with the PNG
crops and are written by nothing else); the batched runner hands such a
config to the serial runner.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..core import i18n, naming
from ..core import roiio, tiffio
from ..device import resolve_device
from ..geom.polygon import pad_polygons
from ..geom.rasterize import rasterize_polygons
from ..ops.background import as_float32, bg_value
from ..ops.percentile import p1000_of
from ..ops.roistats import (
    choose_tile, pad_local_polys, roi_stats_full, roi_stats_tiled, tile_offsets,
)
from ..ops.stats import STAT_FIELDS
from ..report.excel import XLS_COUNTERS
from ..report.render import PanelPngOptions
from ..timing import HostPhases, call_range

t = i18n.t
ChannelGrammar = naming.ChannelGrammar
@dataclass
class IntensityConfig:
    """The JAX package's ``IntensityConfig``, field for field (names and
    defaults); ``png_full`` / ``png_crop`` default to a
    ``report.render.PanelPngOptions()`` each."""

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

    def __post_init__(self):
        if self.png_full is None:
            self.png_full = PanelPngOptions()
        if self.png_crop is None:
            self.png_crop = PanelPngOptions()


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
    """Host side of one (stage, time) key: TIFF decode (the native decoder,
    with the strided histograms when *hist_stride* >= 1; ``core.tiffio``
    per file when it does not take the files) + ROI load.  Returns (stid,
    payload, hists): payload is (chs, imgs, polys, union_mask) -- polys
    None with a PNG union mask, both None for the whole frame as ROI 0 --
    or a skip message; hists are the decoder's histograms or None."""
    s, t_code = key
    stid = s if t_code is None else f"{s}_{t_code}"
    chs, paths = _key_channels(chmap, cfg)
    if not chs:
        return stid, t("log_no_ch").format(stid=stid), None
    res = native.decode_tiff_batch_hist(paths, hist_stride, pool=pool)
    if res is not None and res[0].ndim == 3:
        imgs, hists = res
    else:  # a layout the decoder does not take, or RGB: channel 0
        imgs = np.stack([tiffio.read_2d(p, dtype=None) for p in paths])
        hists = None
    H, W = imgs.shape[1:]
    base = naming.find_roi_basepath(
        roi_dir, os.path.basename(paths[0]), cfg.timelapse, cfg.grammar)
    polys, union_mask = roiio.load_polys_or_mask(base, (H, W))
    if polys is None and union_mask is None and cfg.skip_no_roi:
        return stid, t("log_no_roi").format(stid=stid), None
    return stid, (chs, imgs, polys, union_mask), hists


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


def to_device(arr: np.ndarray, dev: torch.device, staging: Optional[PinnedPool],
              held: List[torch.Tensor]) -> torch.Tensor:
    """*arr* as a tensor on *dev*.  With a *staging* pool, through a
    page-locked buffer and a non-blocking copy (the buffer goes to *held*:
    the caller returns it to the pool once the copy is certainly done);
    without one, a plain copy.  u16 travels as int16 storage and is read as
    uint16 on the device."""
    if dev.type == "cpu":
        return torch.from_numpy(np.ascontiguousarray(arr))
    u16 = arr.dtype == np.uint16
    src = np.ascontiguousarray(arr.view(np.int16) if u16 else arr)
    if staging is None:
        out = torch.from_numpy(src).to(dev)
    else:
        buf = staging.get(src.shape, torch.from_numpy(src[:0]).dtype)
        buf.numpy()[...] = src
        out = buf.to(dev, non_blocking=True)
        held.append(buf)
    return out.view(torch.uint16) if u16 else out


def to_host(x: torch.Tensor, staging: Optional[PinnedPool],
            held: List[torch.Tensor]) -> np.ndarray:
    """*x* as a host array.  A CUDA tensor is copied, without blocking, into
    a page-locked buffer of the *staging* pool: the array is valid once the
    stream is synchronised and until the caller returns the buffers in
    *held* to the pool.  A CPU tensor is viewed."""
    if x.device.type == "cpu":
        return x.numpy()
    buf = staging.get(tuple(x.shape), x.dtype)
    buf.copy_(x, non_blocking=True)
    held.append(buf)
    return buf.numpy()


@contextlib.contextmanager
def frames_on_host(tensors, dev: torch.device, staging: Optional[PinnedPool]):
    """The device *tensors* (None entries stay None) as host arrays for the
    body of the ``with``: one :func:`to_host` copy each, one synchronise,
    and the page-locked buffers go back to *staging* on exit.  The only way
    a full frame leaves the device: the image outputs use it, the tables
    never do."""
    held: List[torch.Tensor] = []
    arrays = [None if x is None else to_host(x, staging, held) for x in tensors]
    if held:
        torch.cuda.current_stream(dev).synchronize()
    try:
        yield arrays
    finally:
        for buf in held:
            staging.put(buf)


def _channel_bgs(imgs: torch.Tensor, p1000s, scope, bg_mode: str,
                 bg_stride: int) -> torch.Tensor:
    """(C,) float32 backgrounds of the raw frames (u16 frames keep their
    exact integer paths)."""
    if bg_mode == "none":
        return torch.zeros(imgs.shape[0], dtype=torch.float32, device=imgs.device)
    return torch.stack([bg_value(im, int(p), scope, bg_mode, bg_stride)
                        for im, p in zip(imgs, p1000s)])


def _corrected(imgs: torch.Tensor, bgs: torch.Tensor, clip_neg: bool) -> torch.Tensor:
    """clip(x - bg) in float32: the compact raw upload is cast on the card."""
    out = as_float32(imgs) - bgs[:, None, None]
    return torch.clamp(out, min=0.0) if clip_neg else out


def intensity_step(
    imgs: torch.Tensor,             # (C, H, W) raw u8 / u16 / float
    polys: torch.Tensor,            # (N, V, 2) float32, padded
    roi_valid: torch.Tensor,        # (N,) bool
    p1000s,                         # (C,) percentile-in-thousandths per channel
    masks_in: Optional[torch.Tensor] = None,  # (N, H, W) bool overrides polys
    *,
    bg_mode: str = "percentile",
    bg_scope: str = "full",
    clip_neg: bool = True,
    bg_stride: int = 4,
    use_masks: bool = False,
):
    """One (stage, time) key on the device over full-frame masks.  Returns
    (stats dict of (C, N), area_px (N,) int32, bgs (C,) float32, imgs_bc
    (C, H, W) float32)."""
    C, H, W = imgs.shape
    if use_masks:
        masks = masks_in & roi_valid[:, None, None]
    else:
        masks = rasterize_polygons(polys, (H, W)) & roi_valid[:, None, None]
    scope = masks.any(dim=0) if bg_scope == "roi_union" else None
    bgs = _channel_bgs(imgs, p1000s, scope, bg_mode, bg_stride)
    imgs_bc = _corrected(imgs, bgs, clip_neg)
    stats, area_px = roi_stats_full(imgs_bc, masks)
    return stats, area_px, bgs, imgs_bc


def intensity_step_tiled(
    imgs: torch.Tensor,             # (C, H, W) raw u8 / u16 / float
    local_polys: torch.Tensor,      # (N, V, 2) tile-local
    offsets: torch.Tensor,          # (N, 2) int32
    roi_valid: torch.Tensor,        # (N,)
    p1000s,                         # (C,)
    *,
    tile: int,
    bg_mode: str = "percentile",
    clip_neg: bool = True,
    bg_stride: int = 4,
):
    """Full-frame-scope background + ROI-local tiled statistics (same
    results as :func:`intensity_step`)."""
    bgs = _channel_bgs(imgs, p1000s, None, bg_mode, bg_stride)
    imgs_bc = _corrected(imgs, bgs, clip_neg).contiguous()
    stats, area = roi_stats_tiled(imgs_bc, local_polys, offsets, roi_valid, tile)
    return stats, area, bgs, imgs_bc


def _device_inputs(imgs: np.ndarray, polys: Optional[List[np.ndarray]],
                   union_mask: Optional[np.ndarray]):
    """(padded polygons, validity, masks or None, ROI count) of one key:
    the polygons, a PNG union mask as ROI 1, or the whole frame as ROI 0."""
    H, W = imgs.shape[1:]
    if polys is not None:
        n = len(polys)
        nb = _bucket(n)
        vb = _bucket(max(len(p) for p in polys), 32)
        pv = np.zeros((nb, vb, 2), np.float32)
        pv[:n] = pad_polygons([np.asarray(p, np.float32) for p in polys], vb)
        valid = np.zeros(nb, bool)
        valid[:n] = True
        return pv, valid, None, n
    if union_mask is not None:
        m = np.asarray(union_mask, bool)[None]
        return np.zeros((1, 32, 2), np.float32), np.ones(1, bool), m, 1
    return (np.zeros((1, 32, 2), np.float32), np.ones(1, bool),
            np.ones((1, H, W), bool), 1)


def _pack_key(stats, area, bgs) -> torch.Tensor:
    """Statistics (9 x C x N), areas (N) and backgrounds (C) of one key as
    one float64 vector (exact for every value): one copy brings them back."""
    return torch.cat([torch.stack([stats[f].to(torch.float64) for f in STAT_FIELDS])
                      .reshape(-1), area.to(torch.float64), bgs.to(torch.float64)])


def submit_key(key, chmap: Dict[int, str], roi_dir: str, cfg: IntensityConfig,
               loaded=None, device="cuda", staging: Optional[PinnedPool] = None):
    """Launch one key's device work WITHOUT synchronising.  Returns a
    pending record for :func:`finalize_key`, or (None, logs) when the key
    is skipped.  With a *staging* pool the uploads are non-blocking, so a
    caller that keeps one key in flight overlaps the host work of key k+1
    with the device work of key k."""
    dev = resolve_device(device)
    stid, payload = loaded if loaded is not None else \
        load_key(key, chmap, roi_dir, cfg)[:2]
    if isinstance(payload, str):
        return None, [payload]
    chs, imgs, polys, union_mask = payload
    H, W = imgs.shape[1:]
    p1000s = [p1000_of(cfg.per_channel_p.get(ch, cfg.percentile)) for ch in chs]
    held: List[torch.Tensor] = []

    def up(arr):
        return to_device(arr, dev, staging, held)

    # ROI-local tiles need polygons and a background scope that does not
    # need the union
    tile = None
    if polys is not None and cfg.bg_scope == "full":
        tile = choose_tile(polys, H, W)
    if tile is not None:
        n_roi = len(polys)
        offs = tile_offsets(polys, H, W, tile)
        pv, offs_pad, valid = pad_local_polys(
            polys, offs, _bucket(n_roi), _bucket(max(len(p) for p in polys), 32))
        stats, area_px, bgs, imgs_bc = intensity_step_tiled(
            up(imgs), up(pv), up(offs_pad), up(valid), p1000s, tile=tile,
            bg_mode=cfg.bg_mode, clip_neg=cfg.clip_neg, bg_stride=cfg.bg_stride)
    else:
        pv, valid, masks, n_roi = _device_inputs(imgs, polys, union_mask)
        stats, area_px, bgs, imgs_bc = intensity_step(
            up(imgs), up(pv), up(valid), p1000s,
            None if masks is None else up(masks), bg_mode=cfg.bg_mode,
            bg_scope=cfg.bg_scope, clip_neg=cfg.clip_neg,
            bg_stride=cfg.bg_stride, use_masks=masks is not None)
    return {
        "key": key, "stid": stid, "chs": chs, "polys": polys,
        "union_mask": union_mask, "shape": (H, W), "n_roi": n_roi,
        "n_bucket": valid.shape[0], "packed": _pack_key(stats, area_px, bgs),
        "imgs_bc": imgs_bc, "imgs_raw": imgs, "held": held,
    }, []


def finalize_key(pending, cfg: IntensityConfig,
                 staging: Optional[PinnedPool] = None):
    """Wait for a :func:`submit_key` record (one device-to-host copy of its
    statistics, areas and backgrounds) and make its rows.  The corrected
    frames stay on the device (``extras["imgs_bc_dev"]``).  Returns (rows,
    logs, extras)."""
    s, t_code = pending["key"]
    stid, chs, n_roi = pending["stid"], pending["chs"], pending["n_roi"]
    C, nb = len(chs), pending["n_bucket"]
    vals = pending["packed"].cpu().numpy()
    for buf in pending["held"]:  # the uploads are done: the copy synchronised
        staging.put(buf)
    stats = vals[:len(STAT_FIELDS) * C * nb].reshape(len(STAT_FIELDS), C, nb)
    area_px = vals[len(STAT_FIELDS) * C * nb:][:nb]
    bgs = vals[-C:]
    whole_frame = pending["polys"] is None and pending["union_mask"] is None
    rows = []
    for i in range(n_roi):
        row = {
            "stage": s,
            "time": t_code if cfg.timelapse else None,
            "roi": 0 if whole_frame else i + 1,
            "area_px": int(area_px[i]),
            "bg_mode": cfg.bg_mode,
            "bg_scope": cfg.bg_scope,
            "clip_neg": bool(cfg.clip_neg),
            "bg_stride": int(cfg.bg_stride),
        }
        for ci, ch in enumerate(chs):
            for k, f in enumerate(STAT_FIELDS):
                v = stats[k, ci, i]
                row[f"ch{ch}_{f}"] = int(v) if f == "npx" else float(v)
            row[f"ch{ch}_bg"] = float(bgs[ci])
            row[f"ch{ch}_p"] = float(cfg.per_channel_p.get(ch, cfg.percentile))
            row[f"ch{ch}_color"] = cfg.channel_colors.get(ch, "Grayscale")
        rows.append(row)
    logs = [t("log_done_quant").format(stid=stid, roi_count=n_roi)]
    extras = {"stid": stid, "chs": chs, "imgs_bc_dev": pending["imgs_bc"],
              "imgs_raw": pending["imgs_raw"], "polys": pending["polys"],
              "union_mask": pending["union_mask"], "shape": pending["shape"]}
    return rows, logs, extras


def process_key(key, chmap: Dict[int, str], roi_dir: str, cfg: IntensityConfig,
                loaded=None, device="cuda"
                ) -> Tuple[List[dict], List[str], Optional[dict]]:
    """One (stage, time) key synchronously: (rows, logs, extras)."""
    pending, logs = submit_key(key, chmap, roi_dir, cfg, loaded=loaded,
                               device=device)
    if pending is None:
        return [], logs, None
    return finalize_key(pending, cfg)


def run_intensity(
    folder: str,
    cfg: IntensityConfig,
    out_root: Optional[str] = None,
    log=print,
    prefetch_workers: int = 8,
    run_log: bool = False,
    progress: bool = False,
    cancel=None,
    device="cuda",
) -> List[dict]:
    """The intensity workload over an experiment *folder*, one key at a
    time with one key in flight (the CLI's default path): discover the
    TIFFs, build the (stage, time) -> {channel: path} keymap, quantify every
    key, write the per-ROI tables under ``RES/xls``.  TIFF decode runs in a
    thread pool *prefetch_workers* wide.

    *cancel*: an optional zero-argument callable checked between keys; the
    rows collected so far are still written.  ``run_log=True`` appends to
    ``RES/logs/run_<ts>.txt`` with [START]/[END] stamps; ``progress=True``
    reports ROI-weighted progress with an ETA.  A key that fails logs and is
    skipped.  *device* is ``"cuda"`` (default; raises without a card) or
    ``"cpu"``."""
    from ..core.runlog import Progress, RunLogger
    from ..parallel.runner import LoadError, PrefetchLoader
    from ..report import render
    from ..report.excel import save_intensity_excel

    dev = resolve_device(device)
    files = naming.list_tifs(folder)
    keymap = naming.build_keymap(files, cfg.timelapse, cfg.grammar)
    keymap = _apply_subset(keymap, cfg, log)
    roi_dir = os.path.join(folder, "roi")
    out_root = out_root or os.path.join(folder, "RES")

    logger = RunLogger(os.path.join(out_root, "logs"), echo=log) if run_log else log
    prog = None
    key_weight = {}  # a failed key steps its full weight, so the bar ends
    if progress:     # at 100 % and the ETA stays true
        for key, chmap in keymap.items():
            base = naming.find_roi_basepath(
                roi_dir, os.path.basename(next(iter(chmap.values()))),
                cfg.timelapse, cfg.grammar)
            key_weight[key] = max(1, roiio.count_rois(base))
        prog = Progress(sum(key_weight.values()), log=logger)

    staging = PinnedPool() if dev.type == "cuda" else None
    loader = PrefetchLoader(
        lambda kv: (kv[0], kv[1], load_key(kv[0], kv[1], roi_dir, cfg)[:2]),
        list(keymap.items()), workers=max(1, prefetch_workers))
    rows_all: List[dict] = []

    def drain(pending):
        rows, logs, extras = finalize_key(pending, cfg, staging)
        rows_all.extend(rows)
        for line in logs:
            logger(line)
        if prog is not None:
            prog.step(max(1, len(rows)), label=str(pending["key"][0]))
        if cfg.do_tif or cfg.do_png:
            # the corrected frames leave the device only for the images
            with frames_on_host([extras["imgs_bc_dev"]], dev, staging) as (bc,):
                render.save_intensity_images(dict(extras, imgs_bc=bc), cfg,
                                             out_root)

    try:
        in_flight = None  # one key pipelined: submit k+1, then drain k
        for item in loader:
            if isinstance(item, LoadError):
                logger(t("err_worker").format(key=item.item[0], error=item.error))
                if prog is not None:
                    prog.step(key_weight.get(item.item[0], 1))
                continue
            key, chmap, loaded = item
            if cancel is not None and cancel():
                logger(t("cancelled"))
                break
            # per-key error isolation: a corrupt frame logs and is skipped
            try:
                pending, logs = submit_key(key, chmap, roi_dir, cfg,
                                           loaded=loaded, device=dev,
                                           staging=staging)
            except Exception as e:  # noqa: BLE001
                logger(t("err_worker").format(key=key, error=e))
                pending, logs = None, []
            for line in logs:
                logger(line)
            if pending is None:
                if prog is not None:
                    prog.step(key_weight.get(key, 1), label=str(key[0]))
                continue
            if in_flight is not None:
                drain(in_flight)
            in_flight = pending
        if in_flight is not None:
            drain(in_flight)

        if cfg.do_xls and rows_all:
            xls_dir = os.path.join(out_root, "xls")
            os.makedirs(xls_dir, exist_ok=True)
            save_intensity_excel(rows_all, keymap, xls_dir)
            logger(t("saved_dir").format(dir=xls_dir))
    finally:
        if run_log:
            logger.close()
    return rows_all


@call_range
def run_intensity_batched(
    folder: str,
    cfg: IntensityConfig,
    out_root: Optional[str] = None,
    log=print,
    batch_size: int = 8,
    mesh=None,
    prefetch_workers: int = 8,
    cancel=None,
    device="cuda",
) -> List[dict]:
    """Batched, tables-only (XLS/CSV) intensity run over an experiment
    *folder*: chunks of keys quantify in ONE device step each, with two
    chunks in flight so host decode of chunk k+1 overlaps the device work
    of chunk k.  *device* is ``"cuda"`` (default; raises without a card)
    or ``"cpu"`` (the plain PyTorch version, for tests).  With a *mesh*
    (``parallel.runner.Mesh``) each chunk's batch axis is split over its
    devices, one kernel launch per shard, and a short trailing chunk pads
    to the chunk size with invalid lanes; keys the batch cannot take run
    on *device*.  Returns the rows in key order.  A ``bg_scope`` other
    than ``"full"``, ``do_tif`` or ``do_png`` runs :func:`run_intensity`
    (without the mesh, which the log line says)."""
    from ..ops.roistats import (
        choose_tile, gather_tiles, pad_local_polys, tile_offsets,
    )
    from ..parallel import runner
    from ..parallel.runner import (
        PrefetchLoader, make_autoscaler, round_batch_to_mesh, stream_batches,
    )
    from ..report.excel import save_intensity_excel

    dev = resolve_device(device)
    if cfg.bg_scope != "full" or cfg.do_tif or cfg.do_png:
        # the image outputs need the full frames on the host
        log(t("int_images_serial"))
        return run_intensity(folder, cfg, out_root=out_root, log=log,
                             prefetch_workers=prefetch_workers, cancel=cancel,
                             device=dev)

    # IP_TIMING=1: the JAX runner's per-phase host wall-time line (ld_*
    # sum over the prefetch threads; this loader uploads nothing, so
    # ld_upload stays 0 and the upload is under "upload"), then this
    # runner's other phases
    tm = HostPhases(("load_wait", "pack", "upload", "fetch", "emit", "xls",
                     "ld_decode", "ld_bg", "ld_gather", "ld_upload"),
                    extra=("plan", "classify", "serial", "recycle", "ld_roi"),
                    counters=XLS_COUNTERS)
    with tm("plan"):
        files = naming.list_tifs(folder)
        keymap = naming.build_keymap(files, cfg.timelapse, cfg.grammar)
        keymap = _apply_subset(keymap, cfg, log)
        roi_dir = os.path.join(folder, "roi")
        out_root = out_root or os.path.join(folder, "RES")

        shards = mesh if mesh is not None else runner.Mesh((dev,))
        cuda = any(d.type == "cuda" for d in shards.devices)
        streams = runner.side_streams(shards)
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
        with tm("ld_roi"):
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
        with tm("ld_decode"):
            res = native.decode_tiff_batch_hist_tiles(
                paths, hist_stride, np.asarray(offs, np.int32), t_used,
                pad_tiles=nb_used - len(polys), pool=frame_pool)
        if res is None:
            return None
        imgs, hists, tiles_np = res
        with tm("ld_bg"):
            bgs = _host_bg(imgs, chs, cfg, hists)
        with tm("ld_roi"):
            lp, valid = _pre_pad(polys, offs, nb_used)
        return key, (stid, (chs, imgs, polys, None)), bgs, (
            t_used, tiles_np, offs, lp, valid)

    def _load(kv):
        """Fused path first; else decode, then gather the tiles with numpy
        at the session's tile hint (when the key fits it)."""
        key = kv[0]
        with tm.key(key):
            try:
                item = _load_fused(kv)
            except Exception:  # noqa: BLE001 — any fused-path surprise falls
                item = None    # back to the general loader below
            if item is not None:
                return item
            with tm("ld_decode"):
                stid, payload, hists = load_key(key, kv[1], roi_dir, cfg,
                                                hist_stride=hist_stride,
                                                pool=frame_pool)
            if isinstance(payload, str):
                return key, (stid, payload), None, None
            chs, imgs, polys, _ = payload
            if polys is None or imgs.dtype != np.uint16:  # process_key's keys
                return key, (stid, payload), None, None
            with tm("ld_bg"):
                bgs = _host_bg(imgs, chs, cfg, hists)
            with tm("ld_roi"):
                fit = _fit_hint(polys, *imgs.shape[1:])
                if fit is None:
                    return key, (stid, payload), bgs, None
                t_used, nb_used = fit
                offs = tile_offsets(polys, *imgs.shape[1:], t_used)
            with tm("ld_gather"):
                tiles = gather_tiles(imgs, offs, nb_used, t_used)
            with tm("ld_roi"):
                lp, valid = _pre_pad(polys, offs, nb_used)
            return key, (stid, payload), bgs, (t_used, tiles, offs, lp, valid)

    with tm("plan"):
        loader = PrefetchLoader(
            _load, list(keymap.items()), workers=max(1, prefetch_workers),
            ahead=32,
        )
        batch_size = round_batch_to_mesh(batch_size, mesh)
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

    def run_serial(entry):
        """A key the batch program can't take: :func:`process_key`,
        synchronously."""
        nonlocal n_done
        with tm("serial"):
            key, stid, payload = entry[:3]  # a batch entry has more
            rows, logs, _ = process_key(key, None, roi_dir, cfg,
                                        loaded=(stid, payload), device=dev)
            rows_all.extend(rows)
            for line in logs:
                log(line)
            n_done += 1
            frame_pool.put(payload[1])

    def dispatch(chunk):
        """Build the padded chunk and launch its device step WITHOUT
        synchronizing; None when the chunk can't take the batch step."""
        with tm("pack"):
            packed = _pack(chunk)
        if packed is None:
            return None
        with tm("upload"):
            return _launch(chunk, *packed)

    def _pack(chunk):
        """The chunk's host arrays at its tile and buckets, or None."""
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
        # on a mesh a short trailing chunk pads to the chunk size (the
        # padded lanes are invalid and give no rows)
        pad_b = _cur_bs() if mesh is not None else B
        C = chunk[0][2][1].shape[0]
        lp_b = np.zeros((pad_b, nb, vb, 2), np.float32)
        val_b = np.zeros((pad_b, nb), bool)
        bgs_b = np.zeros((pad_b, C), np.float32)
        shape = (pad_b, nb, C, tile, tile)
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
        tiles_np[B:] = 0
        return (tiles_buf if cuda else None), tiles_np, lp_b, val_b, bgs_b

    def _launch(chunk, tiles_buf, tiles_np, lp_b, val_b, bgs_b):
        """Enqueue every shard's step: its block of the packed chunk goes
        up (on its device's side stream on a card, from page-locked
        staging), the kernel launches, and the result's copy to page-locked
        memory starts."""
        tiles = tiles_buf if tiles_buf is not None else torch.from_numpy(tiles_np)

        def block(d, lo, hi):
            return runner.batched_tile_stats_step(
                runner.to_shard(tiles[lo:hi], d).view(torch.uint16),
                *(runner.to_shard(a[lo:hi], d) for a in (lp_b, val_b, bgs_b)),
                clip_neg=cfg.clip_neg)

        parts = runner.dispatch_shards(shards, block, len(lp_b), staging=staging,
                                       streams=streams)
        return chunk, parts, bgs_b, (tiles_buf,) if cuda else ()

    def finalize(rec):
        """Wait for a dispatched chunk, emit its rows, recycle its host
        buffers."""
        nonlocal n_done
        chunk, parts, bgs, staged = rec
        try:  # no side effects yet, so a failure is safe to retry serially
            with tm("fetch"):
                packed = runner.fetch_shards(parts).numpy()
        except Exception as e:  # noqa: BLE001
            raise runner.EmitFetchError(str(e)) from e
        with tm("emit"):
            for bi, (key, _, (chs, _, polys, _), *_) in enumerate(chunk):
                _emit_rows(key, chs, len(polys), packed[bi], bgs[bi])
        with tm("recycle"):
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
            for host, done in parts:
                if done is not None:
                    staging.put(host)
            _maybe_grow_chunk()
            log(t("batch_progress").format(done=n_done))

    sig = None        # dominant (shape, channel set), set by the first key

    def classify(item):
        nonlocal sig
        with tm("classify"):
            key, (stid, payload), bgs_pre, pre = item
            if isinstance(payload, str):
                log(payload)
                return "skip", None
            chs, imgs, polys, _ = payload
            if sig is None and polys is not None:
                sig = (imgs.shape, tuple(chs))
            if (polys is None or imgs.dtype != np.uint16
                    or (imgs.shape, tuple(chs)) != sig):
                return "serial", (key, stid, payload)
            return "batch", (key, stid, payload, bgs_pre, pre)

    was_cancelled = stream_batches(
        tm.iterate(loader, "load_wait"), _cur_bs, classify, dispatch, finalize, run_serial,
        lambda err: log(t("err_worker").format(key=err.item[0],
                                               error=err.error)),
        cancel=cancel,
    )
    if was_cancelled:
        log(t("cancelled"))

    if cfg.do_xls and rows_all:
        xls_dir = os.path.join(out_root, "xls")
        os.makedirs(xls_dir, exist_ok=True)
        with tm("xls"):
            tm.count(save_intensity_excel(rows_all, keymap, xls_dir))
    tm.report()
    return rows_all
