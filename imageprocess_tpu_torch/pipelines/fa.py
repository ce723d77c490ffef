"""Focal-adhesion detection and quantification: the serial and the batched
tables runner.

Port of ``imageprocess_tpu/pipelines/fa.py``.  Reference semantics:
src/INT/FA_Analyzer.py -- ``analyze_fa_crop`` (:123-195: threshold
mu + alpha * sigma over the WHOLE image, remove_small (4-conn),
binary_closing(disk), 8-conn label, regionprops, area classification
OK / Large / Small, mean_corr = max(0, mean_raw - bg)), global statistics
with bg from a ``[::10, ::10]`` subsample (:624-626, 985-987), the batch
loop (:939-1052) and the merge report (:1054-1113).

The device program, plain PyTorch (the JAX package runs it in XLA, with no
Pallas kernel), for a chunk of frames at once and with no loop over frames
or cells:

1. per frame (``_global_stats_body``): the mean and the two-pass standard
   deviation of the finite pixels, accumulated in float64 and rounded once
   (so a frame's statistics do not depend on how many frames the chunk
   holds), and bg = the 1st percentile of the finite pixels of
   ``img[::10, ::10]``, from a sort of that sample alone;
2. per cell (``_fa_cells_body``), on each ROI's bbox tile grown by
   ``close_radius + 1``, all cells of all frames as one stack: the polygon
   mask (MPL edge rule), ``tile > threshold``, 4-connected
   remove-small against the float ``min_px``, the skimage closing, the
   8-connected labels with their overflow flag (``morphology.ccl``,
   ``morphology.binary``) and the region reductions
   (``morphology.regions.region_props``).

``fa_batched_step`` packs everything the tables need into one flat (B, K)
float32 array, K = 5 * nb * max_fa_per_cell + 5, so the batched runner
makes one device-to-host copy per chunk (``unpack_fa_flat``).  The batched
runner decodes in prefetch threads, uploads the chunk's frames as compact
u16 through page-locked staging on a side stream and keeps two chunks in
flight; a stage of another frame shape, or whose ROIs outgrow the run's
tile, takes the per-image path inline.  Both runners give the same rows.

The tables are written without pandas: the per-stage CSVs with the
formatter of ``report.excel`` (the bytes ``DataFrame.to_csv`` writes for
the same numbers), the master workbook grouped with plain dicts.  The
runners return ``{s_tag: rows}``, each row a dict in ``FA_CSV_COLS`` order,
where the JAX package returns DataFrames.

The per-stage overview figures (``save_fa_figs``, with the MATLAB
boundary overlay read by ``core.roiio`` through h5py) and the per-cell crop
PNGs (``export_fa_crops``) are drawn with PIL after the JAX package's
matplotlib geometry (``report.pilcomp``, ``report.render``); each reruns
``analyze_image`` per stage, as the JAX package does.

With ``mesh=`` the batched runner splits each chunk's frame axis over
the mesh's devices (``sharded_fa_batched_step``): every shard's frames go
up and its step runs on its own device before any result is fetched.  The
step's CCL reads a convergence flag from the host each round, so on a mesh
of distinct cards those reads take the shards in turn.
"""

from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..core import i18n, roiio, tiffio
from ..device import resolve_device
from ..geom.rasterize import EdgeRule, rasterize_polygons
from ..morphology import ccl
from ..morphology.binary import binary_closing_skimage, disk
from ..morphology.regions import region_props
from ..ops.background import as_float32
from ..ops.percentile import quantile_from_sorted
from ..ops.roi_stats_kernel import gather_roi_tiles
from ..ops.roistats import choose_tile, pad_local_polys, tile_offsets
from ..parallel import runner
from ..report import xlsxlite
from ..report.excel import _write_csv
from ..report.ticks import nonsingular
from ..timing import NO_TIMER
from .intensity import PinnedPool, _bucket, to_device

t = i18n.t

FA_CSV_COLS = ["File", "Cell_ID", "Category", "Area_px", "Area_um2",
               "Mean_Intensity_Raw", "Mean_Intensity_Corr",
               "Int_Density_Raw", "Int_Density_Corr", "Background_Level",
               "Used_Alpha", "Global_Threshold", "Min_Area_Setting",
               "Max_Area_Setting", "Close_Radius_Setting",
               "Subtract_BG_Setting"]


@dataclass
class FaConfig:
    """The JAX package's ``FaConfig``, field for field (names, defaults and
    derived properties)."""

    channel: int = 0
    px_size: float = 0.112          # µm/px (presets 0.112 / 0.223)
    alpha: float = 3.0
    min_area_um: float = 1.5
    max_area_um: float = 30.0
    close_radius: int = 1
    subtract_bg: bool = True
    save_ok_only: bool = False
    max_fa_per_cell: int = 256      # static bound for the device label pass
    do_master_report: bool = True
    master_name: str = "FA_Results_Master.xlsx"

    @property
    def min_px(self) -> float:
        return self.min_area_um / self.px_size ** 2

    @property
    def max_px(self) -> float:
        return self.max_area_um / self.px_size ** 2


def _global_stats_body(imgs: torch.Tensor):
    """(nanmean, nanstd ddof=0, bg = p1 of img[::10, ::10]) of each frame
    of (..., H, W), FA_Analyzer.py:624-626, as float32 tensors of the
    leading shape.  The elementwise arithmetic is float32 as in the JAX
    function; the two sums are accumulated in float64 and rounded once, so
    they do not depend on the reduction's order."""
    x = as_float32(imgs)
    finite = torch.isfinite(x)
    n = torch.clamp(finite.sum(dim=(-2, -1)).to(torch.float32), min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    m = torch.where(finite, x, zero).sum(dim=(-2, -1), dtype=torch.float64) \
        .to(torch.float32) / n
    dev2 = torch.where(finite, (x - m[..., None, None]) ** 2, zero)
    var = dev2.sum(dim=(-2, -1), dtype=torch.float64).to(torch.float32) / n
    # the sample's finite pixels sorted to the front: the same order
    # statistics as sorting the masked full frame
    sample = x[..., ::10, ::10]
    sample = sample.reshape(*sample.shape[:-2], -1)
    fin = torch.isfinite(sample)
    xs = torch.sort(torch.where(fin, sample, float("inf")), dim=-1).values
    bg = quantile_from_sorted(xs, fin.sum(dim=-1, dtype=torch.int32), 1000)
    return m, torch.sqrt(var), bg


def fa_global_stats(img, device="cuda"):
    """(mean, std, bg) of one frame (a numpy array or a tensor) as 0-dim
    float32 tensors on *device*."""
    dev = resolve_device(device)
    if not isinstance(img, torch.Tensor):
        img = to_device(np.asarray(img), dev, None, [])
    return _global_stats_body(img.to(dev))


def _threshold(m: torch.Tensor, s: torch.Tensor, alpha: float) -> torch.Tensor:
    """float32(m + alpha * s) with the sum taken in float64: the value the
    host computes from the fetched float32 mean and deviation."""
    return (m.to(torch.float64) + alpha * s.to(torch.float64)).to(torch.float32)


def _fa_cells_body(
    imgs, local_polys, offsets, roi_valid, threshold, min_px,
    *, tile: int, close_radius: int, max_labels: int, do_remove_small: bool,
    timer=NO_TIMER,
):
    """Per-cell FA segmentation + region reductions on bbox tiles, for
    every cell of every frame at once.  *imgs* (B, H, W) raw frames,
    *local_polys* (B, N, V, 2) tile-local, *offsets* (B, N, 2) [row, col],
    *roi_valid* (B, N), *threshold* (B,) float32, *min_px* a float.

    ROI masks use the matplotlib edge rule.  Returns (labels (B, N, t, t)
    int32, region properties of (B, N, max_labels) with ``n_labels``
    (B, N), overflow (B, N) bool)."""
    B, N = roi_valid.shape
    dev = imgs.device
    masks = rasterize_polygons(local_polys.reshape(B * N, *local_polys.shape[2:]),
                               (tile, tile), EdgeRule.MPL)
    masks = masks & roi_valid.reshape(-1)[:, None, None]
    frame = torch.arange(B, device=dev, dtype=torch.int32).repeat_interleave(N)
    offs = torch.cat([frame[:, None], offsets.reshape(-1, 2).to(torch.int32)], 1)
    tiles = gather_roi_tiles(as_float32(imgs)[:, None], offs, tile)[:, 0]
    bw = (tiles > threshold.repeat_interleave(N)[:, None, None]) & masks
    if do_remove_small:
        # remove_small_objects against the float min_size
        with timer.phase("remove_small"):
            roots = ccl.label_roots(bw, 1, timer)
        sizes = ccl._sizes_at(ccl._root_sizes(roots), roots)
        bw = bw & (sizes.to(torch.float32) >= torch.tensor(
            min_px, dtype=torch.float32, device=dev))
    if close_radius > 0:
        bw = binary_closing_skimage(bw, disk(close_radius))
    # with_overflow: a cell with > max_labels FAs would alias label slots
    # and emit wrong area/mean rows; surface it instead
    with timer.phase("label"):
        lab, over = ccl.label(bw, connectivity=2, max_labels=max_labels,
                              with_overflow=True, timer=timer)
    props = region_props(lab, tiles, max_labels=max_labels)
    shape = {k: v.reshape(B, N, *v.shape[1:]) for k, v in props.items()}
    return lab.reshape(B, N, tile, tile), shape, over.reshape(B, N)


def fa_analyze_tiled(img, local_polys, offsets, roi_valid, threshold, min_px,
                     *, tile: int, close_radius: int, max_labels: int,
                     do_remove_small: bool, timer=NO_TIMER):
    """:func:`_fa_cells_body` for one frame (H, W): (labels (N, t, t),
    properties of (N, max_labels), overflow (N,))."""
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    lab, props, over = _fa_cells_body(
        img[None], local_polys[None], offsets[None], roi_valid[None],
        thr.reshape(1), min_px, tile=tile, close_radius=close_radius,
        max_labels=max_labels, do_remove_small=do_remove_small, timer=timer)
    return lab[0], {k: v[0] for k, v in props.items()}, over[0]


# per-FA property fields packed for the batched single-fetch result
_FA_PACK_FIELDS = ("area", "mean", "centroid_r", "centroid_c")


def fa_batched_step(
    imgs: torch.Tensor,          # (B, H, W) raw dtype (u16 uploads compact)
    local_polys: torch.Tensor,   # (B, N, V, 2) tile-local
    offsets: torch.Tensor,       # (B, N, 2)
    roi_valid: torch.Tensor,     # (B, N)
    alpha: float,
    min_px: float,
    *,
    tile: int,
    close_radius: int,
    max_labels: int,
    do_remove_small: bool,
    timer=NO_TIMER,
) -> torch.Tensor:
    """A chunk of FA frames in one device program: per-image global
    statistics, threshold mu + alpha * sigma, and the per-cell chain.  The
    cell label images stay on the device; the result is one flat (B, K)
    float32 array: the 4 packed per-FA property fields + n_labels, then
    the 4 per-image scalars (mu, sigma, bg, threshold) and the per-image
    overflow flag."""
    B = imgs.shape[0]
    with timer.phase("global_stats"):
        m, s, bg = _global_stats_body(imgs)
    thr = _threshold(m, s, alpha)
    with timer.phase("cells"):
        _, props, over = _fa_cells_body(
            imgs, local_polys, offsets, roi_valid, thr, min_px, tile=tile,
            close_radius=close_radius, max_labels=max_labels,
            do_remove_small=do_remove_small, timer=timer)
    area = props["area"]
    pack = torch.stack(
        [props[f].to(torch.float32) for f in _FA_PACK_FIELDS]
        + [props["n_labels"].to(torch.float32)[..., None].expand(area.shape)],
        dim=1)                                          # (B, 5, N, L)
    return torch.cat([pack.reshape(B, -1), torch.stack([m, s, bg, thr], dim=1),
                      over.any(dim=1).to(torch.float32)[:, None]], dim=1)


def sharded_fa_batched_step(mesh, *, tile, close_radius, max_labels,
                            do_remove_small):
    """:func:`fa_batched_step` with its frame axis split over *mesh*
    (frames a multiple of the mesh size): ``run(imgs, local_polys,
    offsets, roi_valid, alpha, min_px)`` runs each shard's block on its
    device and returns the flat (B, K) table on the host."""
    def run(imgs, local_polys, offsets, roi_valid, alpha, min_px):
        return runner.run_sharded(
            mesh, fa_batched_step, imgs, local_polys, offsets, roi_valid,
            alpha=float(alpha), min_px=float(min_px), tile=tile,
            close_radius=close_radius, max_labels=max_labels,
            do_remove_small=do_remove_small)

    return run


def unpack_fa_flat(flat: np.ndarray, nb: int, max_labels: int):
    """Split :func:`fa_batched_step`'s flat result back into
    ({field: (B, N, L)}, n_labels (B, N) int, scalars (B, 4),
    overflow (B,) bool: True where a cell's FA count exceeded max_labels
    and the packed rows would alias)."""
    B = flat.shape[0]
    nf = len(_FA_PACK_FIELDS) + 1
    pack = flat[:, :nf * nb * max_labels].reshape(B, nf, nb, max_labels)
    scal = flat[:, -5:-1]
    over = flat[:, -1] > 0.0
    props = {f: pack[:, k] for k, f in enumerate(_FA_PACK_FIELDS)}
    n_labels = pack[:, nf - 1, :, 0].astype(np.int32)
    return props, n_labels, scal, over


def analyze_image(
    img: np.ndarray,
    rois: List[np.ndarray],
    cfg: FaConfig,
    stats: Optional[Tuple[float, float, float]] = None,
    device="cuda",
    timer=NO_TIMER,
) -> Tuple[List[dict], float, float, Dict]:
    """All FA rows for one image (batch semantics, global settings).
    Returns (raw per-FA dicts, threshold, bg, extras for rendering: the
    cell label tiles, their origins and the tile size).  *device* is
    ``"cuda"`` (default; raises without a card) or ``"cpu"``."""
    dev = resolve_device(device)
    H, W = img.shape
    img_d = to_device(np.asarray(img), dev, None, [])  # cast on the device
    if stats is None:
        m, s, bg = (float(v) for v in torch.stack(
            _global_stats_body(img_d)).cpu())
    else:
        m, s, bg = stats
    threshold = m + cfg.alpha * s

    if not rois:
        return [], threshold, bg, {}

    margin = cfg.close_radius + 1
    tile = choose_tile(rois, H, W, margin=margin)
    if tile is None:
        # pathological ROI larger than the short frame side: the biggest
        # square tile that fits (it clips nothing for cell-sized ROIs)
        tile = min(H, W)
    offs = tile_offsets(rois, H, W, tile, margin=margin)
    nb = _bucket(len(rois))
    vb = _bucket(max(len(p) for p in rois), 32)
    lpv, offs_pad, valid = pad_local_polys(rois, offs, nb, vb)

    labs, props, over = fa_analyze_tiled(
        img_d, torch.from_numpy(lpv).to(dev), torch.from_numpy(offs_pad).to(dev),
        torch.from_numpy(valid).to(dev), threshold, cfg.min_px,
        tile=tile, close_radius=int(cfg.close_radius),
        max_labels=cfg.max_fa_per_cell, do_remove_small=cfg.min_px > 0,
        timer=timer)
    if bool(over.any()):
        raise ValueError(
            f"a cell contains more than max_fa_per_cell="
            f"{cfg.max_fa_per_cell} focal adhesions — label slots would "
            "alias and the report rows would be wrong; re-run with a "
            "larger --max-fa-per-cell")
    labs = labs.cpu().numpy()
    props = {k: v.cpu().numpy() for k, v in props.items()}

    fa_rows: List[dict] = []
    for i in range(len(rois)):
        n = int(props["n_labels"][i])
        for r in range(n):
            area = float(props["area"][i, r])
            mean_raw = float(props["mean"][i, r])
            category = "OK"
            if area < cfg.min_px:
                category = "Small"
            elif area > cfg.max_px:
                category = "Large"
            mean_corr = max(0.0, mean_raw - bg) if cfg.subtract_bg else mean_raw
            fa_rows.append({
                "cell": i + 1,
                "label": r + 1,
                "category": category,
                "area": area,
                "mean_int_raw": mean_raw,
                "mean_int_corr": mean_corr,
                "int_den_raw": mean_raw * area,
                "int_den_corr": mean_corr * area,
                "bg_level": bg,
                "centroid": (float(props["centroid_r"][i, r]) + offs[i, 0],
                             float(props["centroid_c"][i, r]) + offs[i, 1]),
            })
    extras = {"labels": labs, "offsets": offs, "tile": tile}
    return fa_rows, threshold, bg, extras


def _load_rois(json_path: str) -> List[np.ndarray]:
    """FA's permissive ROI JSON reader (FA_Analyzer.py:650-658)."""
    data = roiio.load_roi_bundle(json_path)
    rois = []
    for item in data.get("rois", []):
        pts = item if isinstance(item, list) else item.get("rois", item)
        if pts:
            rois.append(np.array(pts))
    return rois


def list_fa_pairs(img_dir: str, roi_dir: str, channel: int):
    """(img_path, json_path, s_tag) triples: plain-sorted ``*.tif`` filtered
    by ``_{ch}.tif`` substring, s_tag = first ``_`` token, JSON must exist
    (FA_Analyzer.py:544-564)."""
    out = []
    for img_path in sorted(glob.glob(os.path.join(img_dir, "*.tif"))) + \
            sorted(glob.glob(os.path.join(img_dir, "*.TIF"))):
        fname = os.path.basename(img_path)
        if f"_{channel}.tif" in fname or f"_{channel}.TIF" in fname:
            s_tag = fname.split("_")[0]
            json_path = os.path.join(roi_dir, f"{s_tag}.json")
            if os.path.exists(json_path):
                out.append((img_path, json_path, s_tag))
    return out


def _fa_file_rows(s_tag: str, fa_iter, th_val: float, bg: float,
                  cfg: FaConfig) -> List[dict]:
    """CSV-schema rows for one stage from per-FA (cell, area, mean_raw)
    tuples (the category comes from the config's area thresholds): shared
    by the serial and the batched runner."""
    rows = []
    for cell, area, mean_raw in fa_iter:
        category = "OK"
        if area < cfg.min_px:
            category = "Small"
        elif area > cfg.max_px:
            category = "Large"
        if cfg.save_ok_only and category != "OK":
            continue
        mean_corr = max(0.0, mean_raw - bg) if cfg.subtract_bg else mean_raw
        rows.append({
            "File": s_tag,
            "Cell_ID": cell,
            "Category": category,
            "Area_px": area,
            "Area_um2": area * cfg.px_size ** 2,
            "Mean_Intensity_Raw": mean_raw,
            "Mean_Intensity_Corr": mean_corr,
            "Int_Density_Raw": mean_raw * area,
            "Int_Density_Corr": mean_corr * area,
            "Background_Level": bg,
            "Used_Alpha": cfg.alpha,
            "Global_Threshold": th_val,
            "Min_Area_Setting": cfg.min_area_um,
            "Max_Area_Setting": cfg.max_area_um,
            "Close_Radius_Setting": cfg.close_radius,
            "Subtract_BG_Setting": cfg.subtract_bg,
        })
    return rows


def _write_stage(indiv_dir: str, s_tag: str, file_rows: List[dict],
                 results: Dict[str, List[dict]]) -> None:
    """``individual_results/{s_tag}_results.csv`` of a stage that has rows,
    cells formatted as ``DataFrame.to_csv`` formats them."""
    if not file_rows:
        return
    _write_csv(os.path.join(indiv_dir, f"{s_tag}_results.csv"), FA_CSV_COLS,
               [[r[c] for c in FA_CSV_COLS] for r in file_rows])
    results[s_tag] = file_rows


def _stage_rows(s_tag: str, fa_rows: List[dict], th_val: float, bg: float,
                cfg: FaConfig) -> List[dict]:
    return _fa_file_rows(
        s_tag, ((fa["cell"], fa["area"], fa["mean_int_raw"]) for fa in fa_rows),
        th_val, bg, cfg)


def run_fa_batch(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    log=print,
    cancel=None,
    device="cuda",
) -> Dict[str, List[dict]]:
    """Batch process (FA_Analyzer.py:939-1052), one image at a time:
    per-stage CSVs under ``individual_results/`` + the optional master
    report.  Returns ``{s_tag: rows}``.  *device* is ``"cuda"`` (default;
    raises without a card) or ``"cpu"``."""
    dev = resolve_device(device)
    indiv_dir = os.path.join(out_root, "individual_results")
    os.makedirs(indiv_dir, exist_ok=True)
    pairs = list_fa_pairs(img_dir, roi_dir, cfg.channel)
    results: Dict[str, List[dict]] = {}
    for img_path, json_path, s_tag in pairs:
        if cancel is not None and cancel():
            log(t("cancelled"))
            break
        log(t("fa_processing").format(tag=s_tag))
        # per-file isolation: one unreadable TIFF or JSON logs and the run
        # goes on (FA_Analyzer.py:978-981)
        try:
            img = tiffio.read_2d(img_path, squeeze="smallest_axis")
            rois = _load_rois(json_path)
        except Exception as e:  # noqa: BLE001
            log(t("fa_load_failed").format(tag=s_tag, err=e))
            continue
        fa_rows, th_val, bg, _ = analyze_image(img, rois, cfg, device=dev)
        _write_stage(indiv_dir, s_tag,
                     _stage_rows(s_tag, fa_rows, th_val, bg, cfg), results)
    if cfg.do_master_report and results:
        merge_fa_report(out_root, cfg.master_name, log=log)
    return results


def run_fa_batched(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    log=print,
    batch_size: int = 4,
    mesh=None,
    prefetch_workers: int = 8,
    cancel=None,
    device="cuda",
    timer=NO_TIMER,
) -> Dict[str, List[dict]]:
    """Streaming batched FA tables (same outputs as :func:`run_fa_batch`):
    prefetch-thread decode overlaps device compute, frames chunk into one
    device program (:func:`fa_batched_step`) with one result copy per
    chunk, two chunks in flight.  Stages whose frame shape or ROI geometry
    falls outside the run's hints take the per-image path inline.
    *device* is ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    With a *mesh* each chunk's frame axis is split over its devices, and a
    short trailing chunk pads to the chunk size with zero frames and
    invalid lanes; stages the batch cannot take run on *device*."""
    dev = resolve_device(device)
    indiv_dir = os.path.join(out_root, "individual_results")
    os.makedirs(indiv_dir, exist_ok=True)
    pairs = list_fa_pairs(img_dir, roi_dir, cfg.channel)
    results: Dict[str, List[dict]] = {}
    margin = cfg.close_radius + 1
    shards = mesh if mesh is not None else runner.Mesh((dev,))
    cuda = any(d.type == "cuda" for d in shards.devices)
    streams = runner.side_streams(shards)
    staging = PinnedPool() if cuda else None
    frame_pool = native.FrameBufferPool()

    def _load(pair):
        img_path, json_path, s_tag = pair
        res = native.decode_tiff_batch_hist([img_path], 0, pool=frame_pool)
        if res is not None and res[0].ndim == 3:
            img = res[0][0]  # (1, H, W) view; base recycled in finalize
        else:
            img = tiffio.read_2d(img_path, dtype=None, squeeze="smallest_axis")
        return s_tag, img, _load_rois(json_path)

    loader = runner.PrefetchLoader(_load, pairs, workers=max(1, prefetch_workers))
    batch_size = runner.round_batch_to_mesh(batch_size, mesh)
    hint: Dict[str, int] = {}
    step_kw = dict(close_radius=int(cfg.close_radius),
                   max_labels=cfg.max_fa_per_cell,
                   do_remove_small=cfg.min_px > 0, timer=timer)

    def run_serial(entry):
        s_tag, img, rois = entry
        fa_rows, th_val, bg, _ = analyze_image(img, rois, cfg, device=dev,
                                               timer=timer)
        _write_stage(indiv_dir, s_tag,
                     _stage_rows(s_tag, fa_rows, th_val, bg, cfg), results)
        frame_pool.put(img.base)

    sig = None

    def classify(item):
        nonlocal sig
        s_tag, img, rois = item
        log(t("fa_processing").format(tag=s_tag))
        if not rois:
            return "skip", None
        H, W = img.shape
        tile = choose_tile(rois, H, W, margin=margin)
        if sig is None and tile is not None:
            sig = (img.shape, img.dtype)
            hint.setdefault("tile", tile)
            hint.setdefault("nb", _bucket(len(rois)))
            hint.setdefault("vb", _bucket(max(len(p) for p in rois), 32))
        if ((img.shape, img.dtype) != sig or tile is None
                or tile > hint["tile"] or len(rois) > hint["nb"]
                or max(len(p) for p in rois) > hint["vb"]):
            return "serial", item
        return "batch", item

    def dispatch(chunk):
        """Stack and send the chunk, launch each shard's device program
        WITHOUT synchronising."""
        tile, nb, vb = hint["tile"], hint["nb"], hint["vb"]
        B = len(chunk)
        # on a mesh a short trailing chunk pads to the chunk size with zero
        # frames and invalid lanes, which give no rows
        pad_b = batch_size if mesh is not None else B
        H, W = chunk[0][1].shape
        lp_b = np.zeros((pad_b, nb, vb, 2), np.float32)
        off_b = np.zeros((pad_b, nb, 2), np.int32)
        val_b = np.zeros((pad_b, nb), bool)
        for bi, (_, _, rois) in enumerate(chunk):
            offs = tile_offsets(rois, H, W, tile, margin=margin)
            lp_b[bi], off_b[bi], val_b[bi] = pad_local_polys(rois, offs, nb, vb)
        held: List[torch.Tensor] = []
        # the frames are copied one by one into one chunk buffer,
        # page-locked on a card (u16 as int16 storage, read as uint16 on
        # the device)
        dtype = chunk[0][1].dtype
        u16 = dtype == np.uint16
        if cuda:
            buf = staging.get((pad_b, H, W), torch.from_numpy(
                np.empty(0, np.int16 if u16 else dtype)).dtype)
            held.append(buf)
            view = buf.numpy().view(dtype)
        else:
            view = np.empty((pad_b, H, W), dtype)
            buf = torch.from_numpy(view)
        for bi, (_, img, _) in enumerate(chunk):
            view[bi] = img
        view[B:] = 0

        def block(d, lo, hi):
            imgs = runner.to_shard(buf[lo:hi], d)
            return fa_batched_step(
                imgs.view(torch.uint16) if u16 else imgs,
                *(runner.to_shard(a[lo:hi], d) for a in (lp_b, off_b, val_b)),
                cfg.alpha, cfg.min_px, tile=tile, **step_kw)

        parts = runner.dispatch_shards(shards, block, pad_b, staging=staging,
                                       streams=streams)
        return chunk, parts, held

    def finalize(rec):
        """Wait for a dispatched chunk, write its stages, recycle its host
        buffers."""
        chunk, parts, staged = rec
        try:  # no side effects yet, so a failure is safe to retry serially
            flat = runner.fetch_shards(parts).numpy()
        except Exception as e:  # noqa: BLE001
            raise runner.EmitFetchError(str(e)) from e
        props, n_labels, scal, over = unpack_fa_flat(
            flat, hint["nb"], cfg.max_fa_per_cell)
        for bi, (s_tag, _, rois) in enumerate(chunk):
            if over[bi]:
                # aliased label slots -> wrong rows: skip the stage loudly
                log(t("err_worker").format(
                    key=s_tag,
                    error=("FA count exceeded max_fa_per_cell="
                           f"{cfg.max_fa_per_cell}; raise "
                           "--max-fa-per-cell")))
                continue
            m, s, bg = (float(v) for v in scal[bi, :3])
            fa_iter = ((i + 1, float(props["area"][bi, i, r]),
                        float(props["mean"][bi, i, r]))
                       for i in range(len(rois))
                       for r in range(int(n_labels[bi, i])))
            # the threshold as the per-image path reports it
            _write_stage(indiv_dir, s_tag, _fa_file_rows(
                s_tag, fa_iter, m + cfg.alpha * s, bg, cfg), results)
        for _, img, _ in chunk:
            frame_pool.put(img.base)  # (1, H, W) decode buffer now dead
        for buf in staged:
            staging.put(buf)
        for host, done in parts:
            if done is not None:
                staging.put(host)

    def _err_key(it):
        # the raw (img_path, json_path, s_tag) loader triple on a load
        # failure, or the classified (s_tag, img, rois) entry when a serial
        # fallback or an emit failed
        return it[2] if isinstance(it[2], str) else it[0]

    if runner.stream_batches(
        loader, batch_size, classify, dispatch, finalize, run_serial,
        lambda err: log(t("err_worker").format(key=_err_key(err.item),
                                               error=err.error)),
        cancel=cancel,
    ):
        log(t("cancelled"))

    if cfg.do_master_report and results:
        merge_fa_report(out_root, cfg.master_name, log=log)
    return results


def analyze_image_with_overrides(
    img: np.ndarray,
    rois: List[np.ndarray],
    cfg: FaConfig,
    cell_settings: Optional[Dict[int, dict]] = None,
    device="cuda",
) -> Tuple[List[dict], Dict[int, float], float]:
    """Interactive-mode semantics: each cell analyzed with its own
    parameter override when present (FA_Analyzer per-cell settings,
    :646-666, restored via :func:`restore_cell_settings`).  Global stats are
    computed once; thresholds vary per cell via each cell's alpha.
    Returns (fa rows, {cell_idx0: threshold}, bg)."""
    dev = resolve_device(device)
    m, s, bg = (float(v) for v in torch.stack(fa_global_stats(img, dev)).cpu())
    cell_settings = cell_settings or {}
    rows: List[dict] = []
    thresholds: Dict[int, float] = {}
    for i, poly in enumerate(rois):
        over = cell_settings.get(i)
        cell_cfg = cfg if over is None else replace(
            cfg,
            alpha=over.get("alpha", cfg.alpha),
            min_area_um=over.get("min_area_um", cfg.min_area_um),
            max_area_um=over.get("max_area_um", cfg.max_area_um),
            close_radius=over.get("close_radius", cfg.close_radius),
            subtract_bg=over.get("subtract_bg", cfg.subtract_bg),
        )
        cell_rows, thr, _, _ = analyze_image(img, [poly], cell_cfg,
                                             stats=(m, s, bg), device=dev)
        thresholds[i] = thr
        for r in cell_rows:
            r["cell"] = i + 1
            rows.append(r)
    return rows, thresholds, bg


def _parse_column(cells: List[str]) -> list:
    """One CSV column as ``pandas.read_csv`` types it: ints (floats when a
    cell is empty), floats, ``True`` / ``False``, else strings; an empty
    cell is NaN."""
    filled = [c for c in cells if c != ""]
    for conv in (int, float):
        try:
            vals = {c: conv(c) for c in filled}
        except ValueError:
            continue
        if conv is int and len(filled) < len(cells):
            vals = {c: float(v) for c, v in vals.items()}
        return [vals[c] if c != "" else float("nan") for c in cells]
    if filled and all(c in ("True", "False") for c in filled):
        return [c == "True" if c != "" else float("nan") for c in cells]
    return [c if c != "" else float("nan") for c in cells]


def read_fa_csv(path: str) -> Tuple[List[str], List[list]]:
    """(columns, rows) of a per-stage results CSV, typed per column."""
    with open(path, newline="", encoding="utf-8") as f:
        table = list(csv.reader(f))
    if not table:
        raise ValueError(f"{path}: empty CSV")
    header, body = table[0], table[1:]
    cols = [_parse_column([row[j] for row in body]) for j in range(len(header))]
    return header, [list(r) for r in zip(*cols)]


def restore_cell_settings(out_root: str, s_tag: str) -> Dict[int, dict]:
    """Per-cell parameter overrides recovered from a previous run's
    ``individual_results/{s_tag}_results.csv`` (the outputs-as-checkpoints
    resume mechanism, FA_Analyzer.py:572-608): the settings of each cell's
    first row.  Returns {cell_idx0: settings dict}."""
    indiv = os.path.join(out_root, "individual_results", f"{s_tag}_results.csv")
    out: Dict[int, dict] = {}
    if not os.path.exists(indiv):
        return out
    try:
        header, rows = read_fa_csv(indiv)
    except (OSError, ValueError, IndexError, csv.Error):
        return out
    if not rows or "Used_Alpha" not in header:
        return out
    col = {c: j for j, c in enumerate(header)}

    def get(row, name, default):
        return row[col[name]] if name in col else default

    for row in rows:
        cell = int(row[col["Cell_ID"]]) - 1
        if cell in out:
            continue
        out[cell] = {
            "alpha": float(row[col["Used_Alpha"]]),
            "min_area_um": float(get(row, "Min_Area_Setting", 1.5)),
            "max_area_um": float(get(row, "Max_Area_Setting", 30.0)),
            "close_radius": int(get(row, "Close_Radius_Setting", 1)),
            # the column is parsed, not truth-tested: bool("False") is True
            "subtract_bg": bool(get(row, "Subtract_BG_Setting", True)),
        }
    return out


def export_fa_crops(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    cmap: str = "jet",
    sb_on: bool = True,
    sb_len_um: float = 10.0,
    dpi: int = 300,
    log=print,
    device="cuda",
) -> List[str]:
    """Per-cell FA-mask crop PNGs under ``crops_export/<s_tag>/Cell_N.png``
    (FA_Analyzer.py ExportDialog, :1119-1279 + save_crop_colormap :213-264),
    drawn by ``report.render.save_fa_crop_colormap``.  Each stage runs
    ``analyze_image`` on *device* (``"cuda"``, the default, raises without a
    card; or ``"cpu"``) once more, as the JAX package does."""
    from ..report.render import save_fa_crop_colormap

    dev = resolve_device(device)
    out_dir = os.path.join(out_root, "crops_export")
    written: List[str] = []
    for img_path, json_path, s_tag in list_fa_pairs(img_dir, roi_dir, cfg.channel):
        img = tiffio.read_2d(img_path, squeeze="smallest_axis")
        rois = _load_rois(json_path)
        _, _, _, extras = analyze_image(img, rois, cfg, device=dev)
        if not extras:
            continue
        labels, offs, tile = extras["labels"], extras["offsets"], extras["tile"]
        file_dir = os.path.join(out_dir, s_tag)
        os.makedirs(file_dir, exist_ok=True)
        H, W = img.shape
        for i, roi_poly in enumerate(rois):
            xs, ys = roi_poly[:, 0], roi_poly[:, 1]
            x0 = max(0, int(np.floor(xs.min())) - 5)
            x1 = min(W, int(np.ceil(xs.max())) + 5)
            y0 = max(0, int(np.floor(ys.min())) - 5)
            y1 = min(H, int(np.ceil(ys.max())) + 5)
            # the FA mask of this cell, re-windowed from its tile
            oy, ox = offs[i]
            bw = np.zeros((H, W), bool)
            bw[oy:oy + tile, ox:ox + tile] = labels[i] > 0
            path = os.path.join(file_dir, f"Cell_{i + 1}.png")
            save_fa_crop_colormap(
                img[y0:y1, x0:x1], bw[y0:y1, x0:x1],
                roi_poly - np.array([x0, y0], float), path,
                cmap_name=cmap, sb_on=sb_on, sb_len_um=sb_len_um,
                px_size=cfg.px_size, out_dpi=dpi)
            written.append(path)
        log(t("fa_export").format(tag=s_tag, count=len(rois)))
    return written


_YELLOW = (255, 255, 0, 255)
_MAGENTA = (255, 0, 255, 255)


def _autoscaled(values: np.ndarray) -> Tuple[float, float]:
    """An axis's limits autoscaled to line data: ``nonsingular`` and the 5%
    margins of ``axes.xmargin`` / ``ymargin``."""
    from ..report import pilcomp

    if values.size == 0:
        return nonsingular(np.inf, -np.inf, expander=0.05)
    x0, x1 = nonsingular(float(values.min()), float(values.max()), expander=0.05)
    delta = (x1 - x0) * pilcomp.MARGIN
    return x0 - delta, x1 + delta


def fa_fig_layout(H: int, W: int, rois, boundaries, title: str, dpi: int = 150):
    """The overview figure's geometry as the JAX package's matplotlib figure
    lays it out: ``figsize=(10, 10 * H / W)`` and ``tight_layout(pad=0.2)``
    at ``pilcomp.FIG_DPI`` around the axes, the title and the ROI numbers,
    placed on the line data's autoscaled limits (the image does not exist
    yet then).  Returns (figsize, the image's aspect-equal box in display
    pixels at *dpi*, the closed ROI outlines, the ROI centers)."""
    from ..report import pilcomp

    figsize = (10, 10 * H / W)
    closed = [np.r_[np.asarray(P, float), np.asarray(P, float)[:1]] for P in rois]
    paths = closed + [np.asarray(P, float) for P in boundaries]
    centers = [(float(np.asarray(P, float)[:, 0].mean()),
                float(np.asarray(P, float)[:, 1].mean())) for P in rois]
    xs = np.concatenate([P[:, 0] for P in paths]) if paths else np.zeros(0)
    ys = np.concatenate([P[:, 1] for P in paths]) if paths else np.zeros(0)
    xlim, ylim = _autoscaled(xs), _autoscaled(ys)

    cell = pilcomp.SUBPLOT_BOX
    ax = pilcomp.to_px(cell, figsize, pilcomp.FIG_DPI)
    boxes = [ax, pilcomp.title_layout(ax, title, pilcomp.FIG_DPI, True)[0]]
    for i, (cx, cy) in enumerate(centers, 1):
        x = ax[0] + (cx - xlim[0]) / (xlim[1] - xlim[0]) * (ax[2] - ax[0])
        y = ax[1] + (cy - ylim[0]) / (ylim[1] - ylim[0]) * (ax[3] - ax[1])
        boxes.append(pilcomp.text_layout(x, y, str(i), 10, pilcomp.FIG_DPI,
                                         "center", "baseline")[0])
    sp = pilcomp.tight_params(figsize, [cell], [pilcomp.union(boxes)], pad=0.2)
    if sp is not None:
        cell = (sp["left"], sp["bottom"], sp["right"], sp["top"])
    box = pilcomp.to_px(pilcomp.aspect_box(cell, H / W, figsize[1] / figsize[0]),
                        figsize, dpi)
    return figsize, box, closed, centers


def _fa_fig_png(img: np.ndarray, rois, fa_mask: np.ndarray, boundaries,
                title: str, out: str, dpi: int) -> None:
    """One overview figure (:func:`fa_fig_layout`): on white at *dpi*, the
    image, the yellow dashed ROI outlines and the magenta dashed
    *boundaries* clipped to it, the numbers and the title."""
    from PIL import Image, ImageDraw

    from ..report import pilcomp
    from ..report.render import colormap_rgba_u8

    H, W = img.shape
    figsize, box, closed, centers = fa_fig_layout(H, W, rois, boundaries, title, dpi)
    lo, hi = np.percentile(img, [1, 99])
    base = colormap_rgba_u8(img, "gray", lo, hi)
    # the reference's 0.9-alpha red FA overlay composited in u8:
    # out = 0.9*red + 0.1*base, the pixels of a second imshow layer
    under = base[fa_mask, :3].astype(np.float32)
    base[fa_mask, :3] = (0.9 * np.float32([255.0, 51.0, 51.0])
                         + 0.1 * under + 0.5).astype(np.uint8)

    canvas = Image.new("RGBA", pilcomp.figure_px(figsize, dpi), (255, 255, 255, 255))
    pilcomp.paste_image(canvas, base, box)
    axes = pilcomp.ImageAxes(canvas, box, W, H, dpi)
    for group, rgba in ((closed, _YELLOW), ([np.asarray(P, float) for P in boundaries],
                                            _MAGENTA)):
        pilcomp.stamp_lines(canvas, [np.column_stack(axes.to_px(P[:, 0], P[:, 1]))
                                     for P in group], 1.0, dpi, rgba, clip=box)
    for i, (cx, cy) in enumerate(centers, 1):
        x, y = axes.to_px(cx, cy)
        pilcomp.stamp_label(canvas, float(x), float(y), str(i), 10, dpi, _YELLOW,
                            "baseline")
    overlay = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    pilcomp.draw_text(ImageDraw.Draw(overlay), canvas.size[1],
                      pilcomp.title_layout(box, title, dpi)[1], title,
                      pilcomp.TITLE_PT, dpi, (0, 0, 0, 255))
    canvas.alpha_composite(overlay)
    pilcomp.save_canvas_png(canvas, out)


def save_fa_figs(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    dpi: int = 150,
    mat_dir: Optional[str] = None,
    log=print,
    device="cuda",
) -> List[str]:
    """Per-stage overview figures under ``fig/<s_tag>_FA.png`` (the golden
    tree's BND_FA/fig outputs): the 1/99 percentile gray frame, the detected
    FA mask as a 0.9-alpha red overlay, the cell outlines and numbers, and
    the title ``"{s_tag}  alpha=...  thr=...  bg=..."``; with *mat_dir*, the
    legacy MATLAB boundaries matched by stage tag as magenta dashed lines
    (FA_Analyzer.py:650-655, 747-749; ``core.roiio`` reads them with h5py,
    which must then be installed).  Each stage runs ``analyze_image`` on
    *device* (``"cuda"``, the default, raises without a card; or ``"cpu"``)
    once more, as the JAX package does."""
    dev = resolve_device(device)
    fig_dir = os.path.join(out_root, "fig")
    os.makedirs(fig_dir, exist_ok=True)
    written = []
    for img_path, json_path, s_tag in list_fa_pairs(img_dir, roi_dir, cfg.channel):
        img = tiffio.read_2d(img_path, squeeze="smallest_axis")
        rois = _load_rois(json_path)
        _, thr, bg, extras = analyze_image(img, rois, cfg, device=dev)
        H, W = img.shape
        fa_mask = np.zeros((H, W), bool)
        if extras:
            tile = extras["tile"]
            for i, (oy, ox) in enumerate(extras["offsets"]):
                fa_mask[oy:oy + tile, ox:ox + tile] |= extras["labels"][i] > 0
        boundaries = []
        if mat_dir:
            mat_path = roiio.find_matching_mat(mat_dir, s_tag)
            if mat_path:
                boundaries = roiio.load_matlab_boundaries(mat_path)
        out = os.path.join(fig_dir, f"{s_tag}_FA.png")
        _fa_fig_png(img, rois, fa_mask, boundaries,
                    f"{s_tag}  alpha={cfg.alpha}  thr={thr:.1f}  bg={bg:.1f}", out, dpi)
        written.append(out)
        log(t("fa_fig").format(path=out))
    return written


_CATS = ("OK", "Large", "Small")


def merge_fa_report(out_root: str, name: str = "FA_Results_Master.xlsx",
                    log=print) -> Optional[List[list]]:
    """File_Summary / Cell_Summary / All_Data master workbook
    (FA_Analyzer.py:1054-1113) from every CSV under
    ``individual_results/`` (globbed unsorted, as the reference does).
    Returns the All_Data sheet (header row first) or None without CSVs."""
    indiv_dir = os.path.join(out_root, "individual_results")
    header, data = None, []
    for c in glob.glob(os.path.join(indiv_dir, "*.csv")):
        try:
            cols, rows = read_fa_csv(c)
        except (OSError, ValueError, IndexError, csv.Error):
            continue
        if header is None:
            header = cols
        at = {name_: j for j, name_ in enumerate(cols)}
        data += [[row[at[h]] if h in at else float("nan") for h in header]
                 for row in rows]
    if header is None:
        return None
    col = {c: j for j, c in enumerate(header)}
    f_at, c_at, k_at = col["File"], col["Cell_ID"], col["Category"]

    cell_counts: Dict[tuple, Dict[str, int]] = {}
    file_counts: Dict[str, Dict[str, int]] = {}
    file_cells: Dict[str, set] = {}
    for row in data:
        f, cell, cat = row[f_at], row[c_at], row[k_at]
        for counts, key in ((cell_counts, (f, cell)), (file_counts, f)):
            by_cat = counts.setdefault(key, {})
            by_cat[cat] = by_cat.get(cat, 0) + 1
        file_cells.setdefault(f, set()).add(cell)

    def r2(x: float) -> float:
        return float(np.round(x, 2))  # half to even, as DataFrame.round

    file_sheet = [["File", *_CATS, "Total_FA_Count", "Analyzed_Cells_Count",
                   "Avg_FA_per_Cell", "Avg_OK_FA_per_Cell"]]
    for f in sorted(file_counts):
        n = [file_counts[f].get(cat, 0) for cat in _CATS]
        total, cells = sum(n), len(file_cells[f])
        file_sheet.append([f, *n, total, cells, r2(total / cells),
                           r2(n[0] / cells)])
    cell_sheet = [["File", "Cell_ID", *_CATS, "Total_Count"]]
    for f, cell in sorted(cell_counts):
        n = [cell_counts[(f, cell)].get(cat, 0) for cat in _CATS]
        cell_sheet.append([f, cell, *n, sum(n)])

    all_data = [list(header)] + data
    out_xls = os.path.join(out_root, name)
    xlsxlite.write_xlsx(out_xls, {"File_Summary": file_sheet,
                                  "Cell_Summary": cell_sheet,
                                  "All_Data": all_data})
    log(t("log_save_xls").format(path=out_xls))
    return all_data
