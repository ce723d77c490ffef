"""Batch automatic cell segmentation — the ROI_auto_drawer replacement (port
of ``imageprocess_tpu/segment/auto.py``).

Backends: ``"unet"`` (the bundled U-Net checkpoints, ``segment.cellseg``),
``"threshold"`` (Gaussian smooth, percentile or mu + k*sigma threshold,
open/close, hole filling, small-object removal, CCL, all on the device)
and ``"cellpose"`` (only where the cellpose package is importable).  Label
maps become polygons through the reference's cv2 external contours and
are written as the drawer's ROI JSON bundles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core import i18n, naming
from ..morphology import contours
from ..core import roiio, tiffio
from ..device import resolve_device
from ..morphology.binary import (binary_closing_skimage, binary_dilation,
                                 binary_erosion, disk)
from ..morphology.ccl import fill_holes, label, remove_small_objects
from ..ops.percentile import masked_quantile
from ..ops.view import gaussian_blur

MIN_POLY_AREA = 20.0  # px, ROI_auto_drawer.py:304

_PRETRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "imageprocess_tpu", "models", "pretrained")
DEFAULT_UNET_CKPT = os.path.join(_PRETRAINED, "unet_golden_v1")

# AutoSegConfig.checkpoint accepts these names as well as paths
NAMED_UNET_CKPTS = {
    "golden": DEFAULT_UNET_CKPT,
    "general": os.path.join(_PRETRAINED, "unet_general_v1"),
}


@dataclass
class AutoSegConfig:
    backend: str = "threshold"       # "threshold" | "unet" | "cellpose"
    channel: Optional[int] = None    # filename channel filter (None = all)
    timelapse: bool = False
    # threshold backend
    smooth_sigma: float = 2.0
    thr_mode: str = "percentile"     # "percentile" | "mean_std"
    thr_percentile: float = 90.0
    thr_k: float = 2.0
    open_radius: int = 2
    close_radius: int = 2
    min_size_px: int = 200
    max_labels: int = 1024
    # unet backend
    checkpoint: Optional[str] = None   # None -> bundled pretrained
    prob_threshold: float = 0.5
    flow_follow: bool = True           # Cellpose-style instance separation
    devices: int = 1                   # >1: shard the tile batch over a mesh
    # cellpose backend
    diameter: Optional[float] = None
    model_type: str = "cyto3"
    use_gpu: bool = False
    min_poly_area: float = MIN_POLY_AREA


def auto_segment_step(
    img: torch.Tensor,
    *,
    thr_p1000: int,
    thr_k: float,
    smooth_sigma: float,
    thr_mode: str,
    open_radius: int,
    close_radius: int,
    min_size: int,
    max_labels: int,
):
    """Full-frame threshold+morphology segmentation -> (labels, threshold,
    overflow flag), on *img*'s device."""
    x = img.to(torch.float32)
    if smooth_sigma > 0:
        x = gaussian_blur(x, smooth_sigma)
    finite = torch.isfinite(x)
    if thr_mode == "mean_std":
        nf = finite.sum().to(torch.float32).clamp(min=1.0)
        m = torch.where(finite, x, 0.0).sum() / nf
        s = torch.sqrt(torch.where(finite, (x - m) ** 2, 0.0).sum() / nf)
        thr = m + thr_k * s
    else:
        thr = masked_quantile(torch.where(finite, x, float("inf")), finite,
                              thr_p1000)
    bw = (x > thr) & finite
    if open_radius > 0:
        se = disk(open_radius)
        bw = binary_dilation(binary_erosion(bw, se, border_true=False), se)
    if close_radius > 0:
        bw = binary_closing_skimage(bw, disk(close_radius))
    bw = fill_holes(bw)
    if min_size > 0:
        bw = remove_small_objects(bw, min_size, connectivity=1)
    labels, over = label(bw, connectivity=2, max_labels=max_labels,
                         with_overflow=True)
    return labels, thr, over


_UNET_CACHE = {}


def _unet_model(cfg: AutoSegConfig, device="cuda"):
    """(UNet on *device*, tile) for the configured checkpoint, cached per
    (checkpoint, device).  Called up front by run_auto_drawer so a bad
    checkpoint path fails the run instead of every frame."""
    from ..models.checkpoint import load_unet

    dev = resolve_device(device)
    name = cfg.checkpoint or DEFAULT_UNET_CKPT
    ckpt = os.path.abspath(NAMED_UNET_CKPTS.get(name, name))
    key = (ckpt, str(dev))
    if key not in _UNET_CACHE:
        model, tile = load_unet(ckpt)
        _UNET_CACHE[key] = (model.to(dev), tile)
    return _UNET_CACHE[key]


def _unet_segment(img: np.ndarray, cfg: AutoSegConfig,
                  device="cuda") -> List[np.ndarray]:
    """Learned path: bundled (or user) U-Net checkpoint -> tiled inference
    (segment.cellseg) -> polygons."""
    from .cellseg import segment_frame_unet

    model, tile = _unet_model(cfg, device)
    mesh = None
    if cfg.devices > 1:
        from ..parallel.runner import make_mesh

        mesh = make_mesh(cfg.devices, device=device)
    return segment_frame_unet(
        img, model, tile=tile,
        prob_threshold=cfg.prob_threshold, min_size_px=cfg.min_size_px,
        max_labels=cfg.max_labels, min_poly_area=cfg.min_poly_area,
        flow_follow=cfg.flow_follow, mesh=mesh, device=device)


def auto_segment_frame(img: np.ndarray, cfg: AutoSegConfig,
                       device="cuda") -> List[np.ndarray]:
    """One frame -> list of [x, y] polygons."""
    if cfg.backend == "cellpose":
        return _cellpose_segment(img, cfg)
    if cfg.backend == "unet":
        return _unet_segment(img, cfg, device)
    dev = resolve_device(device)
    labels, _, over = auto_segment_step(
        torch.from_numpy(np.asarray(img, np.float32)).to(dev),
        thr_p1000=int(round(cfg.thr_percentile * 1000)),
        thr_k=float(cfg.thr_k),
        smooth_sigma=cfg.smooth_sigma, thr_mode=cfg.thr_mode,
        open_radius=cfg.open_radius, close_radius=cfg.close_radius,
        min_size=cfg.min_size_px, max_labels=cfg.max_labels,
    )
    if bool(over):
        raise ValueError(
            f"component count exceeded max_labels={cfg.max_labels} — "
            "labels would alias; raise AutoSegConfig.max_labels")
    return contours.masks_to_polygons(labels.cpu().numpy(), cfg.min_poly_area)


def _cellpose_segment(img: np.ndarray, cfg: AutoSegConfig) -> List[np.ndarray]:
    """Optional Cellpose path (ROI_auto_drawer.py:203-248); requires the
    cellpose package, which is not bundled in this environment."""
    try:
        from cellpose import models  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "cellpose is not installed; use backend='threshold'"
        ) from e
    model_cls = getattr(models, "CellposeModel", None) or models.Cellpose
    model = model_cls(gpu=cfg.use_gpu, model_type=cfg.model_type)
    out = model.eval(
        img, diameter=cfg.diameter,
        batch_size=4 if cfg.use_gpu else 1, channels=[0, 0],
    )
    return contours.masks_to_polygons(np.asarray(out[0]), cfg.min_poly_area)


def _read_frame(path: str) -> np.ndarray:
    """First page of a TIFF as a 2-D float32 array (channel 0 of a
    multi-sample page): the native decoder, PIL for a file it does not
    take."""
    return tiffio.read_2d(path)


def run_auto_drawer(
    img_dir: str,
    cfg: AutoSegConfig,
    roi_dir: Optional[str] = None,
    log=print,
    device="cuda",
) -> List[str]:
    """Batch loop (ROI_auto_drawer.py:177-273): segment every matching TIFF
    and write ``roi/S##[_t##].json`` bundles.  Returns written paths."""
    resolve_device(device)
    roi_dir = roi_dir or os.path.join(img_dir, "roi")
    os.makedirs(roi_dir, exist_ok=True)
    # configuration errors (bad checkpoint path, missing cellpose) fail the
    # run here; the per-file isolation below is for data errors
    if cfg.backend == "unet":
        _unet_model(cfg, device)
    elif cfg.backend == "cellpose":
        try:
            import cellpose  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "cellpose is not installed; use backend='threshold'"
            ) from e
    grammar = naming.ChannelGrammar.KEYWORD
    written = []
    for path in naming.list_tifs(img_dir):
        base = os.path.basename(path)
        k = naming.parse_tokens(base, cfg.timelapse, grammar)
        if cfg.channel is not None and k.channel != cfg.channel:
            continue
        # stage-less names fall back to the bare filename
        # (ROI_auto_drawer.py:288-296)
        tag = naming.clean_base_for_save(base, cfg.timelapse, grammar,
                                         strip_trailing_number_fallback=False)
        # per-file isolation: one corrupt TIFF or a failed inference logs
        # and continues (ROI_auto_drawer.py:222-250)
        try:
            img = _read_frame(path)
        except Exception as e:
            log(i18n.t("auto_read_failed").format(name=base, err=e))
            continue
        if img.max() <= img.min():
            log(i18n.t("auto_blank_skip").format(name=base))
            continue
        try:
            polys = auto_segment_frame(img, cfg, device)
        except Exception as e:
            log(i18n.t("auto_seg_failed").format(name=base, err=e))
            continue
        log(i18n.t("auto_found").format(tag=tag, count=len(polys)))
        if not polys:
            # the reference writes NO file for 0-cell frames
            # (ROI_auto_drawer.py:253-264)
            continue
        out = os.path.join(roi_dir, f"{tag}.json")
        gen = {
            "cellpose": f"cellpose:{cfg.model_type}",
            "unet": "imageprocess_tpu.unet",
        }.get(cfg.backend, "imageprocess_tpu.auto_threshold")
        roiio.save_roi_bundle(out, tag, img.shape, polys, generated_by=gen)
        written.append(out)
    return written
