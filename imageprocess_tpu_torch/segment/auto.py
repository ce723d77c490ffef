"""Batch automatic cell segmentation — the ROI_auto_drawer replacement (port
of ``imageprocess_tpu/segment/auto.py``).

Backends: ``"unet"`` (the bundled U-Net checkpoints, ``segment.cellseg``),
``"cpsam"`` (Cellpose-SAM, ``models.cpsam``, from a Cellpose state dict
file, through the same ``segment.cellseg`` path), ``"threshold"`` (Gaussian
smooth, percentile or mu + k*sigma threshold, open/close, hole filling,
small-object removal, CCL, all on the device) and ``"cellpose"`` (only
where the cellpose package is importable).  Label maps become polygons
through the reference's cv2 external contours and are written as the
drawer's ROI JSON bundles.

``"cpsam"`` against Cellpose 4's ``CellposeModel(pretrained_model="cpsam")
.eval`` with its defaults (no rescaling, ``cellprob_threshold`` 0,
``min_size`` 15, bf16): the same network, input ``[x, 0, 0]`` and
unclamped 1/99-percentile normalisation, and these departures:

- the port's tile grid (256-px tiles, overlap 32: 88 tiles on 1536 x
  2048), where Cellpose's ``make_tiles`` gives 80;
- the port's feathered blend of the sigmoid probability and the flows,
  where Cellpose tapers the raw outputs, logits included; the threshold
  is probability 0.5, Cellpose's logit 0;
- the port's flow following (``segment.flows``), not Cellpose's 200
  Euler steps and mask clean-up;
- one forward batch per frame, where Cellpose passes ``batch_size`` 4
  (each tile's result does not depend on the batch).
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
    backend: str = "threshold"       # "threshold" | "unet" | "cpsam" | "cellpose"
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
    # unet and cpsam backends
    checkpoint: Optional[str] = None   # unet: None -> bundled pretrained;
                                       # cpsam: a Cellpose-SAM state dict file
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
_CPSAM_CACHE = {}
CPSAM_MIN_SIZE = 15   # px, Cellpose's eval min_size; min_size_px is the other backends'


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
                  device="cuda", phases=None) -> List[np.ndarray]:
    """Learned path: bundled (or user) U-Net checkpoint -> tiled inference
    (segment.cellseg) -> polygons."""
    from .cellseg import segment_frame_unet

    model, tile = _unet_model(cfg, device)
    return segment_frame_unet(
        img, model, tile=tile,
        prob_threshold=cfg.prob_threshold, min_size_px=cfg.min_size_px,
        max_labels=cfg.max_labels, min_poly_area=cfg.min_poly_area,
        flow_follow=cfg.flow_follow, mesh=_mesh(cfg, device), device=device,
        phases=phases)


def _cpsam_model(cfg: AutoSegConfig, device="cuda"):
    """(Cellpose-SAM ``TileMaps`` on *device*, tile) of the state dict file
    ``cfg.checkpoint``, cached per (file, device).  Called up front by
    run_auto_drawer so that a missing or foreign file fails the run."""
    from ..models.checkpoint import load_cpsam

    dev = resolve_device(device)
    if not cfg.checkpoint:
        raise ValueError("backend 'cpsam' needs checkpoint= a Cellpose-SAM state dict "
                         "file (roi-auto --checkpoint FILE)")
    key = (os.path.abspath(cfg.checkpoint), str(dev))
    if key not in _CPSAM_CACHE:
        model, tile = load_cpsam(key[0])
        _CPSAM_CACHE[key] = (model.to(dev), tile)
    return _CPSAM_CACHE[key]


def _cpsam_segment(img: np.ndarray, cfg: AutoSegConfig, device="cuda",
                   phases=None) -> List[np.ndarray]:
    """Cellpose-SAM through segment.cellseg: unclamped normalisation,
    Cellpose's thresholds (probability ``cfg.prob_threshold``, 0.5 by
    default, and ``CPSAM_MIN_SIZE``), the port's flow following."""
    from .cellseg import segment_frame_unet

    model, tile = _cpsam_model(cfg, device)
    return segment_frame_unet(
        img, model, tile=tile, prob_threshold=cfg.prob_threshold,
        min_size_px=CPSAM_MIN_SIZE, max_labels=cfg.max_labels,
        min_poly_area=cfg.min_poly_area, flow_follow=cfg.flow_follow,
        mesh=_mesh(cfg, device), device=device, phases=phases)


def _mesh(cfg: AutoSegConfig, device):
    if cfg.devices <= 1:
        return None
    from ..parallel.runner import make_mesh

    return make_mesh(cfg.devices, device=device)


def auto_segment_frame(img: np.ndarray, cfg: AutoSegConfig,
                       device="cuda", phases=None) -> List[np.ndarray]:
    """One frame -> list of [x, y] polygons.  *phases*: the run's
    ``cellseg.seg_phases()`` (a fresh one per frame by default)."""
    if cfg.backend == "cellpose":
        return _cellpose_segment(img, cfg)
    if cfg.backend == "unet":
        return _unet_segment(img, cfg, device, phases)
    if cfg.backend == "cpsam":
        return _cpsam_segment(img, cfg, device, phases)
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
            "cellpose is not installed; use backend='cpsam' (Cellpose-SAM from a "
            "state dict file, no package needed)"
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
    elif cfg.backend == "cpsam":
        _cpsam_model(cfg, device)
    elif cfg.backend == "cellpose":
        try:
            import cellpose  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "cellpose is not installed; use backend='cpsam' (Cellpose-SAM from a "
                "state dict file, no package needed)"
            ) from e
    from .cellseg import seg_phases

    phases = seg_phases()
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
            with phases("seg_read"):
                img = _read_frame(path)
        except Exception as e:
            log(i18n.t("auto_read_failed").format(name=base, err=e))
            continue
        if img.max() <= img.min():
            log(i18n.t("auto_blank_skip").format(name=base))
            continue
        try:
            polys = auto_segment_frame(img, cfg, device, phases)
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
            "cpsam": "cellpose:cpsam",
            "unet": "imageprocess_tpu.unet",
        }.get(cfg.backend, "imageprocess_tpu.auto_threshold")
        roiio.save_roi_bundle(out, tag, img.shape, polys, generated_by=gen)
        written.append(out)
    phases.report()
    return written
