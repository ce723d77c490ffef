"""Nesprin-2 nuclear-rim FRET: the serial runner and the batched,
tables-only runner.

Port of ``imageprocess_tpu/pipelines/nesprin2.py``.  Reference semantics:
the Nesprin2 FRET script of the reference -- ``run_pipeline`` (:1331-1736),
``make_inside_rim_mask`` (:409-414, EDT), ``annulus_mask_from_poly``
(:416-427), ``spectral_correct`` (:460-468), ``bg_correct`` with its
isfinite filter (:432-458), QC saturation -> NaN (:1415-1421) and ratio
clip -> NaN (:1502-1504), the per-ROI annulus local-background re-ratio
(:1515-1535), ``save_xls`` (:1287-1326).

Known reference divergence, kept as the JAX package has it: the reference
writes its i18n *function object* into the "time" column when
timelapse=True; the actual time code is written instead.

The device program of one (stage, time) pair, in plain PyTorch but for the
per-ROI statistics:

1. full frame (``pair_frames``): saturation QC (NaN into both channels),
   each channel's background over its *finite* scoped pixels
   (``_finite_bg``; u8/u16 frames through one 65536-bin histogram of the raw
   frame with the saturated pixels masked out, exact), clip(x - bg), the
   spectral correction, eps = max(eps_abs, the eps percentile of the finite
   corrected denominator over the ROI union), both ratio orientations, and
   the rim mask from the radius-clamped EDT of the union
   (``morphology.edt.rim_mask``);
2. per ROI (``roi_stage``), on each ROI's bbox tile (grown by the annulus
   margin), for every pair of a chunk at once: with the annulus on, the
   medians of numerator and denominator over each ROI's square-dilation
   annulus -- one ``roistats_f32`` launch, C = 2 -- and the re-ratio of the
   gathered tiles; then the nine statistics of the ratio and the means of
   the other orientation, the donor and the FRET channel over mask & rim --
   one ``roistats_f32`` launch, C = 4.  ``ops.roistats.roi_stat_rows``
   launches the hand kernel for CUDA tensors and takes its plain version
   for CPU tensors.  An ROI that needs the full frame (``tile=None``) goes
   through the same stage with the frames NaN-padded to one square tile.

With ``do_tif`` or ``do_png`` the serial runner also brings each pair's
ratio frame and rim mask to the host (page-locked staging on a card, and
only then; with ``do_png`` and the annulus also the corrected numerator and
denominator, from which each crop's ratio is rebuilt) and
``report.render.save_nesprin2_images`` writes the full and rim-masked
float32 TIFFs and the full, crop and intensity-crop PNGs (the intensity
channel's frame is read only for them); the batched runner hands such a
config to the serial one.  ``save_panel`` (with ``do_png``) raises
``NotImplementedError`` before a file is read, naming
``report.render.FIGURES``, and so does ``mesh=``, naming ``MULTI_DEVICE``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import i18n, naming, roiio, tiffio
from ..device import MULTI_DEVICE, resolve_device
from ..geom.polygon import pad_polygons
from ..geom.rasterize import rasterize_polygons
from ..morphology.binary import square_dilation
from ..morphology.edt import rim_mask as make_rim_mask
from ..ops import roi_stats_kernel as rsk
from ..ops import roistats
from ..ops.background import (
    INTEGRAL, as_float32, histogram_mode_value, integral_masked_quantile,
)
from ..ops.percentile import masked_quantile, p1000_of
from ..ops.ratio import clip_ratio_to_nan, ratio_with_eps, spectral_correct
from ..ops.roistats import choose_tile, pad_local_polys, tile_offsets
from ..ops.stats import STAT_FIELDS
from ..parallel import runner
from ..report.render import FIGURES, save_nesprin2_images
from .intensity import PinnedPool, _bucket, frames_on_host, to_device

t = i18n.t
ChannelGrammar = naming.ChannelGrammar

# rim/annulus presets (µm): thin/medium/thick (Nesprin2:632-637)
RIM_PRESETS = {
    "thin": (0.45, 0.6, 1.5),
    "medium": (0.67, 0.9, 1.8),
    "thick": (1.00, 1.2, 2.0),
}


@dataclass
class Nesprin2Config:
    """The JAX package's ``Nesprin2Config``, field for field (names,
    defaults and derived properties)."""

    donor_ch: int = 1
    fret_ch: int = 2
    intensity_ch: int = 3
    aonly_ch: Optional[int] = None
    timelapse: bool = False
    ratio_mode: str = "FRET/Donor"
    bg_mode: str = "percentile"
    bg_scope: str = "full"              # "full" | "roi_union" | "annulus"
    percentile: float = 1.0
    per_channel_p: bool = False
    donor_p: float = 1.0
    fret_p: float = 1.0
    clip_neg: bool = True
    eps_percentile: float = 1.0
    eps_abs: float = 5.0
    # spectral correction
    use_spectral: bool = False
    alpha: float = 0.0
    beta: float = 0.0
    g_factor: float = 1.0
    # QC
    sat_filter_on: bool = False
    sat_threshold: float = 65535.0
    clip_ratio_on: bool = False
    clip_ratio_max: float = 10.0
    # geometry
    px_um: float = 0.112
    rim_um: float = 0.45
    annulus_on: bool = False
    ann_in_um: float = 1.2
    ann_out_um: float = 2.5
    subset_stage: Optional[int] = None
    subset_time: Optional[int] = None
    # outputs
    do_xls: bool = True
    do_tif: bool = False
    do_png: bool = False
    save_full: bool = True
    save_crop: bool = True
    save_panel: bool = False
    save_crop_intensity: bool = True
    cmap_name: str = "turbo"
    show_colorbar: bool = True
    add_scalebar: bool = False
    scale_bar_um: float = 5.0
    fret_min: float = 0.0
    fret_max: float = 0.7
    crop_vmin_txt: str = ""
    crop_vmax_txt: str = ""
    crop_fixed: bool = True
    crop_w: int = 500
    crop_h: int = 500
    grammar: ChannelGrammar = ChannelGrammar.END_ANCHORED

    @property
    def rim_px(self) -> int:
        return max(1, int(round(self.rim_um / self.px_um)))

    @property
    def ann_in_px(self) -> int:
        return max(1, int(round(self.ann_in_um / self.px_um))) if self.annulus_on or self.bg_scope == "annulus" else 0

    @property
    def ann_out_px(self) -> int:
        if not (self.annulus_on or self.bg_scope == "annulus"):
            return 0
        return max(self.ann_in_px + 1, int(round(self.ann_out_um / self.px_um)))


def _channel_ps(cfg: Nesprin2Config):
    """(donor percentile, FRET percentile) of the background."""
    if cfg.per_channel_p:
        return cfg.donor_p, cfg.fret_p
    return cfg.percentile, cfg.percentile


def _ann_active(cfg: Nesprin2Config) -> bool:
    return cfg.annulus_on or cfg.bg_scope == "annulus"


def _step_kwargs(cfg: Nesprin2Config, has_aonly: bool, tile: Optional[int]) -> dict:
    """The device program's options of a config."""
    return dict(bg_mode=cfg.bg_mode, bg_scope=cfg.bg_scope,
                clip_neg=cfg.clip_neg, flip=cfg.ratio_mode != "FRET/Donor",
                sat_on=cfg.sat_filter_on, clip_on=cfg.clip_ratio_on,
                use_spectral=cfg.use_spectral, has_aonly=has_aonly,
                rim_px=cfg.rim_px, ann_on=_ann_active(cfg),
                ann_in_px=cfg.ann_in_px, ann_out_px=cfg.ann_out_px, tile=tile)


def _step_scalars(cfg: Nesprin2Config) -> tuple:
    """The device program's scalar arguments of a config, in its order."""
    d_p, a_p = _channel_ps(cfg)
    return (p1000_of(d_p), p1000_of(a_p), p1000_of(cfg.percentile),
            p1000_of(cfg.eps_percentile), cfg.eps_abs, cfg.sat_threshold,
            cfg.clip_ratio_max, cfg.alpha, cfg.beta, cfg.g_factor)


def _finite_bg(img: torch.Tensor, p1000: int, scope: Optional[torch.Tensor],
               mode: str, finite: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rim-FRET background level: the percentile or hist-mode of the
    *finite* scoped pixels (every pixel, no stride), 0.0 when there are
    none or for another mode.

    *img* is a float32 frame (its non-finite pixels drop out) or a raw
    u8/u16 frame; *finite* (bool, optional) takes further pixels out -- the
    saturated ones of a raw frame, which then keeps its exact histogram
    path instead of a sort of the NaN-marked float frame."""
    if mode not in ("percentile", "hist-mode"):
        return torch.zeros((), dtype=torch.float32, device=img.device)
    if img.dtype not in INTEGRAL:
        fin = torch.isfinite(img)
        finite = fin if finite is None else finite & fin
    if finite is None:
        base = torch.ones_like(img, dtype=torch.bool) if scope is None else scope
    else:
        base = finite if scope is None else scope & finite
    if mode == "percentile":
        b = (integral_masked_quantile(img, base, p1000) if img.dtype in INTEGRAL
             else masked_quantile(img, base, p1000))
    else:
        x = as_float32(img)
        if finite is not None:
            x = torch.where(finite, x, torch.zeros_like(x))
        b = histogram_mode_value(x, base, p1000)
    return torch.where(base.any(), b, torch.zeros_like(b)).to(torch.float32)


def pair_frames(
    D: torch.Tensor, A: torch.Tensor, Aonly: torch.Tensor, union: torch.Tensor,
    d_p1000: int, a_p1000: int, g_p1000: int, eps_p1000: int, eps_abs: float,
    sat_thr: float, clip_max: float, alpha: float, beta: float, g_factor: float,
    *,
    bg_mode="percentile", bg_scope="full", clip_neg=True, flip=False,
    sat_on=False, clip_on=False, use_spectral=False, has_aonly=False,
    rim_px=4,
) -> Dict[str, torch.Tensor]:
    """The full-frame part of one pair: raw (H, W) frames (u8 / u16 /
    float) and the ROI union -> float32 ``Dcorr``, ``Acorr``, ``numer``,
    ``denom``, ``R_full``, ``R_alt``, the bool ``rim`` and the scalar
    ``eps``."""
    Df, Af = as_float32(D), as_float32(A)
    finite = None
    if sat_on:
        sat = (Df >= sat_thr) | (Af >= sat_thr)
        nan = torch.full((), float("nan"), dtype=torch.float32, device=D.device)
        Df, Af = torch.where(sat, nan, Df), torch.where(sat, nan, Af)
        finite = ~sat
    scope = None if bg_scope == "full" else union

    def correct(raw, img, p1000, finite):
        if bg_mode == "none":
            return img
        b = _finite_bg(raw if raw.dtype in INTEGRAL else img, p1000, scope,
                       bg_mode, finite)
        out = img - b
        return torch.clamp(out, min=0.0) if clip_neg else out

    Dcorr = correct(D, Df, d_p1000, finite)
    Acorr = correct(A, Af, a_p1000, finite)
    if use_spectral:
        Aonly_bc = (correct(Aonly, as_float32(Aonly), g_p1000, None)
                    if has_aonly else None)
        Acorr = spectral_correct(Acorr, Dcorr, Aonly_bc, alpha, beta, g_factor)

    numer, denom = (Dcorr, Acorr) if flip else (Acorr, Dcorr)
    eps_q = masked_quantile(denom, union & torch.isfinite(denom), eps_p1000)
    ea = torch.tensor(eps_abs, dtype=torch.float32, device=D.device)
    eps = torch.maximum(ea, torch.where(torch.isnan(eps_q), ea, eps_q))

    def ratio(n, d):
        r = ratio_with_eps(n, d, eps)
        return clip_ratio_to_nan(r, clip_max) if clip_on else r

    return {"Dcorr": Dcorr, "Acorr": Acorr, "numer": numer, "denom": denom,
            "R_full": ratio(numer, denom), "R_alt": ratio(denom, numer),
            "rim": make_rim_mask(union, rim_px), "eps": eps}


def roi_stage(
    pairs: List[Dict[str, torch.Tensor]],   # B x pair_frames(), one frame shape
    masks: torch.Tensor,                    # (B, N, T, T) bool ROI masks
    offsets: torch.Tensor,                  # (B, N, 2) int [row, col] origins
    *,
    clip_neg=True, flip=False, clip_on=False, clip_max=10.0,
    ann_on=False, ann_in_px=0, ann_out_px=0,
) -> Dict[str, torch.Tensor]:
    """The per-ROI part of a chunk of pairs on (T, T) tiles: (B, N)
    tensors of the nine statistics of the ratio over mask & rim (finite
    pixels), ``alt_mean`` / ``donor_mean`` / ``fret_mean`` over the same
    mask, ``area`` (mask & rim pixels, finite or not) and the annulus
    medians ``bg_n`` / ``bg_d`` (0.0 with the annulus off or empty).

    One ``roistats_f32`` launch with the annulus off (C = 4, the frames at
    the ROI origins), two with it on (the annulus medians, C = 2, at the
    origins; then C = 4 over the per-ROI re-ratio stack)."""
    B, N, T, _ = masks.shape
    R = B * N
    dev = masks.device
    offs3 = torch.cat([
        torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(N)[:, None],
        offsets.reshape(R, 2).to(torch.int32)], dim=1).contiguous()
    masks = masks.reshape(R, T, T)
    rim = torch.stack([p["rim"] for p in pairs])[:, None]            # (B, 1, H, W)
    roi_mask = (masks & rsk.gather_roi_tiles(rim, offs3, T)[:, 0]).contiguous()

    if ann_on:
        nd = torch.stack([torch.stack([p["numer"], p["denom"]]) for p in pairs])
        ann = square_dilation(masks, ann_out_px) & ~square_dilation(masks, ann_in_px)
        med = roistats.roi_stat_rows(nd, ann.contiguous(), offs3)   # (R, 2, 9)
        bg = torch.where(med[..., 8] > 0, med[..., 1], torch.zeros_like(med[..., 1]))
        tiles = rsk.gather_roi_tiles(nd, offs3, T)                   # (R, 2, T, T)
        eff = tiles - bg[:, :, None, None]
        if clip_neg:
            eff = torch.clamp(eff, min=0.0)
        eps = torch.stack([p["eps"] for p in pairs]).repeat_interleave(N)[:, None, None]

        def ratio(n, d):
            r = ratio_with_eps(n, d, eps)
            return clip_ratio_to_nan(r, clip_max) if clip_on else r

        d_t, a_t = (tiles[:, 0], tiles[:, 1]) if flip else (tiles[:, 1], tiles[:, 0])
        stack = torch.stack([ratio(eff[:, 0], eff[:, 1]), ratio(eff[:, 1], eff[:, 0]),
                             d_t, a_t], dim=1)
        rows = roistats.roi_stat_rows(stack, roi_mask, rsk.stack_offsets(R, dev))
        bg_n, bg_d = bg[:, 0], bg[:, 1]
    else:
        frames = torch.stack([torch.stack([p["R_full"], p["R_alt"], p["Dcorr"],
                                           p["Acorr"]]) for p in pairs])
        rows = roistats.roi_stat_rows(frames, roi_mask, offs3)      # (R, 4, 9)
        bg_n = bg_d = torch.zeros(R, dtype=torch.float32, device=dev)

    out = {f: rows[:, 0, k] for k, f in enumerate(STAT_FIELDS)}
    out.update(alt_mean=rows[:, 1, 0], donor_mean=rows[:, 2, 0],
               fret_mean=rows[:, 3, 0],
               area=roi_mask.sum(dim=(1, 2), dtype=torch.int32),
               bg_n=bg_n, bg_d=bg_d)
    return {k: v.reshape(B, N) for k, v in out.items()}


def _square_pad(x: torch.Tensor, S: int, value) -> torch.Tensor:
    """(..., H, W) -> (..., S, S), padded at the bottom and the right."""
    H, W = x.shape[-2:]
    return x if (H, W) == (S, S) else F.pad(x, (0, S - W, 0, S - H), value=value)


def nesprin2_step(
    D, A, Aonly, polys, roi_valid,
    d_p1000, a_p1000, g_p1000, eps_p1000, eps_abs,
    sat_thr, clip_max, alpha, beta, g_factor,
    local_polys=None, offsets=None,
    *,
    bg_mode="percentile", bg_scope="full", clip_neg=True, flip=False,
    sat_on=False, clip_on=False, use_spectral=False, has_aonly=False,
    rim_px=4, ann_on=False, ann_in_px=0, ann_out_px=0,
    tile: Optional[int] = None,
):
    """One (stage, time) pair on the device, as the JAX package's
    ``nesprin2_step``: raw (H, W) frames, padded full-frame polygons
    (N, V, 2) with validity (N,), the scalars, and with *tile* set the
    tile-local polygons and (N, 2) origins (the host guarantees that each
    tile covers its ROI plus the annulus margin).  Returns (stats dict of
    (N,), alt_means, donor_means, fret_means, areas int32, bg_ns, bg_ds,
    eps, R_full, R_alt, rim, union, Dcorr, Acorr)."""
    H, W = D.shape
    full_masks = rasterize_polygons(polys, (H, W)) & roi_valid[:, None, None]
    union = full_masks.any(dim=0)
    pf = pair_frames(
        D, A, Aonly, union, d_p1000, a_p1000, g_p1000, eps_p1000, eps_abs,
        sat_thr, clip_max, alpha, beta, g_factor, bg_mode=bg_mode,
        bg_scope=bg_scope, clip_neg=clip_neg, flip=flip, sat_on=sat_on,
        clip_on=clip_on, use_spectral=use_spectral, has_aonly=has_aonly,
        rim_px=rim_px)
    stage_kw = dict(clip_neg=clip_neg, flip=flip, clip_on=clip_on,
                    clip_max=clip_max, ann_on=ann_on, ann_in_px=ann_in_px,
                    ann_out_px=ann_out_px)
    if tile is not None:
        masks = (rasterize_polygons(local_polys, (tile, tile))
                 & roi_valid[:, None, None])
        res = roi_stage([pf], masks[None], offsets[None], **stage_kw)
    else:
        # an ROI needs the full frame: one square tile holds it, the frames
        # NaN-padded (no statistic reads a non-finite pixel), the masks
        # and the rim False-padded
        S = max(H, W)
        padded = {k: _square_pad(v, S, False if k == "rim" else float("nan"))
                  for k, v in pf.items() if k != "eps"}
        padded["eps"] = pf["eps"]
        offs = torch.zeros((1, full_masks.shape[0], 2), dtype=torch.int32,
                           device=D.device)
        res = roi_stage([padded], _square_pad(full_masks, S, False)[None], offs,
                        **stage_kw)
    res = {k: v[0] for k, v in res.items()}
    stats = {f: res[f] for f in STAT_FIELDS}
    stats["npx"] = stats["npx"].to(torch.int32)
    return (stats, res["alt_mean"], res["donor_mean"], res["fret_mean"],
            res["area"], res["bg_n"], res["bg_d"], pf["eps"], pf["R_full"],
            pf["R_alt"], pf["rim"], union, pf["Dcorr"], pf["Acorr"])


# table fields packed per ROI slot, in order
_N2_STAT_FIELDS = STAT_FIELDS
_N2_FIELDS = tuple(_N2_STAT_FIELDS) + ("alt_mean", "donor_mean", "fret_mean",
                                       "area", "bg_n", "bg_d")


def _pack_flat(res: Dict[str, torch.Tensor], eps: torch.Tensor) -> torch.Tensor:
    """(B, N) per-ROI tensors and (B,) eps -> the flat (B, 15 * N + 1)
    float32 table array: the fields in ``_N2_FIELDS`` order, N values
    each, then eps."""
    cols = torch.stack([res[f].to(torch.float32) for f in _N2_FIELDS], dim=1)
    return torch.cat([cols.reshape(cols.shape[0], -1), eps[:, None]], dim=1)


def make_nesprin2_batched_step(cfg: Nesprin2Config, *, has_aonly: bool,
                               tile: int, mesh=None):
    """The device program of a chunk of rim-FRET pairs: a function of
    (D, A, Aonly -- each (B, H, W) or a sequence of B frames, Aonly a
    (B, 1, 1) placeholder without that channel --, polys (B, N, V, 2), valid
    (B, N), local_polys, offsets (B, N, 2)) giving one flat (B, K) float32
    table array (``unpack_n2_flat``).  The full-frame
    part runs pair by pair; the per-ROI part is one ``roistats_f32`` launch
    (two with the annulus) for the whole chunk.  Nothing image-sized comes
    back, but full frames go up: the rim EDT and the eps scope need the
    whole union mask."""
    if mesh is not None:
        raise NotImplementedError(
            f"sharding over a device mesh is not ported yet: {MULTI_DEVICE}")
    kw = _step_kwargs(cfg, has_aonly, tile)
    stage_kw = {k: kw.pop(k) for k in ("ann_on", "ann_in_px", "ann_out_px")}
    stage_kw.update(clip_neg=kw["clip_neg"], flip=kw["flip"], clip_on=kw["clip_on"],
                    clip_max=cfg.clip_ratio_max)
    del kw["tile"]
    scalars = _step_scalars(cfg)

    def step(D_b, A_b, Ao_b, pv_b, val_b, lp_b, off_b):
        B = len(D_b)
        H, W = D_b[0].shape
        pairs = []
        for b in range(B):
            union = (rasterize_polygons(pv_b[b], (H, W))
                     & val_b[b][:, None, None]).any(dim=0)
            pairs.append(pair_frames(D_b[b], A_b[b], Ao_b[b], union, *scalars, **kw))
        masks = (rasterize_polygons(lp_b.reshape(-1, *lp_b.shape[2:]), (tile, tile))
                 & val_b.reshape(-1)[:, None, None])
        res = roi_stage(pairs, masks.reshape(B, -1, tile, tile), off_b, **stage_kw)
        return _pack_flat(res, torch.stack([p["eps"] for p in pairs]))

    return step


def unpack_n2_flat(flat: np.ndarray, nb: int):
    """({field: (B, nb)}, eps (B,)) from the batched step's flat result."""
    B = flat.shape[0]
    n_f = len(_N2_FIELDS)
    cols = flat[:, :n_f * nb].reshape(B, n_f, nb)
    return {n: cols[:, k] for k, n in enumerate(_N2_FIELDS)}, flat[:, -1]


def _swap_read(dpath: str, apath: str, ch: int) -> Optional[np.ndarray]:
    """Channel *ch*'s frame (float32) under the donor's file name, else
    under the acceptor's; None when neither exists."""
    cand = naming.swap_channel_in_name(dpath, ch)
    if not os.path.exists(cand):
        cand = naming.swap_channel_in_name(apath, ch)
    return tiffio.read_2d(cand) if os.path.exists(cand) else None


def load_pair_nesprin2(key, dpath, apath, roi_dir, cfg: Nesprin2Config):
    """Host side of one pair: donor and FRET frames (the file's dtype
    kept), the intensity-channel frame I, the optional acceptor-only frame
    -- both through the swap-channel fallback chain (:1424-1437), I falling
    back to the donor frame as float32 -- and the ROIs.  Returns (D, A, I,
    Aonly, polys), each of the last three possibly None.  I feeds only the
    PNGs: it is read only with ``cfg.do_png`` (None otherwise)."""
    D = tiffio.read_2d(dpath, dtype=None)
    A = tiffio.read_2d(apath, dtype=None)
    I = None
    if cfg.do_png:
        I = _swap_read(dpath, apath, cfg.intensity_ch)
        if I is None:
            I = D.astype(np.float32)
    Aonly = _swap_read(dpath, apath, cfg.aonly_ch) if cfg.aonly_ch is not None else None
    base = naming.find_roi_basepath(roi_dir, os.path.basename(dpath),
                                    cfg.timelapse, cfg.grammar, exts=(".json",))
    polys = (roiio.load_roi_polygons(base + ".json")
             if os.path.exists(base + ".json") else None)
    return D, A, I, Aonly, polys


def _tile_margin(cfg: Nesprin2Config) -> int:
    return (cfg.ann_out_px + 1) if _ann_active(cfg) else 0


def process_pair_nesprin2(key, dpath, apath, roi_dir, cfg: Nesprin2Config,
                          dirs=None, log=print, loaded=None, device="cuda",
                          staging: Optional[PinnedPool] = None) -> List[dict]:
    """One (stage, time) pair synchronously -> its per-ROI rows: one copy
    brings the flat table array back.  With a *staging* pool the uploads
    go through page-locked buffers.  With ``cfg.do_tif`` or ``cfg.do_png``
    the ratio frame and the rim mask come back too (and, for the PNG crops
    with the annulus, the corrected numerator and denominator) and the
    images go to *dirs* (:func:`nesprin2_dirs`)."""
    dev = resolve_device(device)
    s, t_code = key
    tag = f"{s}_{t_code}" if (cfg.timelapse and t_code is not None) else s
    D, A, I, Aonly, polys = loaded if loaded is not None else \
        load_pair_nesprin2(key, dpath, apath, roi_dir, cfg)
    H, W = D.shape
    if not polys:
        log(t("msg_warn_no_roi_tag").format(tag=tag))
        return []

    n = len(polys)
    nb = _bucket(n)
    vb = _bucket(max(len(p) for p in polys), 32)
    pv = np.zeros((nb, vb, 2), np.float32)
    pv[:n] = pad_polygons([np.asarray(p, np.float32) for p in polys], vb)
    valid = np.zeros(nb, bool)
    valid[:n] = True
    held: List[torch.Tensor] = []

    def up(arr):
        return to_device(arr, dev, staging, held)

    margin = _tile_margin(cfg)
    tile = choose_tile(polys, H, W, margin=margin)
    if tile is not None:
        offs = tile_offsets(polys, H, W, tile, margin=margin)
        lpv, offs_pad, _ = pad_local_polys(polys, offs, nb, vb)
        tiled_args = (up(lpv), up(offs_pad))
    else:
        tiled_args = (None, None)

    out = nesprin2_step(
        up(D), up(A),
        up(Aonly if Aonly is not None else np.zeros((1, 1), D.dtype)),
        up(pv), up(valid), *_step_scalars(cfg), *tiled_args,
        **_step_kwargs(cfg, Aonly is not None, tile))
    stats, alt_means, donor_means, fret_means, areas, bg_ns, bg_ds, eps = out[:8]
    res = dict(stats, alt_mean=alt_means, donor_mean=donor_means,
               fret_mean=fret_means, area=areas, bg_n=bg_ns, bg_d=bg_ds)
    flat = _pack_flat({k: v[None] for k, v in res.items()}, eps[None]).cpu().numpy()
    for buf in held:  # the uploads are done: the copy back synchronised
        staging.put(buf)
    cols, eps_arr = unpack_n2_flat(flat, nb)
    flip = cfg.ratio_mode != "FRET/Donor"
    d_p, a_p = _channel_ps(cfg)
    if cfg.do_tif or cfg.do_png:
        # the ratio frame and the rim leave the device only for the images,
        # the corrected frames only for the annulus crops' re-ratio
        ann = cfg.do_png and cfg.save_crop and _ann_active(cfg)
        numer, denom = (out[12], out[13]) if flip else (out[13], out[12])
        with frames_on_host([out[8], out[10], numer if ann else None,
                             denom if ann else None], dev, staging) as host:
            R_np, rim_np, numer_np, denom_np = host
            save_nesprin2_images(
                tag, "DoverF" if flip else "FoverD", R_np, rim_np, I, polys, cfg,
                dirs, float(eps_arr[0]),
                ann_bgs=(cols["bg_n"][0], cols["bg_d"][0]) if ann else None,
                numer=numer_np, denom=denom_np)
    return [_n2_row(s, t_code, i, lambda f, i=i: cols[f][0, i],
                    float(eps_arr[0]), cfg, flip, d_p, a_p) for i in range(n)]


def nesprin2_dirs(out_root: str) -> Dict[str, str]:
    """The folders of the rim-FRET image outputs under *out_root*."""
    return {
        "tif32_full": os.path.join(out_root, "TIF", "ratio32_full"),
        "tif32_rim": os.path.join(out_root, "TIF", "ratio32_rim"),
        "png_full_ratio": os.path.join(out_root, "PNG", "FULL_RATIO"),
        "png_full_int": os.path.join(out_root, "PNG", "FULL_INT"),
        "png_panel": os.path.join(out_root, "PNG", "panel"),
        "png_crop_ratio": os.path.join(out_root, "PNG", "CROP_RATIO"),
        "png_crop_int_no": os.path.join(out_root, "PNG", "CROP_INT", "no_rim"),
        "png_crop_int_r": os.path.join(out_root, "PNG", "CROP_INT", "rim"),
    }


def _refuse_unported(cfg: Nesprin2Config) -> None:
    """``save_panel`` is the one image output not ported."""
    if cfg.do_png and cfg.save_panel:
        raise NotImplementedError(
            f"save_panel (the intensity / ratio panel) is not ported yet: {FIGURES}")


def _n2_pairs(folder: str, cfg: Nesprin2Config, log):
    """Discover + subset-filter the (key, donor, acceptor) pairs."""
    files = naming.list_tifs(folder)
    pairs, _ = naming.build_pairs_by_channel(
        files, cfg.timelapse, cfg.donor_ch, cfg.fret_ch, cfg.grammar
    )
    log(t("msg_info_pairs").format(count=len(pairs)))
    if pairs and cfg.subset_stage is not None:
        s_code = naming.fmt_stage(cfg.subset_stage)
        if not cfg.timelapse or cfg.subset_time is None:
            pairs = [p for p in pairs if p[0][0] == s_code]
        else:
            t_code = naming.fmt_time(cfg.subset_time)
            pairs = [p for p in pairs if p[0] == (s_code, t_code)]
    return pairs


def _n2_row(s, t_code, i, get, eps_f, cfg: Nesprin2Config,
            flip: bool, d_p: float, a_p: float) -> dict:
    """One per-ROI table row; ``get(field)`` returns ROI *i*'s scalar for
    mean/median/std/p5/p95/alt_mean/donor_mean/fret_mean/area.  The one
    place the rim-FRET row schema lives: the serial and the batched runner
    both build through it."""
    main_mean = float(get("mean"))
    alt_mean = float(get("alt_mean"))
    return {
        "stage": s,
        "time": t_code if cfg.timelapse else None,
        "roi": i + 1,
        "area_px": int(get("area")),
        "ratio_mean": main_mean,
        "ratio_median": float(get("median")),
        "ratio_std": float(get("std")),
        "ratio_p5": float(get("p5")),
        "ratio_p95": float(get("p95")),
        "ratio_FoverD_mean": alt_mean if flip else main_mean,
        "ratio_DoverF_mean": main_mean if flip else alt_mean,
        "donor_mean": float(get("donor_mean")),
        "fret_mean": float(get("fret_mean")),
        "eps": eps_f, "p": cfg.percentile,
        "donor_p": d_p, "fret_p": a_p,
        "ratio_mode": cfg.ratio_mode,
        "bg_scope": cfg.bg_scope, "bg_mode": cfg.bg_mode,
        "clip_neg": cfg.clip_neg,
        "sat_filter_on": cfg.sat_filter_on,
        "sat_threshold": cfg.sat_threshold,
        "clip_ratio_on": cfg.clip_ratio_on,
        "clip_ratio_max": cfg.clip_ratio_max,
    }


def _pair_tag(key) -> str:
    return key[0] if key[1] is None else f"{key[0]}_{key[1]}"


def run_nesprin2_batched(
    folder: str,
    cfg: Nesprin2Config,
    out_root: Optional[str] = None,
    log=print,
    batch_size: int = 4,
    mesh=None,
    prefetch_workers: int = 8,
    cancel=None,
    device="cuda",
) -> List[dict]:
    """Tables-only batched rim-FRET runner: prefetch-thread decode and
    pre-padding, a chunk of pairs per device step
    (:func:`make_nesprin2_batched_step`: the frames of the chunk go up
    through page-locked staging on a side stream, one flat (B, K) array
    comes back), two chunks in flight.  Rows identical to
    :func:`run_nesprin2`.  A pair the batch cannot take (another frame
    shape or dtype, an ROI that needs the full frame or outgrows the run's
    tile) runs :func:`process_pair_nesprin2` in key order.  *device* is
    ``"cuda"`` (default; raises without a card) or ``"cpu"``."""
    from ..report.excel import save_nesprin2_excel

    dev = resolve_device(device)
    _refuse_unported(cfg)
    if mesh is not None:
        raise NotImplementedError(
            f"sharding over a device mesh is not ported yet: {MULTI_DEVICE}")
    if cfg.do_tif or cfg.do_png:
        # the image outputs are written pair by pair from full frames
        log(t("n2_images_serial"))
        return run_nesprin2(folder, cfg, out_root=out_root, log=log,
                            cancel=cancel, device=dev)
    out_root = out_root or os.path.join(folder, "RES")
    roi_dir = os.path.join(folder, "roi")
    pairs = _n2_pairs(folder, cfg, log)
    if not pairs:
        log(t("msg_no_pairs"))
        return []

    flip = cfg.ratio_mode != "FRET/Donor"
    d_p, a_p = _channel_ps(cfg)
    margin = _tile_margin(cfg)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    staging = PinnedPool() if cuda else None
    hint: Dict[str, int] = {}

    def _load(kv):
        key, dpath, apath = kv
        D, A, I, Aonly, polys = load_pair_nesprin2(key, dpath, apath, roi_dir, cfg)
        # pre-pad the polygon/offset arrays in the prefetch thread against
        # run-stable (tile, nb, vb) hints, so dispatch only stacks
        pre = None
        if polys and A.shape == D.shape:
            H, W = D.shape
            t_need = choose_tile(polys, H, W, margin=margin)
            if t_need is not None:
                max_v = max(len(p) for p in polys)
                t_used = hint.setdefault("tile", t_need)
                nb_used = hint.setdefault("nb", _bucket(len(polys)))
                vb_used = hint.setdefault("vb", _bucket(max_v, 32))
                if (t_need <= t_used <= min(H, W) and len(polys) <= nb_used
                        and max_v <= vb_used):
                    pv = np.zeros((nb_used, vb_used, 2), np.float32)
                    pv[:len(polys)] = pad_polygons(
                        [np.asarray(p, np.float32) for p in polys], vb_used)
                    valid = np.zeros(nb_used, bool)
                    valid[:len(polys)] = True
                    offs = tile_offsets(polys, H, W, t_used, margin=margin)
                    lp, off_pad, _ = pad_local_polys(polys, offs, nb_used, vb_used)
                    pre = (t_used, pv, valid, lp, off_pad)
        return kv, (D, A, I, Aonly, polys), pre

    loader = runner.PrefetchLoader(_load, pairs, workers=max(1, prefetch_workers))
    step_cache: Dict[tuple, object] = {}
    rows_all: List[dict] = []

    def run_serial(entry):
        (key, dpath, apath), loaded = entry[:2]  # a batch entry has more
        rows_all.extend(process_pair_nesprin2(
            key, dpath, apath, roi_dir, cfg, None, log=log, loaded=loaded,
            device=dev))

    sig = None

    def classify(item):
        nonlocal sig
        kv, (D, A, I, Aonly, polys), pre = item
        tag = _pair_tag(kv[0])
        log(t("msg_processing").format(tag=tag))
        if not polys:
            log(t("msg_warn_no_roi_tag").format(tag=tag))
            return "skip", None
        key_sig = (D.shape, A.shape, D.dtype, A.dtype, Aonly is not None)
        if sig is None and pre is not None:
            sig = key_sig
        if pre is None or key_sig != sig or pre[0] != hint.get("tile"):
            return "serial", (kv, (D, A, I, Aonly, polys))
        return "batch", (kv, (D, A, I, Aonly, polys), pre)

    def step_for(tile):
        if tile not in step_cache:
            step_cache[tile] = make_nesprin2_batched_step(
                cfg, has_aonly=sig[4], tile=tile)
        return step_cache[tile]

    def dispatch(chunk):
        """Send the chunk's frames and pre-padded arrays and launch its
        device step WITHOUT synchronising."""
        held: List[torch.Tensor] = []

        def up(arr):
            return to_device(arr, dev, staging, held)

        def stacked(k):
            return up(np.stack([pre[k] for _, _, pre in chunk]))

        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            # frame by frame (the step takes them one at a time); a (1, 1)
            # placeholder when there is no acceptor-only channel: the step
            # never reads it
            frames = [[up(loaded[k]) for _, loaded, _ in chunk]
                      for k in ((0, 1, 3) if sig[4] else (0, 1))]
            if not sig[4]:
                frames.append(up(np.zeros((len(chunk), 1, 1), np.uint16)))
            flat = step_for(hint["tile"])(*frames, *(stacked(k) for k in (1, 2, 3, 4)))
            if not cuda:
                return chunk, flat.numpy(), None, held
            out = staging.get(tuple(flat.shape), torch.float32)
            out.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return chunk, out, done, held + [out]

    def finalize(rec):
        """Wait for a dispatched chunk, emit its rows, recycle its staging
        buffers."""
        chunk, flat, done, staged = rec
        try:  # no side effects yet, so a failure is safe to retry serially
            if done is not None:
                done.synchronize()
                flat = flat.numpy()
        except Exception as e:  # noqa: BLE001
            raise runner.EmitFetchError(str(e)) from e
        cols, eps_arr = unpack_n2_flat(flat, hint["nb"])
        for bi, (kv, (_, _, _, _, polys), _) in enumerate(chunk):
            s, t_code = kv[0]
            eps_f = float(eps_arr[bi])
            for i in range(len(polys)):
                rows_all.append(_n2_row(
                    s, t_code, i, lambda f, bi=bi, i=i: cols[f][bi, i],
                    eps_f, cfg, flip, d_p, a_p))
        for buf in staged:
            staging.put(buf)

    def _err_key(it):
        # the raw (key, dpath, apath) loader item on a load failure, or an
        # entry whose [0] is that triple when a serial fallback / emit failed
        return it[0] if isinstance(it[1], str) else it[0][0]

    if runner.stream_batches(
        loader, batch_size, classify, dispatch, finalize, run_serial,
        lambda err: log(t("err_worker").format(key=_err_key(err.item),
                                               error=err.error)),
        cancel=cancel,
    ):
        log(t("cancelled"))

    if cfg.do_xls:
        save_nesprin2_excel(rows_all, os.path.join(out_root, "xls"),
                            cfg.timelapse)
    return rows_all


def run_nesprin2(
    folder: str,
    cfg: Nesprin2Config,
    out_root: Optional[str] = None,
    log=print,
    cancel=None,
    device="cuda",
) -> List[dict]:
    """The rim-FRET workload (the Nesprin2 FRET script, :1331-1736) over an
    experiment *folder*, one pair at a time: per-ROI rows of every
    (stage, time) pair, the tables under ``RES/xls``.  *cancel* (a
    zero-argument callable) is checked between pairs.  *device* is
    ``"cuda"`` (default; raises without a card) or ``"cpu"``."""
    from ..report.excel import save_nesprin2_excel

    dev = resolve_device(device)
    _refuse_unported(cfg)
    out_root = out_root or os.path.join(folder, "RES")
    dirs = nesprin2_dirs(out_root)
    roi_dir = os.path.join(folder, "roi")
    pairs = _n2_pairs(folder, cfg, log)
    if not pairs:
        log(t("msg_no_pairs"))
        return []

    staging = PinnedPool() if dev.type == "cuda" else None
    loader = runner.PrefetchLoader(
        lambda kv: (kv, load_pair_nesprin2(kv[0], kv[1], kv[2], roi_dir, cfg)),
        pairs, workers=8,
    )
    rows_all: List[dict] = []
    for item in loader:
        if cancel is not None and cancel():
            log(t("cancelled"))
            break
        if isinstance(item, runner.LoadError):
            log(t("err_worker").format(key=item.item[0], error=item.error))
            continue
        (key, dpath, apath), loaded = item
        log(t("msg_processing").format(tag=_pair_tag(key)))
        rows_all.extend(
            process_pair_nesprin2(key, dpath, apath, roi_dir, cfg, dirs,
                                  log=log, loaded=loaded, device=dev,
                                  staging=staging)
        )

    if cfg.do_xls:
        save_nesprin2_excel(rows_all, os.path.join(out_root, "xls"), cfg.timelapse)
    return rows_all
