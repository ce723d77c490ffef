"""Ratiometric FRET math, QC masks, spectral bleed-through correction.

Port of ``imageprocess_tpu/ops/ratio.py``; every function is elementwise
plain PyTorch, as the JAX functions are plain XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from .percentile import masked_quantile


def pick_epsilon(
    denom: torch.Tensor,
    scope_mask: Optional[torch.Tensor] = None,
    eps_abs: float = 5.0,
    p_floor1000: int = 1000,
) -> torch.Tensor:
    """Stabilizing epsilon from the denominator's low percentile:
    max(eps_abs, percentile of the finite scoped denominator), eps_abs
    when nothing is in scope."""
    finite = torch.isfinite(denom)
    mask = finite if scope_mask is None else scope_mask & finite
    q = masked_quantile(torch.where(finite, denom, torch.zeros_like(denom)),
                        mask, p_floor1000)
    eps = torch.tensor(eps_abs, dtype=torch.float32, device=denom.device)
    q = torch.where(mask.sum() > 0, q, eps)
    return torch.maximum(eps, q)


def ratio_with_eps(numer: torch.Tensor, denom: torch.Tensor, eps) -> torch.Tensor:
    return (numer + eps) / (denom + eps)


def saturation_to_nan(img: torch.Tensor, sat_threshold: float) -> torch.Tensor:
    """Mark saturated raw pixels as NaN so they drop out of every later
    statistic (per-channel form of the QC gate).  Integer frames come back
    as float32."""
    if not img.is_floating_point():
        img = img.to(torch.float32)
    return torch.where(img >= sat_threshold,
                       torch.full_like(img, float("nan")), img)


def clip_ratio_to_nan(ratio: torch.Tensor, clip_max: float) -> torch.Tensor:
    return torch.where(ratio > clip_max, torch.full_like(ratio, float("nan")),
                       ratio)


def spectral_correct(
    fret: torch.Tensor,
    donor: torch.Tensor,
    acceptor_only: Optional[torch.Tensor],
    alpha: float,
    beta: float,
    g_factor: float,
) -> torch.Tensor:
    """Bleed-through-corrected FRET channel: (F - alpha*D - beta*Aonly) * G."""
    corr = fret - alpha * donor
    if acceptor_only is not None:
        corr = corr - beta * acceptor_only
    return corr * g_factor
