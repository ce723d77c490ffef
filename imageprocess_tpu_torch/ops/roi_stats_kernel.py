"""Per-ROI statistics of float32 tiles: the hand kernel and its plain version.

Counterpart of ``imageprocess_tpu/ops/pallas_roistats.py``.  One form
serves every caller: ``frames`` (F, C, H, W) float32, ``masks`` (R, T, T)
bool and per-ROI int32 origins ``offs`` (R, 3) = (frame, row, col) give
the (R, C, 9) float32 statistics of each ROI's (T, T) tile in every
channel, in ``STAT_FIELDS`` order (npx as a float).  Origins are clamped
into the frame as ``jax.lax.dynamic_slice`` clamps them.

- ``roi_stat_rows`` launches ``kernels/roistats_f32.cu``.  It takes CUDA
  tensors only and raises on anything else, on a failed build and on a
  failed launch.
- ``roi_stat_rows_plain`` computes the same in plain PyTorch
  (``ops.stats.masked_stats_batched``): what the CPU runs and what the
  kernel is held to on the card.

The FRET tables step is built on them: ``fret_tile_stats_packed`` (kernel)
and ``fret_tile_stats_packed_plain`` rasterize the tile-local polygons,
form [ratio, donor, acceptor] from the raw u16 tiles in plain PyTorch and
return the (B, 10, 3, N) packing of the JAX runner (nine statistics, then
the mask area).

``launches`` counts kernel launches: only ``roi_stat_rows``, where the
kernel is launched, adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..kernels.build import load_library
from .ratio import ratio_with_eps
from .stats import STAT_FIELDS, masked_stats_batched
from .tile_stats_kernel import tile_masks

N_STATS = len(STAT_FIELDS)
P_LO1000, P_HI1000 = 5000, 95000

#: kernel launches since the last reset
launches = {"roistats_f32": 0}
_smem_limit: Dict[int, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(frames, masks, offs) -> None:
    if frames.dim() != 4 or masks.dim() != 3 or masks.shape[-1] != masks.shape[-2]:
        raise ValueError(f"frames must be (F, C, H, W) and masks (R, T, T), got "
                         f"{tuple(frames.shape)} and {tuple(masks.shape)}")
    F, _, H, W = frames.shape
    R, T, _ = masks.shape
    if tuple(offs.shape) != (R, 3):
        raise ValueError(f"offs must be ({R}, 3), got {tuple(offs.shape)}")
    if T > H or T > W or (R and F == 0):
        raise ValueError(f"a {T}x{T} tile does not fit frames "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.float32 or masks.dtype != torch.bool \
            or offs.dtype != torch.int32:
        raise ValueError("frames must be float32, masks bool and offs int32 "
                         f"(got {frames.dtype}, {masks.dtype}, {offs.dtype})")


def gather_roi_tiles(frames: torch.Tensor, offs: torch.Tensor,
                     T: int) -> torch.Tensor:
    """(R, C, T, T) tiles of (F, C, H, W) *frames* at the clamped origins."""
    F, C, H, W = frames.shape
    o = offs.to(torch.int64)
    f = o[:, 0].clamp(0, F - 1)
    ar = torch.arange(T, device=frames.device)
    rows = o[:, 1].clamp(0, H - T)[:, None] + ar               # (R, T)
    cols = o[:, 2].clamp(0, W - T)[:, None] + ar
    ch = torch.arange(C, device=frames.device)
    return frames[f[:, None, None, None], ch[None, :, None, None],
                  rows[:, None, :, None], cols[:, None, None, :]]


def roi_stat_rows_plain(frames, masks, offs, *, p_lo1000: int = P_LO1000,
                        p_hi1000: int = P_HI1000) -> torch.Tensor:
    """Plain-PyTorch (R, C, 9) float32 statistics."""
    _check(frames, masks, offs)
    tiles = gather_roi_tiles(frames, offs, masks.shape[-1])
    stats = masked_stats_batched(tiles, masks[:, None], p_lo1000, p_hi1000)
    return torch.stack([stats[f].to(torch.float32) for f in STAT_FIELDS], -1)


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("roistats_f32")
    if not getattr(lib, "_ip_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ip_roistats_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                        ci, ci, ci, vp]
        lib.ip_roistats_f32.restype = ci
        lib.ip_roistats_smem_bytes.argtypes = [ci]
        lib.ip_roistats_smem_bytes.restype = ctypes.c_longlong
        lib.ip_roistats_smem_limit.argtypes = [ci]
        lib.ip_roistats_smem_limit.restype = ctypes.c_longlong
        lib.ip_cuda_error_string.argtypes = [ci]
        lib.ip_cuda_error_string.restype = ctypes.c_char_p
        lib._ip_bound = True
    return lib


def kernel_uses_smem(T: int, device: torch.device) -> bool:
    """True when a T x T tile's keys fit the card's opt-in shared memory,
    so the kernel stages them there; otherwise it reads device memory."""
    lib = _lib()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            _smem_limit[idx] = int(lib.ip_roistats_smem_limit(idx))
        if _smem_limit[idx] <= 0:
            raise RuntimeError("could not read the shared-memory limit of "
                               f"cuda:{idx}")
    return int(lib.ip_roistats_smem_bytes(T)) <= _smem_limit[idx]


def roi_stat_rows(frames, masks, offs, *, p_lo1000: int = P_LO1000,
                  p_hi1000: int = P_HI1000,
                  use_smem: Optional[bool] = None) -> torch.Tensor:
    """(R, C, 9) float32 statistics from the CUDA kernel, launched on the
    current stream without synchronising.  All three tensors contiguous
    on one CUDA device.  *use_smem* forces the kernel variant (None: shared
    memory when the tile fits)."""
    dev = frames.device
    for name, tns in (("frames", frames), ("masks", masks), ("offs", offs)):
        if not (tns.is_cuda and tns.device == dev and tns.is_contiguous()):
            raise ValueError(
                f"roi_stat_rows launches the CUDA kernel: {name} must be a "
                f"contiguous tensor on one CUDA device (got {tns.device}); "
                "the CPU path is roi_stat_rows_plain")
    _check(frames, masks, offs)
    F, C, H, W = frames.shape
    R, T, _ = masks.shape
    out = torch.empty((R, C, N_STATS), dtype=torch.float32, device=dev)
    if R * C == 0:
        return out
    if use_smem is None:
        use_smem = kernel_uses_smem(T, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ip_roistats_f32(
            frames.data_ptr(), masks.data_ptr(), offs.data_ptr(),
            out.data_ptr(), R, F, C, H, W, T, int(p_lo1000), int(p_hi1000),
            int(bool(use_smem)), stream)
    if rc != 0:
        raise RuntimeError(
            f"roistats_f32 launch failed: {lib.ip_cuda_error_string(rc).decode()}"
            f" (R={R}, F={F}, C={C}, H={H}, W={W}, T={T}, use_smem={use_smem})")
    launches["roistats_f32"] += 1
    return out


def rows_to_stats(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(R, C, 9) rows -> the ``STAT_FIELDS`` dict of (C, R) tensors
    (npx int32), as ``roi_stats_pallas`` returns it."""
    out = {f: rows[..., k].transpose(0, 1) for k, f in enumerate(STAT_FIELDS)}
    out["npx"] = out["npx"].to(torch.int32)
    return out


def stack_offsets(R: int, device) -> torch.Tensor:
    """(R, 3) int32 origins (r, 0, 0): tile r is frame r of a stack."""
    offs = torch.zeros((R, 3), dtype=torch.int32, device=device)
    offs[:, 0] = torch.arange(R, dtype=torch.int32, device=device)
    return offs


def fret_tile_stack(tiles, bgs, eps, *, clip_neg: bool = True,
                    flip: bool = False) -> torch.Tensor:
    """(B, N, 2, t, t) raw u16 [donor, acceptor] tiles, (B, 2) float32
    backgrounds and (B,) float32 epsilons -> the (B·N, 3, t, t) float32
    stack [ratio, donor, acceptor] of ``batched_fret_tile_stats``:
    x - bg, clipped at 0 with *clip_neg*, ratio (numer + e) / (denom + e)
    with numer/denom = acceptor/donor (donor/acceptor when *flip*)."""
    B, N, _, t, _ = tiles.shape
    x = tiles.to(torch.int32).to(torch.float32) - bgs[:, None, :, None, None]
    if clip_neg:
        x = torch.clamp(x, min=0.0)
    d, a = x[:, :, 0], x[:, :, 1]
    numer, denom = (d, a) if flip else (a, d)
    r = ratio_with_eps(numer, denom, eps[:, None, None, None])
    return torch.stack([r, d, a], dim=2).reshape(B * N, 3, t, t)


def _check_fret(tiles, local_polys, roi_valid, bgs, eps) -> None:
    if tiles.dim() != 5 or tiles.shape[2] != 2 or tiles.shape[-1] != tiles.shape[-2]:
        raise ValueError(f"tiles must be (B, N, 2, t, t), got {tuple(tiles.shape)}")
    B, N = tiles.shape[:2]
    if local_polys.dim() != 4 or tuple(local_polys.shape[:2]) != (B, N) \
            or local_polys.shape[-1] != 2:
        raise ValueError(f"local_polys must be ({B}, {N}, V, 2), got "
                         f"{tuple(local_polys.shape)}")
    if tuple(roi_valid.shape) != (B, N) or roi_valid.dtype != torch.bool:
        raise ValueError(f"roi_valid must be bool ({B}, {N})")
    if tuple(bgs.shape) != (B, 2) or tuple(eps.shape) != (B,) \
            or bgs.dtype != torch.float32 or eps.dtype != torch.float32:
        raise ValueError(f"bgs must be float32 ({B}, 2) and eps float32 ({B},)")
    for name, tns in (("local_polys", local_polys), ("roi_valid", roi_valid),
                      ("bgs", bgs), ("eps", eps)):
        if tns.device != tiles.device:
            raise ValueError(f"{name} is on {tns.device}, tiles on {tiles.device}")


def _fret_packed(rows_fn, tiles, local_polys, roi_valid, bgs, eps, clip_neg,
                 flip) -> torch.Tensor:
    _check_fret(tiles, local_polys, roi_valid, bgs, eps)
    B, N, _, t, _ = tiles.shape
    masks = tile_masks(local_polys, roi_valid, t)                # (B, N, t, t)
    stack = fret_tile_stack(tiles, bgs, eps, clip_neg=clip_neg, flip=flip)
    rows = rows_fn(stack, masks.reshape(B * N, t, t),
                   stack_offsets(B * N, tiles.device))          # (B·N, 3, 9)
    area = masks.sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32)
    stats = rows.view(B, N, 3, N_STATS).permute(0, 3, 2, 1)     # (B, 9, 3, N)
    return torch.cat([stats, area[:, None, None, :].expand(B, 1, 3, N)], dim=1)


def fret_tile_stats_packed_plain(tiles, local_polys, roi_valid, bgs, eps, *,
                                 clip_neg: bool = True,
                                 flip: bool = False) -> torch.Tensor:
    """Plain-PyTorch (B, 10, 3, N) float32 FRET statistics of (B, N, 2,
    t, t) u16 tiles, (B, N, V, 2) tile-local polygons, (B, N) validity,
    (B, 2) backgrounds and (B,) epsilons; rows 0-8 ``STAT_FIELDS``, row 9
    the mask area; channels [ratio, donor, acceptor]."""
    return _fret_packed(roi_stat_rows_plain, tiles, local_polys, roi_valid,
                        bgs, eps, clip_neg, flip)


def fret_tile_stats_packed(tiles, local_polys, roi_valid, bgs, eps, *,
                           clip_neg: bool = True,
                           flip: bool = False) -> torch.Tensor:
    """:func:`fret_tile_stats_packed_plain` with the statistics from the
    CUDA kernel; CUDA tensors only.  Rasterizes, forms the stack, then
    launches the kernel on the current stream without synchronising."""
    if not tiles.is_cuda:
        raise ValueError(
            "fret_tile_stats_packed launches the CUDA kernel and takes CUDA "
            f"tensors only (got {tiles.device}); the CPU path is "
            "fret_tile_stats_packed_plain")
    return _fret_packed(roi_stat_rows, tiles, local_polys, roi_valid, bgs,
                        eps, clip_neg, flip)
