"""Per-ROI statistics of float32 tiles and frames: the hand kernels and
their plain versions.

Counterpart of ``imageprocess_tpu/ops/pallas_roistats.py``, in two forms.
The tile form serves the tile callers: ``frames`` (F, C, H, W) float32,
``masks`` (R, T, T) bool and per-ROI int32 origins ``offs`` (R, 3) =
(frame, row, col) give the (R, C, 9) float32 statistics of each ROI's
(T, T) tile in every channel, in ``STAT_FIELDS`` order (npx as a float).
Origins are clamped into the frame as ``jax.lax.dynamic_slice`` clamps
them.  The frame form takes whole frames: ``frames`` (C, H, W) float32 and
``masks`` (N, H, W) bool give the (N, C, 9) rows of every full-frame mask.

- ``roi_stat_rows`` launches ``kernels/roistats_f32.cu``, ``roi_frame_rows``
  ``kernels/roistats_f32_frame.cu`` (one thread-block cluster per (ROI,
  channel)).  They take CUDA tensors only and raise on anything else, on a
  failed build and on a failed launch.
- ``roi_stat_rows_plain`` and ``roi_frame_rows_plain`` compute the same in
  plain PyTorch (``ops.stats.masked_stats_batched``): what the CPU runs and
  what the kernels are held to on the card.

The FRET tables step is built on them: ``fret_tile_stats_packed`` (kernel)
and ``fret_tile_stats_packed_plain`` rasterize the tile-local polygons,
form [ratio, donor, acceptor] from the raw u16 tiles in plain PyTorch and
return the (B, 10, 3, N) packing of the JAX runner (nine statistics, then
the mask area).

``launches`` counts kernel launches: only ``roi_stat_rows``
(``"roistats_f32"``) and ``roi_frame_rows`` (``"roistats_f32_frame"``),
where the kernels are launched, add to it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..kernels.build import load_library
from .ratio import ratio_with_eps
from .stats import STAT_FIELDS, masked_stats_batched
from .tile_stats_kernel import tile_masks

N_STATS = len(STAT_FIELDS)
P_LO1000, P_HI1000 = 5000, 95000

#: kernel launches since the last reset
launches = {"roistats_f32": 0, "roistats_f32_frame": 0}
_smem_limit: Dict[int, int] = {}
_frame_props: Dict[int, Tuple[int, int, int]] = {}
_variants: Dict[Tuple[int, int], Tuple[bool, bool]] = {}


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
                                        ci, ci, ci, ci, vp]
        lib.ip_roistats_f32.restype = ci
        lib.ip_roistats_smem_bytes.argtypes = [ci, ci]
        lib.ip_roistats_smem_bytes.restype = ctypes.c_longlong
        lib.ip_roistats_smem_limit.argtypes = [ci]
        lib.ip_roistats_smem_limit.restype = ctypes.c_longlong
        lib.ip_roistats_occupancy.argtypes = [ci, ci, ci]
        lib.ip_roistats_occupancy.restype = ci
        lib.ip_cuda_error_string.argtypes = [ci]
        lib.ip_cuda_error_string.restype = ctypes.c_char_p
        lib._ip_bound = True
    return lib


def smem_fits(T: int, device: torch.device) -> Tuple[bool, bool]:
    """(the keys fit, keys and mask fit) the card's opt-in shared memory
    for T x T tiles."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    lib = _lib()
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            _smem_limit[idx] = int(lib.ip_roistats_smem_limit(idx))
        if _smem_limit[idx] <= 0:
            raise RuntimeError(f"could not read the shared-memory limit of cuda:{idx}")
    return tuple(int(lib.ip_roistats_smem_bytes(T, m)) <= _smem_limit[idx]
                 for m in (0, 1))


def _defaults(T: int, device: torch.device) -> Tuple[bool, bool]:
    """(stage the keys, stage the mask too) for T x T tiles, cached per
    (device, T).  The keys are staged when they fit the card's opt-in
    shared memory; the mask beside them when both fit and that leaves as
    many resident CTAs per SM as the keys alone (at T = 144 it halves
    them, and the keys alone ran 22 % faster on an H100: PERF.md)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    got = _variants.get((idx, T))
    if got is None:
        keys_fit, both_fit = smem_fits(T, device)
        if both_fit:
            with torch.cuda.device(idx):
                occ = [int(_lib().ip_roistats_occupancy(T, 1, m)) for m in (0, 1)]
            if min(occ) < 0:
                raise RuntimeError(f"could not read the occupancy of roistats_f32 "
                                   f"on cuda:{idx}")
            both_fit = occ[1] >= occ[0]
        got = (keys_fit, both_fit)
        _variants[(idx, T)] = got
    return got


def kernel_uses_smem(T: int, device: torch.device) -> bool:
    """True when a T x T tile's keys fit the card's opt-in shared memory,
    so the kernel stages them there; otherwise it reads device memory."""
    return _defaults(T, device)[0]


def kernel_variant(T: int, device: torch.device, use_smem: Optional[bool] = None,
                   stage_mask: Optional[bool] = None) -> Tuple[bool, bool]:
    """(use_smem, stage_mask) of a launch on T x T tiles: by default the
    keys in shared memory when they fit, and the mask beside them as
    ``_defaults`` decides.  An argument that is not None forces its part
    (a mask is staged only with the keys)."""
    keys_fit, with_mask = _defaults(T, device)
    if use_smem is None:
        use_smem = keys_fit
    if stage_mask is None:
        stage_mask = with_mask
    return bool(use_smem), bool(use_smem and stage_mask)


def occupancy(T: int, device: torch.device, use_smem: Optional[bool] = None,
              stage_mask: Optional[bool] = None) -> int:
    """Resident CTAs per SM of the variant a launch on T x T tiles takes
    (the grid is one CTA per (ROI, channel))."""
    use_smem, stage_mask = kernel_variant(T, device, use_smem, stage_mask)
    with torch.cuda.device(device):
        n = int(_lib().ip_roistats_occupancy(T, int(use_smem), int(stage_mask)))
    if n < 0:
        raise RuntimeError(f"could not read the occupancy of roistats_f32 on {device}")
    return n


def roi_stat_rows(frames, masks, offs, *, p_lo1000: int = P_LO1000,
                  p_hi1000: int = P_HI1000, use_smem: Optional[bool] = None,
                  stage_mask: Optional[bool] = None) -> torch.Tensor:
    """(R, C, 9) float32 statistics from the CUDA kernel, launched on the
    current stream without synchronising.  All three tensors contiguous
    on one CUDA device.  *use_smem* and *stage_mask* force the kernel
    variant (None: as ``kernel_variant`` picks it)."""
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
    use_smem, stage_mask = kernel_variant(T, dev, use_smem, stage_mask)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ip_roistats_f32(
            frames.data_ptr(), masks.data_ptr(), offs.data_ptr(),
            out.data_ptr(), R, F, C, H, W, T, int(p_lo1000), int(p_hi1000),
            int(use_smem), int(stage_mask), stream)
    if rc != 0:
        raise RuntimeError(
            f"roistats_f32 launch failed: {lib.ip_cuda_error_string(rc).decode()}"
            f" (R={R}, F={F}, C={C}, H={H}, W={W}, T={T}, use_smem={use_smem}, "
            f"stage_mask={stage_mask})")
    launches["roistats_f32"] += 1
    return out


# ------------------------------------------------------------------ frame form

def _check_frame(frames, masks) -> None:
    if frames.dim() != 3 or masks.dim() != 3 \
            or tuple(frames.shape[1:]) != tuple(masks.shape[1:]):
        raise ValueError(f"frames must be (C, H, W) and masks (N, H, W) of the same "
                         f"H x W, got {tuple(frames.shape)} and {tuple(masks.shape)}")
    if frames.dtype != torch.float32 or masks.dtype != torch.bool:
        raise ValueError("frames must be float32 and masks bool "
                         f"(got {frames.dtype}, {masks.dtype})")
    H, W = frames.shape[1:]
    if H < 1 or W < 1 or H * W >= 2 ** 31:
        raise ValueError(f"a {H} x {W} frame is empty or has 2^31 pixels or more")


def roi_frame_rows_plain(frames, masks, *, p_lo1000: int = P_LO1000,
                         p_hi1000: int = P_HI1000) -> torch.Tensor:
    """Plain-PyTorch (N, C, 9) float32 statistics of (C, H, W) float32
    *frames* over (N, H, W) bool *masks*, as they are (no padding)."""
    _check_frame(frames, masks)
    stats = masked_stats_batched(frames[None], masks[:, None], p_lo1000, p_hi1000)
    return torch.stack([stats[f].to(torch.float32) for f in STAT_FIELDS], -1)


def _frame_lib() -> ctypes.CDLL:
    """The built frame-form library with its C signatures declared."""
    lib = load_library("roistats_f32_frame")
    if not getattr(lib, "_ip_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ip_roistats_f32_frame.argtypes = [vp, vp, vp] + [ci] * 8 + [vp]
        lib.ip_roistats_f32_frame.restype = ci
        lib.ip_roistats_frame_max_warp_cap.argtypes = [ci]
        lib.ip_roistats_frame_max_warp_cap.restype = ci
        lib.ip_roistats_frame_max_cluster.argtypes = [ci]
        lib.ip_roistats_frame_max_cluster.restype = ci
        lib.ip_frame_error_string.argtypes = [ci]
        lib.ip_frame_error_string.restype = ctypes.c_char_p
        lib._ip_bound = True
    return lib


def frame_props(device: torch.device) -> Tuple[int, int, int]:
    """(SMs, the largest cluster size the card holds, the most keys per
    warp's list) of the frame kernel on *device*, cached per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    got = _frame_props.get(idx)
    if got is None:
        lib = _frame_lib()
        with torch.cuda.device(idx):
            cap = int(lib.ip_roistats_frame_max_warp_cap(idx))
            gmax = int(lib.ip_roistats_frame_max_cluster(cap)) if cap >= 0 else -1
        if cap < 0 or gmax < 1:
            raise RuntimeError(f"could not size roistats_f32_frame's clusters on "
                               f"cuda:{idx} (lists {cap}, cluster {gmax})")
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        got = _frame_props[idx] = (sms, gmax, cap)
    return got


def frame_cluster(lanes: int, H: int, sms: int, max_cluster: int) -> int:
    """CTAs per (ROI, channel) of the frame kernel: the largest power of two
    that keeps *lanes* x G CTAs within one wave of *sms* (one CTA per SM),
    at most *max_cluster* and at most *H* (a band of one row or more each);
    at least 1."""
    g = 1
    while 2 * g <= min(max_cluster, H) and 2 * g * lanes <= sms:
        g *= 2
    return g


def roi_frame_rows(frames, masks, *, p_lo1000: int = P_LO1000,
                   p_hi1000: int = P_HI1000, cluster: Optional[int] = None,
                   warp_cap: Optional[int] = None) -> torch.Tensor:
    """(N, C, 9) float32 statistics of (C, H, W) *frames* over (N, H, W)
    *masks* from the frame kernel, launched on the current stream without
    synchronising.  Both tensors contiguous on one CUDA device.  *cluster*
    forces the CTAs per (ROI, channel) and *warp_cap* the keys each warp's
    list holds (None: ``frame_cluster`` and the most that fit)."""
    dev = frames.device
    for name, tns in (("frames", frames), ("masks", masks)):
        if not (tns.is_cuda and tns.device == dev and tns.is_contiguous()):
            raise ValueError(
                f"roi_frame_rows launches the CUDA kernel: {name} must be a "
                f"contiguous tensor on one CUDA device (got {tns.device}); "
                "the CPU path is roi_frame_rows_plain")
    _check_frame(frames, masks)
    C, H, W = frames.shape
    N = masks.shape[0]
    out = torch.empty((N, C, N_STATS), dtype=torch.float32, device=dev)
    if N * C == 0:
        return out
    sms, gmax, cap = frame_props(dev)
    G = frame_cluster(N * C, H, sms, gmax) if cluster is None else int(cluster)
    wc = cap if warp_cap is None else int(warp_cap)
    if not (1 <= G <= gmax and 0 <= wc <= cap):
        raise ValueError(f"cluster {G} must be in 1..{gmax} and warp_cap {wc} "
                         f"in 0..{cap}")
    lib = _frame_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ip_roistats_f32_frame(
            frames.data_ptr(), masks.data_ptr(), out.data_ptr(), N, C, H, W,
            int(p_lo1000), int(p_hi1000), G, wc, stream)
    if rc != 0:
        raise RuntimeError(
            f"roistats_f32_frame launch failed: "
            f"{lib.ip_frame_error_string(rc).decode()} (N={N}, C={C}, H={H}, "
            f"W={W}, cluster={G}, warp_cap={wc})")
    launches["roistats_f32_frame"] += 1
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
