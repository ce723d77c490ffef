"""Packed per-ROI tile statistics: the hand kernel and its plain version.

``tile_stats_packed`` is the batched intensity step on the card: it
rasterizes the tile-local polygons (plain PyTorch, ``geom.rasterize``) and
launches ``kernels/tilestats_u16.cu``, which replaces the TPU kernel
``imageprocess_tpu/ops/pallas_tilestats.py::_kernel`` together with the XLA
moments of ``tile_stats_u16``.  It takes CUDA tensors only and raises on
anything else.

``tile_stats_packed_plain`` computes the same (B, 10, C, N) result in plain
PyTorch — ``tile_stats_from_gathered`` over the frame axis, packed as the
JAX runner's ``_pack`` packs it (rows: the nine ``STAT_FIELDS``, then the
mask area broadcast over C).  It is what the CPU runs and what the kernel
is held to on the card.

``launches`` counts kernel launches (only ``launch_packed``, where the
kernel is launched, adds to it), so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..geom.rasterize import rasterize_polygons
from ..kernels.build import load_library
from .stats import STAT_FIELDS
from .tilestats_u16 import tile_stats_u16_batched

N_ROWS = len(STAT_FIELDS) + 1
P_LO1000, P_HI1000 = 5000, 95000

#: kernel launches since the last reset
launches = {"tilestats_u16": 0}
_smem_limit: Dict[int, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(tiles, local_polys, roi_valid, bgs):
    if tiles.dtype != torch.uint16:
        raise NotImplementedError(
            f"the packed u16 step takes uint16 tiles, got {tiles.dtype}: float "
            "tiles take ops.roistats.tile_stats_from_gathered (the "
            "roistats_f32 kernel), and non-u16 frames in the intensity runner "
            "need the serial intensity path (ROADMAP Queue 1 item 7)")
    if tiles.dim() != 5 or tiles.shape[-1] != tiles.shape[-2]:
        raise ValueError(f"tiles must be (B, N, C, t, t), got {tuple(tiles.shape)}")
    B, N, C, _, _ = tiles.shape
    if local_polys.dim() != 4 or tuple(local_polys.shape[:2]) != (B, N) \
            or local_polys.shape[-1] != 2:
        raise ValueError(f"local_polys must be ({B}, {N}, V, 2), got "
                         f"{tuple(local_polys.shape)}")
    if tuple(roi_valid.shape) != (B, N) or roi_valid.dtype != torch.bool:
        raise ValueError(f"roi_valid must be bool ({B}, {N})")
    if tuple(bgs.shape) != (B, C) or bgs.dtype != torch.float32:
        raise ValueError(f"bgs must be float32 ({B}, {C})")


def tile_masks(local_polys: torch.Tensor, roi_valid: torch.Tensor,
               t: int) -> torch.Tensor:
    """(B, N, V, 2) tile-local polygons -> (B, N, t, t) bool masks, with
    invalid lanes zeroed."""
    B, N, V, _ = local_polys.shape
    masks = rasterize_polygons(local_polys.reshape(B * N, V, 2), (t, t))
    return masks.view(B, N, t, t) & roi_valid[:, :, None, None]


def packed_from_masks_plain(tiles, masks, bgs, *,
                            clip_neg: bool = True) -> torch.Tensor:
    """Plain-PyTorch version of the kernel's own work: (B, 10, C, N)
    packed statistics of (B, N, C, t, t) u16 tiles under (B, N, t, t)
    masks."""
    B, N, C, _, _ = tiles.shape
    area = masks.sum(dim=(-2, -1), dtype=torch.int32)          # (B, N)
    stats = tile_stats_u16_batched(tiles, masks, bgs, clip_neg=clip_neg,
                                   p_lo1000=P_LO1000, p_hi1000=P_HI1000)
    rows = [stats[f].to(torch.float32) for f in STAT_FIELDS]
    rows.append(area.to(torch.float32)[:, None, :].expand(B, C, N))
    return torch.stack(rows, dim=1)


def tile_stats_packed_plain(tiles, local_polys, roi_valid, bgs, *,
                            clip_neg: bool = True) -> torch.Tensor:
    """Plain-PyTorch (B, 10, C, N) float32 packed statistics."""
    _check(tiles, local_polys, roi_valid, bgs)
    masks = tile_masks(local_polys, roi_valid, tiles.shape[-1])
    return packed_from_masks_plain(tiles, masks, bgs, clip_neg=clip_neg)


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("tilestats_u16")
    if not getattr(lib, "_ip_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ip_tilestats_u16.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                         ci, ci, ci, vp]
        lib.ip_tilestats_u16.restype = ci
        lib.ip_tilestats_smem_bytes.argtypes = [ci]
        lib.ip_tilestats_smem_bytes.restype = ctypes.c_longlong
        lib.ip_tilestats_smem_limit.argtypes = [ci]
        lib.ip_tilestats_smem_limit.restype = ctypes.c_longlong
        lib.ip_tilestats_occupancy.argtypes = [ci, ci]
        lib.ip_tilestats_occupancy.restype = ci
        lib.ip_cuda_error_string.argtypes = [ci]
        lib.ip_cuda_error_string.restype = ctypes.c_char_p
        lib._ip_bound = True
    return lib


def kernel_uses_smem(t: int, device: torch.device) -> bool:
    """True when one channel's t x t tile and its mask fit the card's
    opt-in shared memory, so the kernel stages them there; otherwise it
    reads device memory."""
    lib = _lib()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            _smem_limit[idx] = int(lib.ip_tilestats_smem_limit(idx))
        if _smem_limit[idx] <= 0:
            raise RuntimeError("could not read the shared-memory limit of "
                               f"cuda:{idx}")
    return int(lib.ip_tilestats_smem_bytes(t)) <= _smem_limit[idx]


def occupancy(t: int, device: torch.device,
              use_smem: Optional[bool] = None) -> int:
    """Resident CTAs per SM of the variant a launch on t x t tiles takes
    (the grid is one CTA per (frame, ROI, channel))."""
    if use_smem is None:
        use_smem = kernel_uses_smem(t, device)
    with torch.cuda.device(device):
        n = int(_lib().ip_tilestats_occupancy(t, int(bool(use_smem))))
    if n < 0:
        raise RuntimeError(f"could not read the occupancy of tilestats_u16 on {device}")
    return n


def launch_packed(tiles, masks, bgs, *, clip_neg: bool = True,
                  use_smem: Optional[bool] = None) -> torch.Tensor:
    """Launch the kernel on (B, N, C, t, t) u16 tiles, (B, N, t, t) bool
    masks and (B, C) float32 backgrounds, all contiguous on one CUDA
    device; returns the (B, 10, C, N) float32 output.  Launches on the
    current stream and does not synchronise.  *use_smem* forces the kernel
    variant (None: shared memory when the tile fits)."""
    B, N, C, t, _ = tiles.shape
    dev = tiles.device
    for name, tns, dtype in (("tiles", tiles, torch.uint16),
                             ("masks", masks, torch.bool),
                             ("bgs", bgs, torch.float32)):
        if not (tns.is_cuda and tns.device == dev and tns.dtype == dtype
                and tns.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{dev} (got {tns.dtype} on {tns.device})")
    if tuple(masks.shape) != (B, N, t, t) or tuple(bgs.shape) != (B, C):
        raise ValueError(f"masks must be ({B}, {N}, {t}, {t}) and bgs "
                         f"({B}, {C})")
    out = torch.empty((B, N_ROWS, C, N), dtype=torch.float32, device=dev)
    if B * N == 0:
        return out
    if use_smem is None:
        use_smem = kernel_uses_smem(t, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ip_tilestats_u16(
            tiles.data_ptr(), masks.data_ptr(), bgs.data_ptr(),
            out.data_ptr(), B, N, C, t, int(bool(clip_neg)), P_LO1000,
            P_HI1000, int(bool(use_smem)), stream)
    if rc != 0:
        raise RuntimeError(
            f"tilestats_u16 launch failed: {lib.ip_cuda_error_string(rc).decode()}"
            f" (B={B}, N={N}, C={C}, t={t}, use_smem={use_smem})")
    launches["tilestats_u16"] += 1
    return out


def tile_stats_packed(tiles, local_polys, roi_valid, bgs, *,
                      clip_neg: bool = True,
                      use_smem: Optional[bool] = None) -> torch.Tensor:
    """(B, 10, C, N) float32 packed statistics from the CUDA kernel.

    tiles (B, N, C, t, t) uint16, local_polys (B, N, V, 2) float32,
    roi_valid (B, N) bool, bgs (B, C) float32, all on one CUDA device.
    Rasterizes the masks, then launches the kernel (``launch_packed``) on
    the current stream, without synchronising."""
    if not tiles.is_cuda:
        raise ValueError(
            "tile_stats_packed launches the CUDA kernel and takes CUDA "
            f"tensors only (got {tiles.device}); the CPU path is "
            "tile_stats_packed_plain")
    _check(tiles, local_polys, roi_valid, bgs)
    for name, tns in (("local_polys", local_polys), ("roi_valid", roi_valid),
                      ("bgs", bgs)):
        if tns.device != tiles.device:
            raise ValueError(f"{name} is on {tns.device}, tiles on "
                             f"{tiles.device}")
    masks = tile_masks(local_polys, roi_valid, tiles.shape[-1])
    return launch_packed(tiles.contiguous(), masks.contiguous(),
                         bgs.contiguous(), clip_neg=clip_neg,
                         use_smem=use_smem)
