"""The host's native TIFF decoder: ctypes bindings to ``native/tiff_lzw.cpp``.

The port's own copy of the binding (the source file sits at the root of
the repository, beside both packages).  ``decode_tiff(path, page)`` returns
a numpy array (uint8 / uint16 / float32, (H, W) or (H, W, S)), or None when
the file uses a layout the decoder does not take.  Classic TIFF and
BigTIFF; stripped and tiled; none / LZW / Deflate / PackBits; predictor 2;
either endianness.  The fused batch calls decode several frames in one
GIL-free call and build the background histograms and ROI tiles on the
way.

Build: g++ with the flags of ``native/Makefile`` (``-O3 -march=native``,
``-lz``), at first use, into ``imageprocess_tpu_torch/_build/`` under a
name hashed from the source, the flags and the host (``-march=native`` code
runs only on the machine that built it).  A temporary file and
``os.replace`` make concurrent builds from several processes safe.  A
failed build raises; there is no fallback decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO, "native", "tiff_lzw.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]
LIBS = ["-lpthread", "-lz"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the decoder for this source, these flags and this host lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(platform.node().encode())
    h.update(platform.machine().encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libiptiff_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"could not run g++ for {SOURCE}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{(res.stdout + res.stderr).strip()}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    """The decoder library, built at first use; raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib) -> None:
    cint, cll, u8p = ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ip_tiff_info.argtypes = [ctypes.c_char_p, cint, ip, ip, ip, ip]
    lib.ip_tiff_info.restype = cint
    lib.ip_tiff_decode.argtypes = [ctypes.c_char_p, cint, u8p, cll]
    lib.ip_tiff_decode.restype = cint
    lib.ip_tiff_decode_batch_hist.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), cint, cint, u8p, cll,
        cint, cint, cint, cint, cll, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.ip_tiff_decode_batch_hist.restype = cint
    lib.ip_tiff_decode_batch_hist_tiles.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), cint, cint, u8p, cll,
        cint, cint, cint, cint, cll, ctypes.POINTER(ctypes.c_uint32),
        cint, cint, ctypes.POINTER(ctypes.c_int32), u8p,
    ]
    lib.ip_tiff_decode_batch_hist_tiles.restype = cint
    lib.ip_u16_percentile_strided.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), cll, cll, cint,
    ]
    lib.ip_u16_percentile_strided.restype = ctypes.c_double
    lib.ip_u16_hist.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), cll, cll, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.ip_u16_hist.restype = None


def _info(lib, path: str, page: int):
    """(H, W, bits, samples) of *path*'s page, or None if unsupported."""
    h, w, bits, samples = (ctypes.c_int() for _ in range(4))
    if lib.ip_tiff_info(path.encode(), page, ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(bits), ctypes.byref(samples)) != 0:
        return None
    return h.value, w.value, bits.value, samples.value


def _dtype(bits: int):
    return np.float32 if bits == 32 else np.uint16 if bits == 16 else np.uint8


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


class FrameBufferPool:
    """Small thread-safe free-list of decode output buffers keyed by
    (shape, dtype).  Frames this size go through malloc's mmap path, so a
    plain allocate-per-key loop pays an munmap + fresh-page-fault cycle
    per frame; recycling keeps the pages warm.  Callers ``put()`` a buffer
    back only once nothing references it: the next ``get()`` hands the same
    memory to a decoder that overwrites every byte."""

    def __init__(self, max_items: int = 64):
        self._lock = threading.Lock()
        self._free: dict = {}
        self._max = max_items
        self._count = 0

    def get(self, shape, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            lst = self._free.get(key)
            if lst:
                self._count -= 1
                return lst.pop()
        return np.empty(shape, dtype)

    def put(self, arr: Optional[np.ndarray]) -> None:
        if arr is None or not isinstance(arr, np.ndarray):
            return
        if not arr.flags.c_contiguous or arr.base is not None:
            return  # only whole owned buffers are recyclable
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            if self._count >= self._max:
                return
            self._free.setdefault(key, []).append(arr)
            self._count += 1


def tiff_info(path: str, page: int = 0):
    """(H, W, bits, samples) from the TIFF header, or None when the file is
    not one the decoder takes."""
    return _info(_load(), path, page)


def decode_tiff(path: str, page: int = 0) -> Optional[np.ndarray]:
    """One page of *path* as a numpy array, or None if unsupported."""
    lib = _load()
    info = _info(lib, path, page)
    if info is None:
        return None
    h, w, bits, samples = info
    out = np.empty((h, w) if samples == 1 else (h, w, samples), _dtype(bits))
    if lib.ip_tiff_decode(path.encode(), page, _u8(out), out.nbytes) != 0:
        return None
    return out


def decode_tiff_batch_hist(paths, hist_stride: int, page: int = 0,
                           pool: Optional[FrameBufferPool] = None):
    """Decode N same-shaped TIFFs into one (N, H, W[, S]) array with one
    native call (a thread per file) and, when *hist_stride* >= 1 and the
    files are 16-bit single-sample, a per-file counting histogram of
    ``frame.ravel()[::hist_stride]`` built during the decode.  Returns
    (frames, hists (N, 65536) u32 or None), or None when a file is
    unsupported or does not match the first one's shape."""
    lib = _load()
    if not paths:
        return None
    info = _info(lib, paths[0], page)
    if info is None:
        return None
    h, w, bits, samples = info
    frame_shape = (h, w) if samples == 1 else (h, w, samples)
    full_shape = (len(paths),) + frame_shape
    dtype = _dtype(bits)
    out = (pool.get(full_shape, dtype) if pool is not None
           else np.empty(full_shape, dtype))
    want_hist = hist_stride >= 1 and bits == 16 and samples == 1
    hists = np.zeros((len(paths), 65536), np.uint32) if want_hist else None
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.ip_tiff_decode_batch_hist(
        arr, len(paths), page, _u8(out), out.nbytes // len(paths),
        h, w, bits, samples, int(hist_stride) if want_hist else 0, _u32(hists))
    if rc != 0:
        return None
    return out, hists


def decode_tiff_batch_hist_tiles(paths, hist_stride: int,
                                 offsets: np.ndarray, tile: int,
                                 page: int = 0, pad_tiles: int = 0,
                                 pool: Optional[FrameBufferPool] = None):
    """:func:`decode_tiff_batch_hist` plus the ROI tiles: the decoder's
    threads copy each ``tile``-square rectangle (``offsets`` (N, 2) int32
    [oy, ox], shared by every file of the batch) out of the just-decoded
    frames.  Returns (frames (C, H, W), hists or None, tiles (N + pad_tiles,
    C, tile, tile)), the ``pad_tiles`` extra lanes zeroed; None when a file
    is unsupported or not 16-bit single-sample."""
    lib = _load()
    if not paths:
        return None
    info = _info(lib, paths[0], page)
    if info is None:
        return None
    h, w, bits, samples = info
    if bits != 16 or samples != 1:
        return None
    offsets = np.ascontiguousarray(offsets, np.int32)
    n = int(offsets.shape[0])
    full_shape = (len(paths), h, w)
    out = (pool.get(full_shape, np.uint16) if pool is not None
           else np.empty(full_shape, np.uint16))
    want_hist = hist_stride >= 1
    hists = np.zeros((len(paths), 65536), np.uint32) if want_hist else None
    tiles_shape = (n + pad_tiles, len(paths), tile, tile)
    tiles = (pool.get(tiles_shape, np.uint16) if pool is not None
             else np.empty(tiles_shape, np.uint16))
    if pad_tiles:
        tiles[n:] = 0
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.ip_tiff_decode_batch_hist_tiles(
        arr, len(paths), page, _u8(out), out.nbytes // len(paths),
        h, w, bits, samples, int(hist_stride) if want_hist else 0, _u32(hists),
        n, int(tile), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8(tiles))
    if rc != 0:
        return None
    return out, hists, tiles


def u16_percentile_strided(arr: np.ndarray, stride: int, p1000: int) -> float:
    """Exact ``np.percentile(arr.ravel()[::stride], p1000 / 1000)`` of a
    uint16 array, by one counting pass."""
    a = np.ascontiguousarray(arr, dtype=np.uint16)
    return float(_load().ip_u16_percentile_strided(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), a.size,
        max(1, int(stride)), int(p1000)))


def u16_hist(arr: np.ndarray, stride: int = 1) -> np.ndarray:
    """65536-bin counting histogram of ``arr.ravel()[::stride]`` (uint16)."""
    a = np.ascontiguousarray(arr, dtype=np.uint16)
    hist = np.zeros(65536, np.uint32)
    _load().ip_u16_hist(a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                        a.size, max(1, int(stride)), _u32(hist))
    return hist


def hist_order_stats(hist: np.ndarray, p1000: int):
    """(lo, hi, g): the two exact integer order statistics and the
    interpolation weight of ``np.percentile(values, p1000 / 1000,
    method='linear')`` over a counting histogram.  A percentile of a
    monotone transform of the values transforms lo and hi first and
    interpolates after, bit-equal to sorting the transformed values."""
    cdf = np.cumsum(hist.astype(np.int64))
    n = int(cdf[-1])
    if n == 0:
        return 0, 0, 0.0
    idx = (n - 1) * int(p1000)
    k = idx // 100000
    g = (idx % 100000) / 100000.0
    lo = int(np.searchsorted(cdf, k, side="right"))
    hi = int(np.searchsorted(cdf, min(k + 1, n - 1), side="right"))
    return lo, hi, g


def percentile_from_hist(hist: np.ndarray, p1000: int) -> float:
    """Exact ``np.percentile(values, p1000 / 1000, method='linear')`` from a
    counting histogram of integer values."""
    lo, hi, g = hist_order_stats(hist, p1000)
    return float(lo) + g * float(hi - lo)


def hist_mode_from_hist(hist: np.ndarray, p1000: int) -> float:
    """The "hist-mode" background (the first of 2048 bins over [min, max]
    whose CDF reaches p1000 / 100000, at its midpoint) from a u16 counting
    histogram of the strided subsample.  float32 arithmetic: the one f32
    division per value is the only rounding of the binning, and the CDF is
    an exact integer cumsum cast to f32 and divided once."""
    counts = np.asarray(hist, np.int64)
    nz = np.flatnonzero(counts)
    if nz.size == 0:
        return 0.0
    return _hist_mode_core(nz.astype(np.float32), counts[nz],
                           np.float32(nz[0]), np.float32(nz[-1]), p1000)


def hist_mode_from_values(vals: np.ndarray, p1000: int) -> float:
    """:func:`hist_mode_from_hist` of a raw (already strided) value array,
    for frames that are not integral."""
    v = np.asarray(vals, np.float32)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return 0.0
    return _hist_mode_core(v, None, v.min(), v.max(), p1000)


def _hist_mode_core(v: np.ndarray, weights, lo, hi, p1000: int) -> float:
    """2048-bin binning, CDF and first-bin midpoint; ``weights=None``
    counts each value once."""
    span = np.float32(hi - lo) if hi > lo else np.float32(1.0)
    idx = ((v - lo) / span * np.float32(2048.0)).astype(np.int32)
    np.clip(idx, 0, 2047, out=idx)
    h2 = np.zeros(2048, np.int64)
    np.add.at(h2, idx, 1 if weights is None else weights)
    cdf = np.cumsum(h2).astype(np.float32) / np.float32(h2.sum())
    target = np.float32(p1000) / np.float32(100000.0)
    reach = cdf >= target
    if not reach.any():
        return float(hi)
    first = int(np.argmax(reach))
    bin_w = span / np.float32(2048.0)
    return float(lo + (np.float32(first) + np.float32(0.5)) * bin_w)
