"""Single-frame TIFF reads and writes (port of
``imageprocess_tpu/core/tiffio.py``).

Reads: the port's native decoder (``imageprocess_tpu_torch.native``) first;
PIL only for files the decoder does not take (it returns None for them).  A
>2-D page is squeezed by taking channel 0, as the intensity and FRET
pipelines do, or index 0 of its smallest axis, as the focal-adhesion
pipeline does (``read_2d(..., squeeze="smallest_axis")``).

Writes go through PIL and are atomic (``.tmp`` + ``os.replace``).
"""

from __future__ import annotations

import os

import numpy as np

from .. import native


def read_tiff(path: str, page: int = 0) -> np.ndarray:
    """Decode one TIFF page to a numpy array (dtype preserved)."""
    arr = native.decode_tiff(path, page)
    if arr is not None:
        return arr
    from PIL import Image

    with Image.open(path) as im:
        try:
            im.seek(page)
        except EOFError:
            im.seek(0)
        return np.array(im)


def squeeze_first_channel(a: np.ndarray) -> np.ndarray:
    """>2-D page -> 2-D by taking channel 0."""
    if a.ndim > 2:
        a = a[..., 0] if a.ndim == 3 else a[0, ...]
    return a


def squeeze_smallest_axis(a: np.ndarray) -> np.ndarray:
    """>2-D page -> 2-D by slicing index 0 of the smallest axis, repeatedly
    (channel-first or channel-last, whichever the file has)."""
    while a.ndim > 2:
        a = np.take(a, 0, axis=int(np.argmin(a.shape)))
    return a


def read_2d(path: str, dtype=np.float32,
            squeeze: str = "first_channel") -> np.ndarray:
    """2-D page as *dtype* (None keeps the file's dtype, so a device
    pipeline uploads compact u16 and casts on the card).  *squeeze* is
    ``"first_channel"`` or ``"smallest_axis"``."""
    a = read_tiff(path)
    a = (squeeze_first_channel(a) if squeeze == "first_channel"
         else squeeze_smallest_axis(a))
    if dtype is None:
        return a
    return a.astype(dtype, copy=False)


def _atomic_save(im, path: str, **kwargs) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(tmp, format="TIFF", **kwargs)
    os.replace(tmp, path)


def _write(path: str, img: np.ndarray, dtype) -> None:
    from PIL import Image

    # the image mode is inferred from the array's dtype ("F", "I;16", "L")
    _atomic_save(Image.fromarray(np.ascontiguousarray(img, dtype=dtype)), path)


def write_tiff32(path: str, img: np.ndarray) -> None:
    """Float32 single-channel TIFF (analysis-grade output)."""
    _write(path, img, np.float32)


def write_tiff16(path: str, img: np.ndarray) -> None:
    """Uint16 single-channel TIFF (preview-grade output)."""
    _write(path, img, np.uint16)


def write_tiff8(path: str, img: np.ndarray) -> None:
    """Uint8 single-channel TIFF (e.g. ROI masks, 0/255)."""
    _write(path, img, np.uint8)


def normalize_to_u16(
    img: np.ndarray, lo: float, hi: float, eps: float = 1e-12
) -> np.ndarray:
    """Clip to [lo, hi], normalize, scale to the full uint16 range: the
    16-bit preview transform.  NaN pixels give 0."""
    clipped = np.clip(img, lo, hi)
    norm = (clipped - lo) / (hi - lo + eps)
    return (np.nan_to_num(norm, nan=0.0) * 65535).astype(np.uint16)
