"""Single-frame TIFF reads (port of ``imageprocess_tpu/core/tiffio.py``,
the read side).

The port's native decoder (``imageprocess_tpu_torch.native``) first; PIL
only for files the decoder does not take (it returns None for them).  A
>2-D page is squeezed by taking channel 0, as the intensity and FRET
pipelines do.  The TIFF writers stay with the image outputs, which are not
ported.
"""

from __future__ import annotations

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


def read_2d(path: str, dtype=np.float32) -> np.ndarray:
    """2-D page (channel 0) as *dtype* (None keeps the file's dtype, so a
    device pipeline uploads compact u16 and casts on the card)."""
    a = squeeze_first_channel(read_tiff(path))
    if dtype is None:
        return a
    return a.astype(dtype, copy=False)
