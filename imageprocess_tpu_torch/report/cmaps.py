"""Colormap lookup tables without matplotlib.

``_cmap_luts.npz`` beside this module holds one (256, 4) uint8 LUT for every
colormap name that matplotlib 3.10.8 registers (180 names, the reversed
``*_r`` ones included), each sampled as the JAX package's
``report.render._cmap_lut_u8`` samples it:
``(cm(np.linspace(0, 1, 256)) * 255 + 0.5).astype(uint8)``.
``tests/test_torch_render.py`` regenerates every table from matplotlib and
holds it equal.

A colormap is a registered name or a (256, 4) uint8 LUT; the black -> colour
ramps are computed here in numpy.  An unknown name raises: there is no
fallback colormap.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Union

import numpy as np

LUT_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_cmap_luts.npz")

# render.get_cmap_for_color's pure channel ramps (green is (0, 1, 0))
SINGLE_RGB = {
    "cyan": (0.0, 1.0, 1.0),
    "yellow": (1.0, 1.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "red": (1.0, 0.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
    "magenta": (1.0, 0.0, 1.0),
}
# the FA crop's ramps go to matplotlib's CSS named colours (green is
# #008000): LinearSegmentedColormap.from_list(["black", name])
CSS_RGB = {
    "blue": (0.0, 0.0, 1.0),
    "cyan": (0.0, 1.0, 1.0),
    "green": (0.0, 128.0 / 255.0, 0.0),
    "yellow": (1.0, 1.0, 0.0),
    "red": (1.0, 0.0, 0.0),
    "magenta": (1.0, 0.0, 1.0),
}

Cmap = Union[str, np.ndarray]

_TABLE: Dict[str, np.ndarray] = {}
_LOCK = threading.Lock()


def _table() -> Dict[str, np.ndarray]:
    with _LOCK:
        if not _TABLE:
            with np.load(LUT_TABLE) as z:
                _TABLE.update({k: z[k] for k in z.files})
    return _TABLE


def names():
    """Every colormap name of the table, sorted."""
    return sorted(_table())


def lut_u8(cmap: Cmap) -> np.ndarray:
    """(256, 4) uint8 LUT of a colormap name or of a LUT given as such."""
    if not isinstance(cmap, str):
        lut = np.asarray(cmap)
        if lut.shape != (256, 4) or lut.dtype != np.uint8:
            raise ValueError(f"a colormap LUT is (256, 4) uint8, got "
                             f"{lut.dtype}{lut.shape}")
        return lut
    lut = _table().get(cmap)
    if lut is None:
        raise ValueError(f"colormap {cmap!r} is not in the LUT table {LUT_TABLE} "
                         f"(matplotlib 3.10.8's registered names)")
    return lut


def ramp_lut(rgb) -> np.ndarray:
    """The (256, 4) uint8 LUT of a two-point black -> *rgb* colormap
    (``LinearSegmentedColormap`` with N = 256, sampled at 256 points): entry
    k is colour * k / 255, rounded as the table is."""
    x = np.linspace(0.0, 1.0, 256)
    lut = np.ones((256, 4))
    for c in range(3):
        lut[:, c] = x * float(rgb[c])
    return (lut * 255.0 + 0.5).astype(np.uint8)


def single_color_lut(color_name: str) -> np.ndarray:
    """``render.get_cmap_for_color``'s black -> colour ramp of a
    ``SINGLE_RGB`` name (lower case)."""
    return ramp_lut(SINGLE_RGB[color_name])


def css_ramp_lut(color_name: str) -> np.ndarray:
    """The FA crop's ``from_list(["black", name])`` ramp of a ``CSS_RGB``
    name (lower case)."""
    return ramp_lut(CSS_RGB[color_name])
