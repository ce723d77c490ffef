"""Host-side polygon padding (the port's copy)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pad_polygons(
    polys: Sequence[np.ndarray], max_vertices: int | None = None
) -> np.ndarray:
    """Stack ragged polygons into a dense (N, V, 2) float32 array, padding by
    repeating each polygon's first vertex.

    Padding with vertex 0 makes every synthetic edge either degenerate
    (v0 -> v0) or the true closing edge (v_last -> v0), so the crossing-test
    rasterizer needs no validity mask."""
    if max_vertices is None:
        max_vertices = max(len(p) for p in polys)
    out = np.zeros((len(polys), max_vertices, 2), dtype=np.float32)
    for i, p in enumerate(polys):
        p = np.asarray(p, dtype=np.float32)
        n = min(len(p), max_vertices)
        out[i, :n] = p[:n]
        out[i, n:] = p[0]
    return out
