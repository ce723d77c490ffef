"""Port parity: polygon rasterization (geom.rasterize).

Masks must be bit-equal to the JAX ``rasterize_polygons`` for both edge
rules: lattice and half-lattice vertices, free-float vertices, padded
(repeated-vertex) polygons and tile-local shifts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.geom.polygon import pad_polygons
from imageprocess_tpu.geom.rasterize import EdgeRule as JRule
from imageprocess_tpu.geom.rasterize import rasterize_polygons as j_rasterize
from imageprocess_tpu_torch.geom.rasterize import EdgeRule, rasterize_polygons

SQUARE = np.array([[2.0, 3.0], [10.0, 3.0], [10.0, 8.0], [2.0, 8.0]])
TRIANGLE = np.array([[1.5, 1.5], [12.5, 2.5], [5.0, 11.0]])
CONCAVE = np.array(
    [[1.0, 1.0], [11.0, 1.0], [11.0, 11.0], [6.0, 6.0], [1.0, 11.0]])
RULES = ["MPL", "PNPOLY"]


def _both(pv, shape, rule):
    pv = np.asarray(pv, np.float32)
    want = np.asarray(j_rasterize(jnp.asarray(pv), shape, JRule[rule]))
    got = rasterize_polygons(torch.from_numpy(pv), shape, EdgeRule[rule])
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    return got.numpy(), want


def _star(rng, n, lo, hi, grid=None):
    pts = rng.uniform(lo, hi, size=(n, 2))
    c = pts.mean(axis=0)
    poly = pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]
    return poly if grid is None else np.round(poly * grid) / grid


@pytest.mark.parametrize("rule", RULES)
def test_synthetic_shapes_bit_equal(rule):
    got, want = _both(pad_polygons([SQUARE, TRIANGLE, CONCAVE]), (16, 16), rule)
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("grid", [1, 2, None], ids=["int", "half", "float"])
def test_random_polygons_bit_equal(rule, grid):
    rng = np.random.default_rng(42)
    polys = [_star(rng, int(rng.integers(3, 14)), 2, 62, grid)
             for _ in range(24)]
    got, want = _both(pad_polygons(polys, 32), (64, 64), rule)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule", RULES)
def test_out_of_frame_and_degenerate_bit_equal(rule):
    """Vertices outside the frame (clipped thresholds), a zero-area
    polygon and a sliver around one pixel centre (on its boundary)."""
    rng = np.random.default_rng(3)
    polys = [_star(rng, 9, -20, 90) for _ in range(6)] + [
        np.full((4, 2), 5.0),
        np.array([[3.0, 3.0], [3.4, 3.0], [3.4, 3.4]])]
    got, want = _both(pad_polygons(polys, 16), (48, 40), rule)
    np.testing.assert_array_equal(got, want)
    assert not want[-2].any()


@pytest.mark.parametrize("rule", RULES)
def test_padding_is_inert(rule):
    """Padding with the first vertex adds only degenerate edges: the mask
    of a padded polygon equals the unpadded one."""
    poly = np.array([[2.5, 1.5], [20.5, 4.5], [14.5, 19.5], [1.5, 12.5]])
    tight, _ = _both(pad_polygons([poly], 4), (24, 24), rule)
    padded, want = _both(pad_polygons([poly], 64), (24, 24), rule)
    np.testing.assert_array_equal(padded, want)
    np.testing.assert_array_equal(padded, tight)


@pytest.mark.parametrize("rule", RULES)
def test_tile_local_shift_exact(rule):
    """Half-lattice polygons shifted by an integer tile offset rasterize to
    the crop of the full-frame mask (what the tiled path relies on)."""
    rng = np.random.default_rng(5)
    H, W, t = 128, 136, 48
    polys = [_star(rng, 10, 8, 40, 2) + np.array([ox, oy])
             for ox, oy in ((10, 20), (50, 5), (33, 41))]
    full, _ = _both(pad_polygons(polys, 16), (H, W), rule)
    for i, p in enumerate(polys):
        oy = int(np.floor(p[:, 1].min()))
        ox = int(np.floor(p[:, 0].min()))
        local = p - np.array([ox, oy], float)
        tile, want = _both(pad_polygons([local], 16), (t, t), rule)
        np.testing.assert_array_equal(tile, want)
        np.testing.assert_array_equal(tile[0], full[i, oy:oy + t, ox:ox + t])
