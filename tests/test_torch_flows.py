"""Port parity: flow following (``imageprocess_tpu_torch.segment.flows``)
against the JAX functions on the CPU, on the same numpy fields.

Bars, and why:
- ``follow_flows`` landings within 1e-4 px and equal after rounding: the
  same float32 expressions, but XLA's CPU compiler contracts the bilinear
  interpolation into fused multiply-adds where PyTorch rounds each
  product, a few ulps of the coordinates (~3e-5 px measured);
- ``flow_label`` bit-equal: its inputs are the rounded landings, and the
  histogram, dilation and CCL after them are integer work."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.segment import flows as jflows
from imageprocess_tpu_torch.segment import flows as tflows
from imageprocess_tpu_torch.timing import PhaseTimer

LAND_ATOL = 1e-4


def _two_cell_scene(H=96, W=128, c1=(48, 40), c2=(48, 80), r=22):
    """Two touching discs + analytic center-pointing unit flows."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d1 = np.sqrt((yy - c1[0]) ** 2 + (xx - c1[1]) ** 2)
    d2 = np.sqrt((yy - c2[0]) ** 2 + (xx - c2[1]) ** 2)
    fg = (d1 <= r) | (d2 <= r)
    use1 = d1 <= d2
    dy = np.where(use1, c1[0], c2[0]) - yy
    dx = np.where(use1, c1[1], c2[1]) - xx
    n = np.sqrt(dy ** 2 + dx ** 2) + 1e-6
    flows = np.stack([dy / n, dx / n], axis=-1).astype(np.float32)
    flows[~fg] = 0.0
    return fg, flows


def _synth_field(domain, seed, H=192, W=256):
    """A synthcells frame's foreground and its converging centroid-pointing
    flows, scaled by random magnitudes in [0.3, 1) per pixel like a
    network's sub-unit outputs (zero off the cells)."""
    from imageprocess_tpu.models.synthcells import frame_arrays, synth_frame

    rng = np.random.default_rng(seed)
    img, lab = synth_frame(rng, H, W, domain)
    _, _, flows = frame_arrays(img, lab)
    flows = flows * rng.uniform(0.3, 1.0, (H, W, 1))
    return lab > 0, flows.astype(np.float32)


FIELDS = {
    "two_cells": _two_cell_scene,
    "dense": lambda: _synth_field("dense", 0),
    "fluor": lambda: _synth_field("fluor", 1),
    "texture_odd": lambda: _synth_field("texture", 2, 150, 211),
}


@pytest.fixture(scope="module", params=sorted(FIELDS))
def field(request):
    return FIELDS[request.param]()


@pytest.mark.parametrize("n_iter", [120, 8])
@pytest.mark.parametrize("name", ["dense", "fluor", "texture_odd"])
def test_follow_flows_landings(name, n_iter):
    """On converging fields.  The analytic two-cell field is left out: its
    unit vectors overshoot the centers, so trajectories there cycle
    between neighbouring pixels and an ulp decides where they stop."""
    _, flows = FIELDS[name]()
    want = np.asarray(jflows.follow_flows(jnp.asarray(flows), n_iter=n_iter))
    got = tflows.follow_flows(torch.from_numpy(flows), n_iter=n_iter).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= LAND_ATOL
    assert np.array_equal(np.round(got), np.round(want))


def test_flow_label_bit_equal(field):
    fg, flows = field
    for kw in ({}, {"sink_radius": 0, "min_landings": 1}, {"max_labels": 1}):
        want, wover = jflows.flow_label(jnp.asarray(fg), jnp.asarray(flows),
                                        with_overflow=True, **kw)
        got, over = tflows.flow_label(torch.from_numpy(fg), torch.from_numpy(flows),
                                      with_overflow=True, **kw)
        assert np.array_equal(got.numpy(), np.asarray(want)), kw
        assert bool(over) == bool(wover), kw


def test_flow_label_separates_touching_cells_and_times_phases():
    """Two overlapping discs are one CCL component but two flow instances;
    the timer sees every phase of flow_label and the CCL's rounds."""
    fg, flows = _two_cell_scene()
    timer = PhaseTimer("cpu")
    lab = tflows.flow_label(torch.from_numpy(fg), torch.from_numpy(flows),
                            timer=timer).numpy()
    assert sorted(set(lab[fg].tolist()) - {0}) == [1, 2]
    assert set(timer.times_ms()) == {
        "follow_flows", "flow_label.histogram", "flow_label.dilation",
        "flow_label.ccl", "flow_label.readback"}
    assert timer.counts["flow_label.ccl.rounds"] >= 1
