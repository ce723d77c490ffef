"""Port parity: binary morphology and connected-component labeling
(``imageprocess_tpu_torch.morphology``) against the JAX functions on the
CPU, on the same numpy masks.

Bar: bit-equal everywhere.  Masks and labels are integer results (counts
of small integers, min-label propagation to a unique fixpoint, rank by
cumsum), so no tolerance applies."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from imageprocess_tpu.morphology import binary as jbin
from imageprocess_tpu.morphology import ccl as jccl
from imageprocess_tpu_torch.morphology import binary as tbin
from imageprocess_tpu_torch.morphology import ccl as tccl
from imageprocess_tpu_torch.timing import PhaseTimer


# most masks share one shape, so each JAX function compiles once for them
SHAPE = (48, 64)


def _random_blobs(shape=SHAPE, p=0.35, seed=0, smooth=1.0):
    rng = np.random.default_rng(seed)
    img = ndi.gaussian_filter(rng.random(shape), smooth)
    return img > np.quantile(img, 1 - p)


def _snake(H=SHAPE[0], W=SHAPE[1]):
    fg = np.zeros((H, W), bool)
    fg[0, :] = True
    for i in range(1, H - 1, 2):
        fg[i, -1 if (i // 2) % 2 == 0 else 0] = True
        fg[i + 1, :] = True
    return fg


def _spiral(H=SHAPE[0], W=SHAPE[1]):
    """One pixel wide rectangular spiral: one long, maximally winding
    component."""
    fg = np.zeros((H, W), bool)
    y0, x0, y1, x1 = 0, 0, H - 1, W - 1
    while y0 <= y1 and x0 <= x1:
        fg[y0, x0:x1 + 1] = True
        fg[y0:y1 + 1, x1] = True
        fg[y1, x0:x1 + 1] = True
        fg[y0 + 2:y1 + 1, x0] = True
        if y0 + 2 <= y1:
            fg[y0 + 2, x0:x0 + 2] = True
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    return fg


def _masks():
    rng = np.random.default_rng(3)
    single = np.zeros(SHAPE, bool)
    single[rng.integers(0, 48, 60), rng.integers(0, 64, 60)] = True
    comb = np.zeros(SHAPE, bool)
    comb[0, :] = True
    comb[:, ::3] = True
    return {
        "blobs0": _random_blobs(seed=0),
        "blobs1_sparse": _random_blobs(seed=1, p=0.3, smooth=0.0),
        "blobs2_dense": _random_blobs(seed=2, p=0.6, smooth=2.0),
        "noise": rng.random(SHAPE) > 0.5,
        "noise_odd_shape": rng.random((37, 53)) > 0.5,
        "one_pixel": single,
        "checker": np.indices(SHAPE).sum(axis=0) % 2 == 0,
        "snake": _snake(),
        "spiral": _spiral(),
        "comb": comb,
        "empty": np.zeros(SHAPE, bool),
        "full": np.ones(SHAPE, bool),
        "one_row": rng.random((1, 40)) > 0.4,
    }


MASKS = _masks()
NAMES = sorted(MASKS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape
    assert np.array_equal(p.astype(np.int64), r.astype(np.int64))


def test_disk_equal():
    for r in range(0, 7):
        assert np.array_equal(tbin.disk(r), jbin.disk(r))


SES = {
    "disk1": jbin.disk(1), "disk2": jbin.disk(2), "disk3": jbin.disk(3),
    "disk5": jbin.disk(5),
    "asym": np.array([[0, 1, 1], [1, 1, 0], [0, 0, 0]], bool),
    "even4x2": np.array([[1, 0], [1, 1], [0, 1], [1, 0]], bool),
    "ring": jbin.disk(3) & ~np.pad(jbin.disk(1), 2),
}


@pytest.mark.parametrize("se_name", sorted(SES))
@pytest.mark.parametrize("name", ["blobs0", "noise", "noise_odd_shape",
                                  "one_pixel", "empty", "full", "one_row"])
def test_dilation_erosion_closing_bit_equal(name, se_name):
    fg, se = MASKS[name], SES[se_name]
    _eq(tbin.binary_dilation(_t(fg), se), jbin.binary_dilation(jnp.asarray(fg), se))
    for border in (True, False):
        _eq(tbin.binary_erosion(_t(fg), se, border_true=border),
            jbin.binary_erosion(jnp.asarray(fg), se, border_true=border))
    _eq(tbin.binary_closing_skimage(_t(fg), se),
        jbin.binary_closing_skimage(jnp.asarray(fg), se))


@pytest.mark.parametrize("k", [0, 1, 3, 5])
@pytest.mark.parametrize("name", ["blobs1_sparse", "one_pixel", "empty", "full"])
def test_square_dilation_bit_equal(name, k):
    fg = MASKS[name]
    _eq(tbin.square_dilation(_t(fg), k), jbin.square_dilation(jnp.asarray(fg), k))


@pytest.mark.parametrize("k", [0, 2, 8])
def test_square_dilation_takes_leading_dimensions(k):
    """A stack of per-ROI tile masks (N, T, T), and a (2, N, T, T) batch of
    them: each mask dilated on its own, as JAX's under ``vmap``."""
    import jax

    rng = np.random.default_rng(5)
    stack = rng.random((5, 40, 40)) > 0.97
    stack[3] = False
    want = np.asarray(jax.vmap(lambda m: jbin.square_dilation(m, k))(jnp.asarray(stack)))
    got = tbin.square_dilation(_t(stack), k)
    assert got.dtype == torch.bool
    _eq(got, want)
    _eq(tbin.square_dilation(_t(np.stack([stack, stack[::-1]])), k),
        np.stack([want, want[::-1]]))
    for i in range(len(stack)):
        _eq(tbin.square_dilation(_t(stack[i]), k), want[i])
        assert np.array_equal(want[i], ndi.binary_dilation(
            stack[i], np.ones((2 * k + 1, 2 * k + 1), bool)) if k else stack[i])


def _edt_masks():
    rng = np.random.default_rng(9)
    blobs = ndi.binary_opening(rng.random((60, 83)) > 0.35)
    blobs[:12, :20] = True          # touches two borders
    blobs[-5:, :] = True            # a full-width band on the bottom border
    two = np.zeros((60, 83), bool)
    two[10:40, 10:40] = True
    two[10:40, 40:70] = True        # two touching squares: one union
    return {"blobs": blobs, "touching": two, "empty": np.zeros((9, 7), bool),
            "full": np.ones((9, 7), bool), "one_row": np.ones((1, 30), bool)}


@pytest.mark.parametrize("r", [1, 4, 10])
@pytest.mark.parametrize("name", sorted(_edt_masks()))
def test_clamped_edt_and_rim_bit_equal(name, r):
    """The radius-clamped squared EDT and the rim mask: bit-equal to the
    JAX functions, and inside r equal to scipy's EDT squared."""
    from imageprocess_tpu.morphology import edt as jedt
    from imageprocess_tpu_torch.morphology import edt as tedt

    fg = _edt_masks()[name]
    got = tedt.clamped_sq_edt(_t(fg), r)
    want = np.asarray(jedt.clamped_sq_edt(jnp.asarray(fg), r))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    d2 = ndi.distance_transform_edt(fg) ** 2 if fg.any() and not fg.all() else None
    if d2 is not None:
        inside = d2 <= r * r + 1e-9
        assert np.array_equal(np.round(d2[inside]), got.numpy()[inside])
        assert (got.numpy()[~inside] > r * r).all()
    rim = tedt.rim_mask(_t(fg), r)
    assert rim.dtype == torch.bool
    _eq(rim, jedt.rim_mask(jnp.asarray(fg), r))
    if d2 is not None:
        dist = ndi.distance_transform_edt(fg)
        assert np.array_equal(rim.numpy(), (dist > 0) & (dist <= r))
    _eq(tedt.rim_mask(_t(fg), 0), fg)


@pytest.mark.parametrize("inner,outer", [(2, 5), (0, 3), (4, 2)])
def test_annulus_mask_bit_equal(inner, outer):
    fg = MASKS["blobs1_sparse"]
    _eq(tbin.annulus_mask(_t(fg), inner, outer),
        jbin.annulus_mask(jnp.asarray(fg), inner, outer))


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_label_and_roots_bit_equal(name, connectivity):
    fg = MASKS[name]
    _eq(tccl.label_roots(_t(fg), connectivity),
        jccl.label_roots(jnp.asarray(fg), connectivity))
    lab, over = tccl.label(_t(fg), connectivity, max_labels=8,
                           with_overflow=True)
    jlab, jover = jccl.label(jnp.asarray(fg), connectivity, max_labels=8,
                             with_overflow=True)
    _eq(lab, jlab)
    assert lab.dtype == torch.int32
    assert bool(over) == bool(jover)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_remove_small_objects_and_largest_component_bit_equal(name, connectivity):
    fg = MASKS[name]
    for min_size in (1, 5, 40):
        _eq(tccl.remove_small_objects(_t(fg), min_size, connectivity),
            jccl.remove_small_objects(jnp.asarray(fg), min_size, connectivity))
    mask, size = tccl.largest_component(_t(fg), connectivity)
    jmask, jsize = jccl.largest_component(jnp.asarray(fg), connectivity)
    _eq(mask, jmask)
    assert int(size) == int(jsize)


@pytest.mark.parametrize("name", NAMES)
def test_fill_holes_bit_equal(name):
    fg = MASKS[name]
    _eq(tccl.fill_holes(_t(fg)), jccl.fill_holes(jnp.asarray(fg)))


def test_label_overflow_flag_and_rounds():
    fg = np.zeros((16, 33), bool)
    fg[::2, ::2] = True                  # 136 isolated 4-conn components
    timer = PhaseTimer("cpu")
    with timer.phase("ccl"):
        lab, over = tccl.label(_t(fg), 1, max_labels=135, with_overflow=True,
                               timer=timer)
    assert bool(over) and int(lab.max()) == 136
    # isolated pixels: one round changes nothing, so the loop stops at once
    assert timer.counts == {"ccl.rounds": 1}
    _, over = tccl.label(_t(fg), 1, max_labels=136, with_overflow=True)
    assert not bool(over)
    # the spiral needs several propagation rounds, and converges
    timer = PhaseTimer("cpu")
    tccl.label(_t(MASKS["spiral"]), 1, timer=timer)
    assert 2 <= timer.counts["rounds"] <= 12
