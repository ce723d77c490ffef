"""The port's view ops (``imageprocess_tpu_torch.ops.view``: DoG band-pass,
unsharp, Sobel, CLAHE, pseudocolor) against the JAX package's on the same
inputs, on the CPU, and the cases of ``tests/test_view_ops.py`` run on the
port.

Bars: ``dog_bandpass`` / ``unsharp`` within 1e-5 * max|input| (XLA's
convolution against the port's shifted sums); ``sobel_magnitude`` and
``clahe`` within 1e-6 absolute on [0, 1] input; ``apply_pseudocolor``
bit-equal; the float32 LUT table equal to matplotlib's sampling, name for
name.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from imageprocess_tpu.ops import view as jview
from imageprocess_tpu_torch.ops import view as tview
from test_view_ops import _clahe_numpy_oracle

SHAPES = [(120, 160), (220, 280)]
FILTER_BAR = 1e-5          # of max|input|: dog_bandpass, unsharp
UNIT_BAR = 1e-6            # absolute on [0, 1] input: sobel_magnitude, clahe


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU runs: with the suite's other
    workers busy, torch's full thread pool stalls them many times over their
    time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(shape, seed=0):
    """A u16-like frame: noise, a gradient and two bright blobs."""
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    img = rng.normal(400, 30, shape) + 2.0 * yy
    for cy, cx, a in ((0.4 * H, 0.3 * W, 3000), (0.7 * H, 0.7 * W, 1500)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 12.0 ** 2))
    return img.clip(0, 65535).astype(np.float32)


def _unit(shape, seed=0):
    x = _frame(shape, seed)
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(1.0, 6.0), (1.0, 3.0), (2.5, 4.0)])
def test_dog_bandpass_equals_jax(shape, lo, hi):
    x = _frame(shape)
    got = tview.dog_bandpass(_t(x), lo, hi).numpy()
    want = np.asarray(jview.dog_bandpass(jnp.asarray(x), lo, hi))
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - want).max() <= FILTER_BAR * np.abs(x).max()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma,amount", [(2.0, 0.7), (1.0, 1.5), (3.5, 0.25)])
def test_unsharp_equals_jax(shape, sigma, amount):
    x = _frame(shape, 1)
    got = tview.unsharp(_t(x), sigma, np.float32(amount)).numpy()
    want = np.asarray(jview.unsharp(jnp.asarray(x), sigma, jnp.float32(amount)))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= FILTER_BAR * np.abs(x).max()


@pytest.mark.parametrize("shape", SHAPES + [(5, 7), (1, 9)])
def test_sobel_magnitude_equals_jax(shape):
    x = _unit(shape, 2) if min(shape) > 8 else \
        np.random.default_rng(2).random(shape).astype(np.float32)
    got = tview.sobel_magnitude(_t(x)).numpy()
    want = np.asarray(jview.sobel_magnitude(jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - want).max() <= UNIT_BAR


CLAHE_CASES = [
    ((120, 160), 0.01, 8, 8, 256),       # the default grid
    ((220, 280), 0.01, 8, 8, 256),
    ((120, 160), 0.02, 4, 6, 256),       # (4, 6)
    ((220, 280), 0.03, 4, 6, 128),
    ((120, 160), 1.0, 8, 8, 256),        # no clipping
    ((100, 150), 0.01, 8, 8, 256),       # reflect pads of 4 and 2 rows / columns
    ((3, 5), 0.01, 8, 8, 256),           # a tiny crop: the pad reaches the axis -> edge
    ((9, 4), 0.05, 4, 6, 64),            # edge on one axis only
]


@pytest.mark.parametrize("shape,clip,ny,nx,nbins", CLAHE_CASES)
def test_clahe_equals_jax(shape, clip, ny, nx, nbins):
    x = _unit(shape, 3) if min(shape) > 8 else \
        np.random.default_rng(3).random(shape).astype(np.float32)
    got = tview.clahe(_t(x), np.float32(clip), ny, nx, nbins).numpy()
    want = np.asarray(jview.clahe(jnp.asarray(x), jnp.float32(clip), ny, nx, nbins))
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - want).max() <= UNIT_BAR


def test_clahe_edge_pad_is_taken_where_reflect_cannot():
    """The pad width reaches the axis length on a 3 x 5 crop (8 x 8 tiles of
    one pixel): numpy's 'edge' pad, not 'reflect'."""
    x = np.random.default_rng(4).random((3, 5)).astype(np.float32)
    i = tview._pad_index(3, 5, "edge", "cpu")
    assert i.tolist() == [0, 1, 2, 2, 2, 2, 2, 2]
    assert np.array_equal(tview._pad_index(5, 3, "reflect", "cpu").numpy(),
                          np.pad(np.arange(5), (0, 3), mode="reflect"))
    got = tview.clahe(_t(x)).numpy()
    assert np.abs(got - np.asarray(jview.clahe(jnp.asarray(x)))).max() <= UNIT_BAR


# ------------------------------------------------------------------ pseudocolor

# matplotlib is imported inside the tests: the card's machine has none
with np.load(tview.PSEUDO_LUT_TABLE) as _z:
    LUT_NAMES = sorted(_z.files)


def test_pseudo_lut_table_names_are_matplotlibs():
    import matplotlib

    assert LUT_NAMES == sorted(matplotlib.colormaps)
    for n in LUT_NAMES:
        lut = tview._pseudo_lut(n)
        assert lut.dtype == np.float32 and lut.shape == (256, 3)


@pytest.mark.parametrize("name", LUT_NAMES)
def test_pseudo_lut_equals_matplotlib(name):
    """Each committed table is the JAX package's sampling of the colormap."""
    import matplotlib.pyplot as plt

    want = plt.get_cmap(name)(np.linspace(0, 1, 256))[:, :3].astype(np.float32)
    assert np.array_equal(tview._pseudo_lut(name), want)


@pytest.mark.parametrize("name", ["gray", "viridis", "magma", "jet", "RdBu_r", "hsv"])
def test_apply_pseudocolor_bit_equal_jax(name):
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.random((40, 50)), [[-0.5, 0.0, 1.0, 1.5] * 12 + [0.999, 0.004]]])
    x = x.astype(np.float32)
    got = tview.apply_pseudocolor(x, name)
    want = jview.apply_pseudocolor(x, name)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_apply_pseudocolor_unknown_name_raises():
    with pytest.raises(ValueError, match="_cmap_luts_f32.npz"):
        tview.apply_pseudocolor(np.zeros((2, 2), np.float32), "no_such_cmap")


# ------------------------------------------- tests/test_view_ops.py on the port


def _img(seed=0, shape=(96, 128)):
    return np.random.default_rng(seed).random(shape).astype(np.float32) * 100


@pytest.mark.parametrize("sigma", [1.0, 2.5])
def test_gaussian_blur_vs_scipy(sigma):
    x = _img()
    assert np.allclose(tview.gaussian_blur(_t(x), sigma).numpy(),
                       ndi.gaussian_filter(x, sigma), atol=1e-3)


def test_dog_bandpass_vs_scipy():
    x = _img(1)
    ref = ndi.gaussian_filter(x, 1.0) - ndi.gaussian_filter(x, 3.0)
    assert np.allclose(tview.dog_bandpass(_t(x), 1.0, 3.0).numpy(), ref, atol=1e-2)


def test_sobel_magnitude_vs_scipy():
    x = _img(2)
    gx = ndi.sobel(x, axis=1, mode="reflect") / 4.0
    gy = ndi.sobel(x, axis=0, mode="reflect") / 4.0
    ref = np.hypot(gx, gy) / np.sqrt(2.0)
    assert np.allclose(tview.sobel_magnitude(_t(x)).numpy(), ref, atol=2e-3)


def test_stretch_view_matches_numpy():
    x = _img(3)
    out = tview.stretch_view(_t(x), 1000, 99000, 2.0, False).numpy()
    lo, hi = np.percentile(x, 1), np.percentile(x, 99)
    ref = np.clip((x - lo) / (hi - lo), 0, 1) ** 0.5
    assert np.allclose(out, ref, atol=1e-5)
    inv = tview.stretch_view(_t(x), 1000, 99000, 2.0, True).numpy()
    assert np.allclose(inv, 1.0 - ref, atol=1e-5)


@pytest.mark.parametrize("shape,clip", [((96, 128), 0.01), ((64, 64), 1.0),
                                        ((50, 70), 0.03)])
def test_clahe_parity_vs_numpy_oracle(shape, clip):
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    img = (0.3 * yy / shape[0] + 0.1 * rng.random(shape, np.float32)
           + 0.5 * np.exp(-((yy - 20) ** 2 + (xx - 30) ** 2) / 200.0))
    img = (img / img.max()).astype(np.float32)
    ours = tview.clahe(_t(img), np.float32(clip)).numpy()
    assert np.abs(ours - _clahe_numpy_oracle(img, clip_limit=clip)).max() <= 1e-3


def test_clahe_parity_nondefault_grid():
    img = _img(11, (60, 90)) / 100.0
    ours = tview.clahe(_t(img), np.float32(0.02), ntiles_y=4, ntiles_x=6, nbins=128).numpy()
    ref = _clahe_numpy_oracle(img, 0.02, ntiles_y=4, ntiles_x=6, nbins=128)
    assert np.abs(ours - ref).max() <= 1e-3


def test_clahe_properties():
    flat = np.full((64, 64), 0.5, np.float32)
    out = tview.clahe(_t(flat)).numpy()
    assert out.shape == (64, 64) and float(out.std()) < 0.2
    yy = np.linspace(0.45, 0.55, 64, dtype=np.float32)
    grad = np.tile(yy[:, None], (1, 64))
    out2 = tview.clahe(_t(grad), np.float32(1.0)).numpy()
    assert float(out2.std()) > float(grad.std())
    assert 0.0 <= float(out2.min()) and float(out2.max()) <= 1.0


def test_clahe_reduces_to_global_hist_eq():
    """One 1 x 1 tile grid and no clipping: global histogram equalization,
    each pixel the inclusive empirical CDF of its bin."""
    img = np.random.default_rng(3).random((64, 64)).astype(np.float32)
    ours = tview.clahe(_t(img), np.float32(1.0), ntiles_y=1, ntiles_x=1).numpy()
    bins = np.clip((img * 255).astype(np.int64), 0, 255)
    cdf = np.cumsum(np.bincount(bins.ravel(), minlength=256)) / bins.size
    assert np.abs(ours - cdf[bins].astype(np.float32)).max() <= 1e-5


# ------------------------------------------------------------------ on a card

@pytest.mark.cuda
def test_cuda_view_ops_match_cpu():
    """On a card the filters equal the CPU's within the bars above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _frame((220, 280))
    u = _unit((220, 280))
    for fn, arg, bar in ((lambda a: tview.dog_bandpass(a, 1.0, 6.0), x, FILTER_BAR * x.max()),
                         (lambda a: tview.unsharp(a, 2.0, np.float32(0.7)), x,
                          FILTER_BAR * x.max()),
                         (tview.sobel_magnitude, u, UNIT_BAR),
                         (lambda a: tview.clahe(a, np.float32(0.01)), u, UNIT_BAR)):
        card = fn(_t(arg).cuda()).cpu().numpy()
        assert np.abs(card - fn(_t(arg)).numpy()).max() <= bar
