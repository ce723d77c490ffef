"""Port parity of the full-frame background code: ``ops.percentile.
strided_submask``, ``ops.tilestats_u16.bisect_masked_quantile`` and
``ops.background`` against the JAX package on the CPU, same numpy-seeded
inputs.

Bars: every result here is an order statistic, a count, a bin midpoint or
an interpolation of exact order statistics by the same float32 operations,
so everything is bit-equal (NaN where NaN).  The JAX functions run eagerly
here, as the JAX package's own tests call them; inside a jitted program
XLA's CPU compiler divides the interpolation weight's remainder by 100000
as a multiply by the reciprocal, which ``tests/test_torch_serial.py``
allows for."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.ops import background as jbg
from imageprocess_tpu.ops import percentile as jpct
from imageprocess_tpu.ops import tilestats_u16 as jts
from imageprocess_tpu_torch.ops import background as tbg
from imageprocess_tpu_torch.ops import percentile as tpct
from imageprocess_tpu_torch.ops import tilestats_u16 as tts

P1000S = (0, 1000, 5000, 37500, 50000, 95000, 100000)


def _eq(got, want):
    """Bit-equal as float32, NaN where NaN."""
    g = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g, w, equal_nan=True), (g, w)


def _frame(kind, rng, shape=(37, 53)):
    """A test frame: u8, u16 (with ties), or float32 with NaN and +-inf."""
    if kind == "u8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "u16":
        return rng.choice(np.array([0, 3, 3, 90, 4000, 4001, 65535]), shape) \
            .astype(np.uint16) if rng.random() < 0.5 else \
            rng.integers(0, 65536, shape).astype(np.uint16)
    x = rng.normal(100.0, 40.0, shape).astype(np.float32)
    bad = rng.random(shape)
    x[bad < 0.05] = np.nan
    x[(bad >= 0.05) & (bad < 0.07)] = np.inf
    x[(bad >= 0.07) & (bad < 0.08)] = -np.inf
    return x


@pytest.mark.parametrize("stride", [1, 3, 4])
def test_strided_submask_matches_jax(stride):
    rng = np.random.default_rng(stride)
    for density in (0.0, 0.05, 0.5, 1.0):
        m = rng.random((29, 41)) < density
        got = tpct.strided_submask(torch.from_numpy(m), stride)
        want = np.asarray(jpct.strided_submask(jnp.asarray(m), stride))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want), density


@pytest.mark.parametrize("p1000", P1000S)
def test_bisect_masked_quantile_matches_jax(p1000):
    """Lanes of random and tie-heavy u16 values, n = 1 ... P."""
    rng = np.random.default_rng(p1000 + 1)
    xi = np.concatenate([rng.integers(0, 65536, (3, 500)),
                         rng.choice([0, 7, 7, 7, 300, 65535], (3, 500))])
    mask = rng.random(xi.shape) < np.array([1.0, 0.5, 0.01, 1.0, 0.3, 0.02])[:, None]
    mask[2, :] = False
    mask[2, 17] = True                                         # n = 1
    n = mask.sum(-1).astype(np.int32)
    got = tts.bisect_masked_quantile(torch.from_numpy(xi.astype(np.int32)),
                                     torch.from_numpy(mask), torch.from_numpy(n),
                                     p1000)
    want = jts.bisect_masked_quantile(jnp.asarray(xi, jnp.int32),
                                      jnp.asarray(mask), jnp.asarray(n), p1000)
    _eq(got, want)


def _edge_values(rng, dtype):
    """102 values whose ranks 5|6, 50|51 and 95|96 fall on either side of
    a value change (the last copy of one value, the first of the next):
    both sides of ``searchsorted(side="right")``."""
    v = np.full(102, 200, dtype)
    v[:6], v[6:50], v[50], v[51:95], v[95], v[96:] = 3, 4, 9, 10, 60, 61
    return rng.permutation(v)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("p1000", [1000, 5000, 50000, 95000])
def test_integral_masked_quantile_matches_jax(dtype, p1000):
    rng = np.random.default_rng(7)
    cases = []
    img = rng.integers(0, np.iinfo(dtype).max + 1, (40, 48)).astype(dtype)
    cases.append((img, rng.random(img.shape) < 0.4))
    cases.append((img, np.zeros(img.shape, bool)))              # empty -> NaN
    edge = np.zeros((40, 48), dtype)
    m = np.zeros(edge.shape, bool)
    idx = rng.choice(edge.size, 102, replace=False)
    edge.ravel()[idx] = _edge_values(rng, dtype)
    m.ravel()[idx] = True
    cases.append((edge, m))
    for img, mask in cases:
        got = tbg.integral_masked_quantile(torch.from_numpy(img),
                                           torch.from_numpy(mask), p1000)
        want = jbg.integral_masked_quantile(jnp.asarray(img), jnp.asarray(mask),
                                            p1000)
        _eq(got, want)


@pytest.mark.parametrize("case", ["random", "nan_inf", "on_bin_edges",
                                  "constant", "all_nan", "empty"])
@pytest.mark.parametrize("p1000", [1000, 50000, 100000])
def test_histogram_mode_value_matches_jax(case, p1000):
    """NaN and +-inf pixels inside and outside the scope, values exactly on
    bin edges, a constant scope (span 0), no finite value, no pixel."""
    rng = np.random.default_rng(11)
    x = rng.normal(50.0, 20.0, (33, 47)).astype(np.float32)
    mask = rng.random(x.shape) < 0.6
    if case == "nan_inf":
        bad = rng.random(x.shape)
        x[bad < 0.1] = np.nan
        x[(bad >= 0.1) & (bad < 0.12)] = np.inf
    elif case == "on_bin_edges":
        # lo = 0, hi = 2048: every integer is a bin edge
        x = rng.integers(0, 2049, x.shape).astype(np.float32)
        x.ravel()[:2] = (0.0, 2048.0)
        mask.ravel()[:2] = True
    elif case == "constant":
        x[:] = 7.25
    elif case == "all_nan":
        x[mask] = np.nan
    elif case == "empty":
        mask[:] = False
    got = tbg.histogram_mode_value(torch.from_numpy(x), torch.from_numpy(mask),
                                   p1000)
    want = jbg.histogram_mode_value(jnp.asarray(x), jnp.asarray(mask), p1000)
    _eq(got, want)


@pytest.mark.parametrize("stride", [1, 3, 4])
@pytest.mark.parametrize("kind", ["u8", "u16", "f32"])
@pytest.mark.parametrize("scope", ["full", "roi_union"])
@pytest.mark.parametrize("mode", ["percentile", "hist-mode", "none"])
def test_bg_value_matches_jax(mode, scope, kind, stride):
    """Every branch of bg_value: the full frame sliced up front (bisection
    for u8/u16, a sort for float frames, hist-mode), a scoped strided
    submask (the integral histogram, a masked sort, hist-mode)."""
    rng = np.random.default_rng(stride * 7 + len(kind))
    img = _frame(kind, rng)
    scope_mask = rng.random(img.shape) < 0.35 if scope == "roi_union" else None
    for p1000 in (1000, 50000, 99500):
        got = tbg.bg_value(torch.from_numpy(img), p1000,
                           None if scope_mask is None else torch.from_numpy(scope_mask),
                           mode, stride)
        want = jbg.bg_value(jnp.asarray(img), p1000,
                            None if scope_mask is None else jnp.asarray(scope_mask),
                            mode, stride)
        assert got.dtype == torch.float32 and got.shape == ()
        _eq(got, want)


@pytest.mark.parametrize("mode", ["percentile", "hist-mode"])
@pytest.mark.parametrize("kind", ["u16", "f32"])
def test_bg_value_empty_scope_is_zero(mode, kind):
    rng = np.random.default_rng(3)
    img = _frame(kind, rng)
    empty = np.zeros(img.shape, bool)
    got = tbg.bg_value(torch.from_numpy(img), 1000, torch.from_numpy(empty), mode)
    want = jbg.bg_value(jnp.asarray(img), 1000, jnp.asarray(empty), mode)
    _eq(got, want)
    assert float(got) == 0.0


@pytest.mark.parametrize("clip_neg", [True, False])
@pytest.mark.parametrize("kind", ["u16", "f32"])
def test_bg_correct_matches_jax(clip_neg, kind):
    rng = np.random.default_rng(5)
    img = _frame(kind, rng)
    scope_mask = rng.random(img.shape) < 0.5
    for sm in (None, scope_mask):
        out, b = tbg.bg_correct(torch.from_numpy(img), 20000,
                                None if sm is None else torch.from_numpy(sm),
                                clip_neg=clip_neg)
        jout, jb = jbg.bg_correct(jnp.asarray(img), 20000,
                                  None if sm is None else jnp.asarray(sm),
                                  clip_neg=clip_neg)
        assert out.dtype == torch.float32
        _eq(b, jb)
        _eq(out, jout)


@pytest.mark.parametrize("kind", ["u16", "f32"])
@pytest.mark.parametrize("shape", [(50, 64), (64, 41)])
def test_roi_stats_full_matches_jax(kind, shape):
    """Whole-frame statistics (zero-padded to one S x S tile on the way to
    the kernel's form) against the JAX package's roi_stats, with NaN
    pixels in float frames, an empty mask and a full one: npx, area,
    vmin, vmax and the quantiles bit-equal (the same operations on the same
    values, run eagerly), mean, std and vsum within 1e-5 relative."""
    from imageprocess_tpu.ops.stats import roi_stats
    from imageprocess_tpu_torch.ops import roistats as trs

    rng = np.random.default_rng(shape[1])
    H, W = shape
    imgs = (rng.integers(0, 4000, (3, H, W)).astype(np.float32) if kind == "u16"
            else rng.normal(0, 50, (3, H, W)).astype(np.float32))
    if kind == "f32":
        imgs[rng.random(imgs.shape) < 0.05] = np.nan
    masks = rng.random((4, H, W)) < 0.3
    masks[1] = False
    masks[2] = True
    ts, ta = trs.roi_stats_full(torch.from_numpy(imgs), torch.from_numpy(masks))
    js = roi_stats(jnp.asarray(imgs), jnp.asarray(masks))
    assert np.array_equal(ta.numpy(), masks.sum((1, 2)))
    for f in js:
        g, w = ts[f].numpy().astype(np.float64), np.asarray(js[f], np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), f
        ok = ~np.isnan(w)
        if f in ("mean", "std", "vsum"):
            assert np.all(np.abs(g - w)[ok] <= 1e-5 * np.abs(w[ok])), f
        else:
            assert np.array_equal(g[ok], w[ok]), f
