"""Port parity: float per-ROI statistics (ops.stats, ops.percentile,
ops.ratio, ops.roi_stats_kernel, ops.roistats float paths) against the JAX
package on the CPU.

Bars, and why:
- npx, area, vmin and vmax exact: counts and selections, no arithmetic;
- quantiles within 1e-6 relative: the order statistics are the same
  values, and the interpolation lo + g * (hi - lo) is the same three f32
  operations, which the JAX CPU compiler may still contract into one
  fused multiply-add (one rounding less);
- mean, std and vsum within 1e-5 relative: the sums run in another order.
The CUDA kernel runs only on a card (the ``cuda`` tests skip here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.ops import percentile as jpct
from imageprocess_tpu.ops import ratio as jratio
from imageprocess_tpu.ops import stats as jstats
from imageprocess_tpu.ops.pallas_roistats import roi_stats_pallas
from imageprocess_tpu_torch.ops import percentile as tpct
from imageprocess_tpu_torch.ops import ratio as tratio
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.ops import roistats
from imageprocess_tpu_torch.ops import stats as tstats

EXACT = ("npx", "vmin", "vmax")
QUANT = ("median", "p5", "p95")
Q_RTOL = 1e-6
M_RTOL = 1e-5


def assert_stats(got, want, where=""):
    """*got*/*want*: STAT_FIELDS dicts of equal-shaped arrays."""
    for f in tstats.STAT_FIELDS:
        a, b = np.asarray(got[f], np.float64), np.asarray(want[f], np.float64)
        assert a.shape == b.shape, (where, f, a.shape, b.shape)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{where} {f}")
        ok = ~np.isnan(b)
        if f in EXACT:
            np.testing.assert_array_equal(a[ok], b[ok], err_msg=f"{where} {f}")
        else:
            np.testing.assert_allclose(a[ok], b[ok], atol=0,
                                       rtol=Q_RTOL if f in QUANT else M_RTOL,
                                       err_msg=f"{where} {f}")


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


# ------------------------------------------------------------ tile cases
# (frames (C, H, W) f32, masks (N, T, T) bool, offsets (N, 2) int32): the
# cases of tests/test_pallas_roistats.py plus +-inf, ties and signed zeros

def _pallas_case(seed, C=2, H=96, W=128, N=5, T=32):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 4000, (C, H, W)).astype(np.float32)
    masks = rng.random((N, T, T)) > 0.6
    offs = np.stack([rng.integers(0, H - T, N), rng.integers(0, W - T, N)],
                    1).astype(np.int32)
    masks[N - 1] = False  # empty ROI
    return imgs, masks, offs


def _nonfinite_case():
    rng = np.random.default_rng(5)
    T = 32
    imgs = rng.integers(0, 4000, (2, 64, 128)).astype(np.float32)
    masks = np.ones((3, T, T), bool)
    masks[0, 3, 4] = False
    offs = np.array([[10, 20], [17, 41], [0, 96]], np.int32)
    imgs[0, 13, 24] = np.nan    # in-tile, masked out
    imgs[0, 15, 25] = np.nan    # in-tile, mask on: dropped as non-finite
    imgs[1, 11, 22] = np.inf
    imgs[1, 20, 30] = -np.inf
    imgs[0, 5:9, 100:110] = -np.inf
    imgs[1, :, 97] = np.nan     # a whole column of the third tile
    return imgs, masks, offs


def _negative_case():
    rng = np.random.default_rng(3)
    imgs = rng.normal(-20, 50, (2, 64, 80)).astype(np.float32)
    masks = rng.random((4, 32, 32)) > 0.2
    offs = np.array([[10, 20], [3, 45], [31, 47], [0, 0]], np.int32)
    return imgs, masks, offs


def _ties_case():
    rng = np.random.default_rng(11)
    vals = np.array([-0.0, 0.0, -1.5, 2.25, 2.25, 7.0, 3e6, -1e-3],
                    np.float32)
    imgs = rng.choice(vals, size=(3, 48, 48)).astype(np.float32)
    masks = rng.random((4, 24, 24)) > 0.3
    masks[2] = False
    masks[2, 5, 5] = True       # n = 1
    offs = np.array([[1, 3], [24, 24], [7, 13], [9, 2]], np.int32)
    return imgs, masks, offs


CASES = {"random0": lambda: _pallas_case(0), "random1": lambda: _pallas_case(1),
         "nonfinite": _nonfinite_case, "negative": _negative_case,
         "ties": _ties_case}


def _frame_form(imgs, masks, offs):
    offs3 = np.concatenate([np.zeros((len(offs), 1), np.int32), offs], 1)
    return (torch.from_numpy(imgs)[None], torch.from_numpy(masks),
            torch.from_numpy(offs3))


def _jax_tile_stats(imgs, masks, offs):
    """JAX masked_stats of every (channel, ROI) tile: dict of (C, N)."""
    T = masks.shape[-1]
    C, N = imgs.shape[0], masks.shape[0]
    out = {f: np.zeros((C, N), np.float64) for f in tstats.STAT_FIELDS}
    for c in range(C):
        for i in range(N):
            y, x = offs[i]
            ref = jstats.masked_stats(jnp.asarray(imgs[c, y:y + T, x:x + T]),
                                      jnp.asarray(masks[i]))
            for f in tstats.STAT_FIELDS:
                out[f][c, i] = float(ref[f])
    return out


def test_stat_fields_match():
    assert tstats.STAT_FIELDS == jstats.STAT_FIELDS


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_rows_match_jax_masked_stats(case):
    """The kernel's plain version (frame + unaligned offsets form) against
    JAX masked_stats on each tile."""
    imgs, masks, offs = CASES[case]()
    rows = rsk.roi_stat_rows_plain(*_frame_form(imgs, masks, offs))
    assert rows.shape == (masks.shape[0], imgs.shape[0], 9)
    got = {k: v.numpy() for k, v in rsk.rows_to_stats(rows).items()}
    assert_stats(got, _jax_tile_stats(imgs, masks, offs), case)
    assert (got["npx"][:, ~masks.any(axis=(1, 2))] == 0).all()


@pytest.mark.parametrize("case", ["random0", "random1", "nonfinite", "negative"])
def test_plain_rows_match_pallas_interpret(case):
    """Against the TPU kernel itself, run in interpret mode (it takes the
    unaligned offsets there)."""
    imgs, masks, offs = CASES[case]()
    want = _np(roi_stats_pallas(jnp.asarray(imgs), jnp.asarray(masks),
                                jnp.asarray(offs), tile=masks.shape[-1],
                                interpret=True))
    rows = rsk.roi_stat_rows_plain(*_frame_form(imgs, masks, offs))
    got = {k: v.numpy() for k, v in rsk.rows_to_stats(rows).items()}
    assert_stats(got, want, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stack_form_equals_frame_form(case):
    """The FRET step's form (tiles as frames, origin 0) gives the same
    rows as slicing the full frame at the offsets."""
    imgs, masks, offs = CASES[case]()
    frames, m, offs3 = _frame_form(imgs, masks, offs)
    tiles = rsk.gather_roi_tiles(frames, offs3, masks.shape[-1]).contiguous()
    a = rsk.roi_stat_rows_plain(frames, m, offs3)
    b = rsk.roi_stat_rows_plain(tiles, m, rsk.stack_offsets(len(masks), "cpu"))
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_offsets_clamp_like_dynamic_slice():
    imgs, masks, _ = _pallas_case(2)
    H, W, T = imgs.shape[1], imgs.shape[2], masks.shape[-1]
    offs = np.array([[-5, 3], [H, W], [H - T + 7, -1], [0, W - T + 1],
                     [40, 40]], np.int32)
    clamped = np.stack([np.clip(offs[:, 0], 0, H - T),
                        np.clip(offs[:, 1], 0, W - T)], 1)
    a = rsk.roi_stat_rows_plain(*_frame_form(imgs, masks, offs))
    b = rsk.roi_stat_rows_plain(*_frame_form(imgs, masks, clamped))
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", ["random0", "ties", "nonfinite"])
def test_roi_stats_matches_jax(case):
    imgs, masks, offs = CASES[case]()
    T = masks.shape[-1]
    full = np.zeros((len(masks),) + imgs.shape[1:], bool)
    for i, (y, x) in enumerate(offs):
        full[i, y:y + T, x:x + T] = masks[i]
    want = _np(jstats.roi_stats(jnp.asarray(imgs), jnp.asarray(full)))
    got = tstats.roi_stats(torch.from_numpy(imgs), torch.from_numpy(full))
    assert_stats({k: v.numpy() for k, v in got.items()}, want, case)
    one = tstats.masked_stats(torch.from_numpy(imgs[0]), torch.from_numpy(full[1]))
    assert_stats({k: v.numpy() for k, v in one.items()},
                 _np(jstats.masked_stats(jnp.asarray(imgs[0]),
                                         jnp.asarray(full[1]))), case)


def _lattice_polys(rng, n, t):
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 12))
        pts = rng.uniform(1, t - 2, (k, 2))
        c = pts.mean(axis=0)
        pts = pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]
        out.append(np.round(pts * 2) / 2)
    return out


def _tiled_inputs(seed=4, C=2, H=90, W=120, N=5, T=32):
    from imageprocess_tpu.geom.polygon import pad_polygons

    rng = np.random.default_rng(seed)
    imgs = rng.normal(100, 40, (C, H, W)).astype(np.float32)
    imgs[0, 30:34, 50:53] = np.nan
    lp = pad_polygons(_lattice_polys(rng, N, T), 16).astype(np.float32)
    lp[1] = 7.0                             # degenerate: an empty ROI
    offs = np.stack([rng.integers(0, H - T, N), rng.integers(0, W - T, N)],
                    1).astype(np.int32)     # unaligned
    valid = np.ones(N, bool)
    valid[-1] = False                       # a padded lane
    return imgs, lp, offs, valid, T


def test_roi_stats_tiled_matches_jax():
    from imageprocess_tpu.ops.roistats import roi_stats_tiled as j_tiled

    imgs, lp, offs, valid, T = _tiled_inputs()
    ws, wa = j_tiled(jnp.asarray(imgs), jnp.asarray(lp), jnp.asarray(offs),
                     jnp.asarray(valid), T)
    gs, ga = roistats.roi_stats_tiled(torch.from_numpy(imgs), torch.from_numpy(lp),
                                      torch.from_numpy(offs),
                                      torch.from_numpy(valid), T)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert_stats({k: v.numpy() for k, v in gs.items()}, _np(ws))
    assert ga[1] == 0 and ga[-1] == 0 and (ga[[0, 2, 3]] > 0).all()


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_tile_stats_from_gathered_float_branch_matches_jax(clip, dtype):
    from imageprocess_tpu.ops.roistats import tile_stats_from_gathered as j_tsg

    imgs, lp, offs, valid, T = _tiled_inputs(seed=6)
    if dtype == np.uint8:
        imgs = np.nan_to_num(imgs).clip(0, 255).astype(np.uint8)
    tiles = np.stack([imgs[:, y:y + T, x:x + T] for y, x in offs])
    bgs = np.array([90.5, 17.25], np.float32)
    ws, wa = j_tsg(jnp.asarray(tiles), jnp.asarray(lp), jnp.asarray(valid),
                   jnp.asarray(bgs), clip_neg=clip)
    gs, ga = roistats.tile_stats_from_gathered(
        torch.from_numpy(tiles), torch.from_numpy(lp), torch.from_numpy(valid),
        torch.from_numpy(bgs), clip_neg=clip)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert_stats({k: v.numpy() for k, v in gs.items()}, _np(ws))


# ------------------------------------------------------------ percentile

@pytest.mark.parametrize("p1000", [0, 1000, 5000, 50000, 95000, 99900, 100000])
def test_quantile_from_sorted_and_masked_quantile_match_jax(p1000):
    rng = np.random.default_rng(p1000)
    x = rng.normal(0, 30, 257).astype(np.float32)
    x[::7] = x[3]                                # ties
    for n in (0, 1, 2, 10, 256, 257):
        xs = np.sort(np.where(np.arange(257) < n, x, np.inf)).astype(np.float32)
        want = float(jpct.quantile_from_sorted(jnp.asarray(xs), jnp.int32(n), p1000))
        got = float(tpct.quantile_from_sorted(torch.from_numpy(xs), n, p1000))
        if n == 0:
            assert np.isnan(got) and np.isnan(want)
        else:
            assert abs(got - want) <= Q_RTOL * abs(want), (n, got, want)
    mask = rng.random((13, 20)) > 0.4
    img = rng.normal(5, 3, (13, 20)).astype(np.float32)
    want = float(jpct.masked_quantile(jnp.asarray(img), jnp.asarray(mask), p1000))
    got = float(tpct.masked_quantile(torch.from_numpy(img), torch.from_numpy(mask),
                                     p1000))
    assert abs(got - want) <= Q_RTOL * abs(want)
    # batched along the last axis, as masked_stats_batched uses it
    xs2 = np.sort(rng.normal(0, 1, (4, 9)).astype(np.float32), axis=-1)
    ns = np.array([0, 1, 5, 9], np.int32)
    got2 = tpct.quantile_from_sorted(torch.from_numpy(xs2), torch.from_numpy(ns),
                                     p1000).numpy()
    for i, n in enumerate(ns):
        w = float(jpct.quantile_from_sorted(jnp.asarray(xs2[i]), jnp.int32(n), p1000))
        assert (np.isnan(w) and np.isnan(got2[i])) or abs(got2[i] - w) <= Q_RTOL * abs(w)


# ------------------------------------------------------------ ratio ops

def test_ratio_ops_match_jax():
    rng = np.random.default_rng(8)
    d = rng.uniform(-20, 400, (40, 50)).astype(np.float32)
    a = rng.uniform(0, 500, (40, 50)).astype(np.float32)
    d[3, 4], d[5, 6] = np.nan, np.inf
    scope = rng.random((40, 50)) > 0.5
    T = torch.from_numpy
    for sc in (None, scope, np.zeros_like(scope)):
        for p in (1000, 5000):
            w = float(jratio.pick_epsilon(jnp.asarray(d), None if sc is None
                                          else jnp.asarray(sc), 5.0, p))
            g = float(tratio.pick_epsilon(T(d), None if sc is None else T(sc), 5.0, p))
            assert abs(g - w) <= Q_RTOL * abs(w), (p, g, w)
    np.testing.assert_array_equal(
        tratio.ratio_with_eps(T(a), T(d), 7.5).numpy(),
        np.asarray(jratio.ratio_with_eps(jnp.asarray(a), jnp.asarray(d), 7.5)))
    raw = rng.integers(0, 4096, (30, 30)).astype(np.uint16)
    for img in (raw, a):
        got = tratio.saturation_to_nan(T(img), 400.0).numpy()
        want = np.asarray(jratio.saturation_to_nan(jnp.asarray(img), 400.0))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tratio.clip_ratio_to_nan(T(a / 100), 3.0).numpy(),
        np.asarray(jratio.clip_ratio_to_nan(jnp.asarray(a / 100), 3.0)))
    for ao in (None, d):
        got = tratio.spectral_correct(T(a), T(d), None if ao is None else T(ao),
                                      0.3, 0.1, 1.2).numpy()
        want = np.asarray(jratio.spectral_correct(
            jnp.asarray(a), jnp.asarray(d), None if ao is None else jnp.asarray(ao),
            0.3, 0.1, 1.2))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, equal_nan=True)


# ------------------------------------------------------------ wrapper

def test_kernel_wrapper_refuses_cpu_tensors_and_bad_inputs():
    """On CPU tensors the kernel entry raises (it never runs the plain
    version quietly); malformed inputs raise before any launch."""
    imgs, masks, offs = _pallas_case(0)
    frames, m, offs3 = _frame_form(imgs, masks, offs)
    before = dict(rsk.launches)
    with pytest.raises(ValueError, match="CUDA"):
        rsk.roi_stat_rows(frames, m, offs3)
    with pytest.raises(ValueError, match="CUDA"):
        rsk.fret_tile_stats_packed(*(torch.zeros(s) for s in
                                     ((1, 1, 2, 8, 8), (1, 1, 3, 2), (1, 1), (1, 2), (1,))))
    with pytest.raises(ValueError, match="int32"):
        rsk.roi_stat_rows_plain(frames, m, offs3.to(torch.int64))
    with pytest.raises(ValueError, match="does not fit"):
        rsk.roi_stat_rows_plain(frames[..., :16], m, offs3)
    assert rsk.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_smem", [None, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda_device, case, use_smem):
    """On a card: the hand kernel against its plain version on the same
    device tensors — npx, vmin, vmax and quantiles equal by value, moments
    within 1e-5 relative."""
    imgs, masks, offs = CASES[case]()
    frames, m, offs3 = (x.to(cuda_device) for x in _frame_form(imgs, masks, offs))
    before = rsk.launches["roistats_f32"]
    got = rsk.roi_stat_rows(frames, m, offs3, use_smem=use_smem).cpu()
    assert rsk.launches["roistats_f32"] == before + 1
    want = rsk.roi_stat_rows_plain(frames, m, offs3).cpu()
    exact = [1, 3, 4, 5, 6, 8]
    torch.testing.assert_close(got[..., exact], want[..., exact], rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(got, want, rtol=M_RTOL, atol=0, equal_nan=True)


VARIANTS = {"staged": {}, "keys-staged": {"stage_mask": False},
            "device-memory": {"use_smem": False}}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cuda_kernel_radix_edge_cases(cuda_device, variant):
    """On a card: the radix-select edge cases chip_smoke.py checks -- every
    value equal, every key in one top-byte bin, keys from -inf to +inf with
    subnormals and signed zeros, n = 0, 1 and 2, ranks on either side of a
    top-, second- and low-byte edge, C = 1 and 3, T = 36, 37, 64 and 128,
    staged and row-wise frame forms -- give the plain version's rows, in
    every kernel variant (keys and mask in shared memory, the keys alone,
    device memory)."""
    import chip_smoke

    for name, frames, masks, offs, moments in chip_smoke.radix_cases_f32():
        fr, mk, of = (torch.from_numpy(a).to(cuda_device) for a in (frames, masks, offs))
        got = rsk.roi_stat_rows(fr, mk, of, **VARIANTS[variant])
        want = rsk.roi_stat_rows_plain(fr, mk, of)
        chip_smoke.compare_packed(got.movedim(-1, 1), want.movedim(-1, 1), name,
                                  chip_smoke.ROW_EXACT, moments)


def _stack_case(R, T, seed):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.normal(100, 40, (R, 3, T, T)).astype(np.float32))
    yy, xx = np.mgrid[0:T, 0:T]
    masks = np.stack([(xx - T / 2) ** 2 + (yy - T / 2) ** 2 <= (T / 2 - 1 - r) ** 2
                      for r in range(R)])
    return frames, torch.from_numpy(masks), rsk.stack_offsets(R, "cpu")


@pytest.mark.cuda
def test_cuda_large_tile_keeps_keys_in_shared_memory(cuda_device):
    """On a card: a T = 224 tile's keys fit the opt-in shared memory but not
    its mask as well, so the default launch stages the keys alone; its rows
    equal the plain version's.  At T = 144 the mask would fit too, but
    would leave one CTA per SM instead of two, so the keys go alone there
    as well; at T = 128 both fit at two CTAs per SM."""
    assert rsk.smem_fits(224, cuda_device) == (True, False)
    assert rsk.kernel_variant(224, cuda_device) == (True, False)
    assert rsk.smem_fits(144, cuda_device) == (True, True)
    assert rsk.kernel_variant(144, cuda_device) == (True, False)
    assert rsk.kernel_variant(128, cuda_device) == (True, True)
    fr, mk, of = (x.to(cuda_device) for x in _stack_case(4, 224, 3))
    got = rsk.roi_stat_rows(fr, mk, of)
    want = rsk.roi_stat_rows_plain(fr, mk, of)
    torch.testing.assert_close(got[..., [1, 3, 4, 5, 6, 8]], want[..., [1, 3, 4, 5, 6, 8]],
                               rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, want, rtol=M_RTOL, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_occupancy_query_leaves_large_launches_working(cuda_device):
    """On a card: an occupancy query at a small tile between two launches at
    a large one does not lower the shared memory the large launch needs."""
    fr, mk, of = (x.to(cuda_device) for x in _stack_case(3, 200, 4))
    want = rsk.roi_stat_rows_plain(fr, mk, of)
    first = rsk.roi_stat_rows(fr, mk, of)
    assert rsk.occupancy(32, cuda_device) >= 1
    again = rsk.roi_stat_rows(fr, mk, of)
    torch.cuda.synchronize()
    torch.testing.assert_close(first, again, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(again, want, rtol=M_RTOL, atol=0, equal_nan=True)
