"""Port parity: u16 tile statistics (ops.tilestats_u16, ops.roistats,
ops.tile_stats_kernel) against the JAX package on the CPU.

The port's six order statistics must be bit-equal to the TPU kernel
(``batched_order_stats_pallas`` in interpret mode) and to the JAX XLA
bisection; npx, area, vmin and vmax bit-equal; mean, std, vsum and the
quantiles within rtol 1e-5 (sums are taken in another order); NaN where
n = 0.  The CUDA kernel itself runs only on a card (the ``cuda`` test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.geom.polygon import pad_polygons
from imageprocess_tpu.ops import tilestats_u16 as jts
from imageprocess_tpu.ops.pallas_tilestats import batched_order_stats_pallas
from imageprocess_tpu.ops.percentile import exact_quantile_pos as j_qpos
from imageprocess_tpu.ops.stats import STAT_FIELDS as J_FIELDS
from imageprocess_tpu.parallel.runner import batched_tile_stats_step as j_step
from imageprocess_tpu_torch.ops import roistats, tile_stats_kernel as tsk
from imageprocess_tpu_torch.ops import tilestats_u16 as pts
from imageprocess_tpu_torch.ops.stats import STAT_FIELDS

RTOL = 1e-5
EXACT = ("npx", "vmin", "vmax")


def _random_case(seed=7, N=6, C=2, t=64):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 65536, (N, C, t, t)).astype(np.uint16)
    masks = rng.random((N, t, t)) > 0.4
    masks[4] = False         # empty ROI
    masks[5] = False
    masks[5, 0, :3] = True   # nearly-empty ROI (n=3)
    bgs = np.array([120.5, 37.25], np.float32)[:C]
    return tiles, masks, bgs


def _tie_case(seed=11, N=6, C=2, t=48):
    rng = np.random.default_rng(seed)
    vals = np.array([0, 36, 37, 38, 120, 121, 4095], np.uint16)
    tiles = rng.choice(vals, size=(N, C, t, t)).astype(np.uint16)
    masks = rng.random((N, t, t)) > 0.3
    masks[2] = False
    bgs = np.array([37.0, 120.5], np.float32)  # ties AT the background
    return tiles, masks, bgs


CASES = {"random": _random_case, "tie-heavy": _tie_case}


def _assert_stats(got, want, where=""):
    for f in STAT_FIELDS:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if f in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {f}")
        else:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            ok = ~np.isnan(b)
            np.testing.assert_allclose(a[ok], b[ok], rtol=RTOL,
                                       err_msg=f"{where} {f}")


def _ks(n_nc):
    """The six clipped order-statistic positions, computed by the JAX
    function (so the port's bisection is tested on the JAX's inputs)."""
    kgs = [j_qpos(jnp.asarray(n_nc), p) for p in (5000, 50000, 95000)]
    nm1 = np.maximum(n_nc - 1, 0)
    ks = [np.clip(np.asarray(k), 0, nm1) for k, _ in kgs] + [
        np.clip(np.minimum(np.asarray(k) + 1, nm1), 0, nm1) for k, _ in kgs]
    return np.stack(ks, -1).astype(np.int32)


def test_stat_fields_match():
    assert STAT_FIELDS == J_FIELDS


@pytest.mark.parametrize("case", sorted(CASES))
def test_order_stats_bit_equal_pallas_and_xla(case):
    tiles, masks, _ = CASES[case]()
    N, C, t, _ = tiles.shape
    pallas = np.asarray(batched_order_stats_pallas(
        jnp.asarray(tiles)[None], jnp.asarray(masks)[None], interpret=True))[0]
    n_nc = np.broadcast_to(masks.sum(axis=(1, 2))[:, None], (N, C)).astype(np.int32)
    ks = _ks(n_nc)
    xi = tiles.astype(np.int32).reshape(N, C, t * t)
    mflat = np.broadcast_to(masks[:, None], (N, C, t, t)).reshape(N, C, -1)
    xla = np.asarray(jts._order_stats_bisect(jnp.asarray(xi), jnp.asarray(mflat),
                                             jnp.asarray(ks)))
    port = pts._order_stats_bisect(torch.from_numpy(xi),
                                   torch.from_numpy(np.ascontiguousarray(mflat)),
                                   torch.from_numpy(ks)).numpy()
    valid = n_nc > 0  # undefined where n == 0 (the caller guards)
    np.testing.assert_array_equal(port[valid], xla[valid])
    np.testing.assert_array_equal(port[valid], pallas[valid])
    # and they are the true k-th smallest values
    for i in range(N):
        vals = np.sort(tiles[i, 0][masks[i]].astype(np.int64))
        if vals.size:
            np.testing.assert_array_equal(port[i, 0], vals[ks[i, 0]])


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_stats_u16_matches_jax(case, clip):
    tiles, masks, bgs = CASES[case]()
    want = jts.tile_stats_u16(jnp.asarray(tiles), jnp.asarray(masks),
                              jnp.asarray(bgs), clip_neg=clip)
    got = pts.tile_stats_u16(torch.from_numpy(tiles), torch.from_numpy(masks),
                             torch.from_numpy(bgs), clip_neg=clip)
    _assert_stats({k: v.numpy() for k, v in got.items()},
                  {k: np.asarray(v) for k, v in want.items()})
    empty = masks.sum(axis=(1, 2)) == 0
    assert empty.any()
    assert np.isnan(got["mean"].numpy()[:, empty]).all()
    assert (got["npx"].numpy()[:, empty] == 0).all()


def _batch(seed, B=3, N=5, C=2, t=48, lattice=True):
    """Tiles, tile-local padded polygons (some lanes invalid) and bgs."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 5000, (B, N, C, t, t)).astype(np.uint16)
    polys = []
    for _ in range(B * N):
        k = int(rng.integers(3, 12))
        pts_ = rng.uniform(1, t - 2, (k, 2))
        c = pts_.mean(axis=0)
        p = pts_[np.argsort(np.arctan2(pts_[:, 1] - c[1], pts_[:, 0] - c[0]))]
        polys.append(np.round(p * 2) / 2 if lattice else p)
    lp = pad_polygons(polys, 16).reshape(B, N, 16, 2)
    lp[0, 1] = 7.0                 # degenerate polygon: an empty ROI
    valid = np.ones((B, N), bool)
    valid[1, 3:] = False           # padded lanes
    bgs = rng.uniform(0, 600, (B, C)).astype(np.float32)
    return tiles, lp.astype(np.float32), valid, bgs


def _jax_packed(tiles, lp, valid, bgs, clip):
    """JAX batched_tile_stats_step, packed as the JAX runner's _pack."""
    stats, area = j_step(jnp.asarray(tiles), jnp.asarray(lp),
                         jnp.asarray(valid), jnp.asarray(bgs), clip_neg=clip)
    rows = [np.asarray(stats[f], np.float32) for f in J_FIELDS]
    rows.append(np.broadcast_to(np.asarray(area, np.float32)[:, None, :],
                                rows[0].shape))
    return np.stack(rows, axis=1)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "float"])
def test_packed_plain_matches_jax_step(clip, lattice):
    tiles, lp, valid, bgs = _batch(3, lattice=lattice)
    want = _jax_packed(tiles, lp, valid, bgs, clip)
    got = tsk.tile_stats_packed_plain(
        torch.from_numpy(tiles), torch.from_numpy(lp), torch.from_numpy(valid),
        torch.from_numpy(bgs), clip_neg=clip).numpy()
    assert got.shape == want.shape == (3, 10, 2, 5)
    _assert_stats({f: got[:, k] for k, f in enumerate(STAT_FIELDS)},
                  {f: want[:, k] for k, f in enumerate(STAT_FIELDS)})
    np.testing.assert_array_equal(got[:, 9], want[:, 9])          # area
    np.testing.assert_array_equal(got[:, 9], got[:, 8])           # == npx
    assert (got[1, 9, :, 3:] == 0).all()                          # padded
    assert np.isnan(got[1, 0, :, 3:]).all()
    assert (got[0, 9, :, 1] == 0).all() and np.isnan(got[0, :8, :, 1]).all()


def test_tile_stats_from_gathered_matches_jax():
    from imageprocess_tpu.ops.roistats import tile_stats_from_gathered as j_tsg

    tiles, lp, valid, bgs = _batch(5, B=2)
    ws, wa = j_tsg(jnp.asarray(tiles[0]), jnp.asarray(lp[0]),
                   jnp.asarray(valid[0]), jnp.asarray(bgs[0]))
    gs, ga = roistats.tile_stats_from_gathered(
        torch.from_numpy(tiles[0]), torch.from_numpy(lp[0]),
        torch.from_numpy(valid[0]), torch.from_numpy(bgs[0]))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    _assert_stats({k: v.numpy() for k, v in gs.items()},
                  {k: np.asarray(v) for k, v in ws.items()})


def test_float_tiles_name_the_fret_slice():
    """Float tiles take the float statistics the FRET slice brought
    (equal to the JAX float branch); the packed u16 step still refuses
    them, naming the serial intensity path."""
    from imageprocess_tpu.ops.roistats import tile_stats_from_gathered as j_tsg

    tiles, lp, valid, bgs = _batch(5, B=2)
    ws, wa = j_tsg(jnp.asarray(tiles[0].astype(np.float32)), jnp.asarray(lp[0]),
                   jnp.asarray(valid[0]), jnp.asarray(bgs[0]))
    gs, ga = roistats.tile_stats_from_gathered(
        torch.from_numpy(tiles[0]).float(), torch.from_numpy(lp[0]),
        torch.from_numpy(valid[0]), torch.from_numpy(bgs[0]))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    _assert_stats({k: v.numpy() for k, v in gs.items()},
                  {k: np.asarray(v) for k, v in ws.items()})
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tsk.tile_stats_packed_plain(
            torch.from_numpy(tiles).float(), torch.from_numpy(lp),
            torch.from_numpy(valid), torch.from_numpy(bgs))


def test_kernel_wrapper_refuses_cpu_tensors():
    """On CPU tensors the kernel entry points raise: they never run the
    plain version quietly (the runner picks the plain version by device)."""
    tiles, lp, valid, bgs = (torch.from_numpy(a) for a in _batch(5, B=2))
    before = dict(tsk.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.tile_stats_packed(tiles, lp, valid, bgs)
    masks = tsk.tile_masks(lp, valid, tiles.shape[-1])
    with pytest.raises(ValueError):
        tsk.launch_packed(tiles, masks, bgs)
    assert tsk.launches == before


def test_host_tile_helpers_match_jax():
    from imageprocess_tpu.ops import roistats as jrs

    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 65535, (2, 150, 170)).astype(np.uint16)
    polys = [rng.uniform(0, 140, (7, 2)) for _ in range(5)]
    polys.append(np.array([[0.5, 0.5], [160.5, 1.5], [80.5, 145.5]]))
    for H, W in ((150, 170), (60, 60)):
        assert roistats.choose_tile(polys, H, W) == jrs.choose_tile(polys, H, W)
    tile = roistats.choose_tile(polys[:5], 150, 170)
    offs = roistats.tile_offsets(polys[:5], 150, 170, tile)
    np.testing.assert_array_equal(offs, jrs.tile_offsets(polys[:5], 150, 170, tile))
    for a, b in zip(roistats.pad_local_polys(polys[:5], offs, 8, 32),
                    jrs.pad_local_polys(polys[:5], offs, 8, 32)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(roistats.gather_tiles(imgs, offs, 8, tile),
                                  jrs.gather_tiles(imgs, offs, 8, tile))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, clip):
    """On a card: the hand kernel against its plain version on the same
    device tensors — exact quantiles, vmin, vmax, npx and area; moments
    within rtol 1e-5."""
    tiles, lp, valid, bgs = (torch.from_numpy(a).to(cuda_device)
                             for a in _batch(3, lattice=False))
    before = tsk.launches["tilestats_u16"]
    got = tsk.tile_stats_packed(tiles, lp, valid, bgs, clip_neg=clip).cpu()
    assert tsk.launches["tilestats_u16"] == before + 1
    want = tsk.tile_stats_packed_plain(tiles, lp, valid, bgs, clip_neg=clip).cpu()
    exact = [1, 3, 4, 5, 6, 8, 9]
    torch.testing.assert_close(got[:, exact], want[:, exact], rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0, equal_nan=True)
