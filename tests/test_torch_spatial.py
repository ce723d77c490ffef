"""Row-sharded frame ops of the port (``parallel/spatial.py``) on a virtual
mesh of 4 CPU shards, against the JAX package's on a 4-device CPU mesh
(tests/conftest.py gives JAX 8 virtual devices) and against the port's
whole-frame ops, on the same numpy-seeded 64 x 48 frames (16 rows per
shard).  Masks, labels and quantiles are bit-equal; the FA mean and
deviation within 1e-5 relative (the sums run in another order)."""

import numpy as np
import pytest
import torch

from imageprocess_tpu.parallel import spatial as jsp
from imageprocess_tpu.parallel.runner import make_mesh as jmake_mesh
from imageprocess_tpu_torch.morphology import binary as tb
from imageprocess_tpu_torch.morphology import ccl as tc
from imageprocess_tpu_torch.morphology import edt as te
from imageprocess_tpu_torch.parallel import spatial as tsp
from imageprocess_tpu_torch.parallel.runner import Mesh

H, W = 64, 48
RTOL = 1e-5


@pytest.fixture(scope="module")
def meshes():
    return Mesh(("cpu",) * 4, "rows"), jmake_mesh(4, axis="rows")


def _both(meshes, name, *args):
    """The port's and JAX's sharded function *name* built with *args*."""
    tm, jm = meshes
    return getattr(tsp, name)(tm, *args), getattr(jsp, name)(jm, *args)


def _frame(seed=0):
    return np.random.default_rng(seed).integers(0, 4000, (H, W)).astype(np.uint16)


def _snake(seed=5):
    """A snake across every shard boundary, blobs on the boundaries, noise."""
    rng = np.random.default_rng(seed)
    fg = np.zeros((H, W), bool)
    for y in range(H):
        x = 5 + int(30 * (0.5 + 0.5 * np.sin(y / 5.0)))
        fg[y, x:x + 2] = True
    fg[14:19, 30:40] = True           # across the 16-row boundary
    fg[0:2, 0:4] = True               # corner blob
    return fg | (rng.random((H, W)) > 0.97)


def test_shard_frame_splits_rows_in_order(meshes):
    tm, jm = meshes
    img = _frame()
    shards = tsp.shard_frame(tm, img)
    assert [tuple(b.shape) for b in shards] == [(16, W)] * 4
    assert np.array_equal(np.asarray(shards), np.asarray(jsp.shard_frame(jm, img)))
    with pytest.raises(ValueError, match="do not divide"):
        tsp.shard_frame(tm, img[:63])


@pytest.mark.parametrize("p", [1.0, 50.0, 99.0])
def test_quantile_and_bg_correct_match_jax(meshes, p):
    img = _frame()
    tq, jq = _both(meshes, "sharded_quantile_u16", int(p * 1000))
    got = float(tq(img))
    assert got == float(jq(jsp.shard_frame(meshes[1], img)))
    assert abs(got - np.percentile(img.astype(np.float64), p)) < 1e-6
    tb_, jb = _both(meshes, "sharded_bg_correct_u16", int(p * 1000))
    assert np.array_equal(np.asarray(tb_(img)), np.asarray(jb(jsp.shard_frame(meshes[1], img))))


@pytest.mark.parametrize("name,args,dense", [
    ("sharded_square_dilation", (1,), 0.97), ("sharded_square_dilation", (3,), 0.97),
    ("sharded_square_erosion", (1,), 0.3), ("sharded_square_erosion", (3,), 0.3),
    ("sharded_rim_mask", (1,), None), ("sharded_rim_mask", (3,), None),
    ("sharded_annulus_mask", (2, 5), 0.995), ("sharded_annulus_mask", (1, 2), 0.995),
    ("sharded_closing_disk", (1,), "snake"), ("sharded_closing_disk", (2,), "snake"),
])
def test_window_ops_match_jax_and_the_whole_frame(meshes, name, args, dense):
    rng = np.random.default_rng(len(name) + sum(args))
    if dense is None:              # blobs on a shard boundary and the frame edges
        x = np.zeros((H, W), bool)
        x[5:30, 5:40] = True
        x[0:4, 30:46] = True
        x[58:64, 0:10] = True
        x |= rng.random((H, W)) > 0.99
    elif dense == "snake":
        x = _snake()
    else:
        x = rng.random((H, W)) > dense
        x[12:20, 10:30] = True     # solid across the 16-row boundary
    t, j = _both(meshes, name, *args)
    got = np.asarray(t(x))
    assert np.array_equal(got, np.asarray(j(jsp.shard_frame(meshes[1], x))))
    xt = torch.from_numpy(x)
    whole = {"sharded_square_dilation": lambda: tb.square_dilation(xt, *args),
             "sharded_square_erosion": lambda: tb.binary_erosion(
                 xt, np.ones((2 * args[0] + 1,) * 2, bool), True),
             "sharded_rim_mask": lambda: te.rim_mask(xt, *args),
             "sharded_annulus_mask": lambda: tb.annulus_mask(xt, *args),
             "sharded_closing_disk": lambda: tb.binary_closing_skimage(
                 xt, tb.disk(args[0]))}[name]()
    assert np.array_equal(got, whole.numpy())


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_and_remove_small_match_jax_bit_for_bit(meshes, connectivity):
    fg = _snake()
    t, j = _both(meshes, "sharded_label", connectivity, 512)
    got = np.asarray(t(fg))
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(j(jsp.shard_frame(meshes[1], fg))))
    assert np.array_equal(got, tc.label(torch.from_numpy(fg), connectivity).numpy())
    assert got.max() > 50
    t, j = _both(meshes, "sharded_remove_small", 3, connectivity, 512)
    got = np.asarray(t(fg))
    assert np.array_equal(got, np.asarray(j(jsp.shard_frame(meshes[1], fg))))
    assert np.array_equal(got, tc.remove_small_objects(
        torch.from_numpy(fg), 3, connectivity).numpy())


def test_fa_stats_and_chain_match_jax(meshes):
    rng = np.random.default_rng(6)
    img = rng.integers(90, 120, (H, W)).astype(np.uint16)
    yy, xx = np.mgrid[0:H, 0:W]
    for cy, cx, r, v in [(8, 10, 3, 4000), (16, 30, 3, 3500),   # on a boundary
                         (40, 20, 4, 3900), (60, 40, 2, 3000)]:
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = v
    roi = np.zeros((H, W), bool)
    roi[2:64, 3:46] = True
    t, j = _both(meshes, "sharded_fa_stats")
    got, want = t(img), j(jsp.shard_frame(meshes[1], img))
    assert abs(got[0] - want[0]) <= RTOL * abs(want[0])
    assert abs(got[1] - want[1]) <= RTOL * abs(want[1])
    assert got[2] == want[2]
    t, j = _both(meshes, "sharded_fa_segment", 3.0, 5.0, 1, 64)
    (tl, tthr, tbg), (jl, jthr, jbg) = t(img, roi), j(
        jsp.shard_frame(meshes[1], img), jsp.shard_frame(meshes[1], roi))
    assert np.array_equal(np.asarray(tl), np.asarray(jl))
    assert abs(tthr - jthr) <= RTOL * abs(jthr) and tbg == jbg
    assert np.asarray(tl).max() >= 3


def test_label_of_empty_and_full_frames(meshes):
    t, j = _both(meshes, "sharded_label", 2, 16)
    assert np.asarray(t(np.zeros((H, W), bool))).max() == 0
    full = np.ones((H, W), bool)
    got = np.asarray(t(full))
    assert np.array_equal(got, np.asarray(j(jsp.shard_frame(meshes[1], full))))
    assert got.max() == 1 and got.min() == 1


def test_fa_stats_of_an_empty_background_sample_is_nan(meshes):
    img = np.full((H, W), 100.0, np.float32)
    img[::10, ::10] = np.nan      # exactly the bg subsample
    t, j = _both(meshes, "sharded_fa_stats")
    m, s, bg = t(img)
    assert np.isnan(bg) and np.isnan(j(jsp.shard_frame(meshes[1], img))[2])
    assert m == 100.0 and s == 0.0


def test_rim_of_an_empty_frame_is_empty(meshes):
    assert not np.asarray(tsp.sharded_rim_mask(meshes[0], 3)(np.zeros((H, W), bool))).any()


def test_label_overflow_raises_with_jax_message(meshes):
    fg = np.zeros((H, W), bool)
    fg[::4, ::4] = True            # 16 * 12 = 192 isolated pixels
    msgs = []
    for name in ("sharded_label", "sharded_remove_small"):
        args = (1, 64) if name == "sharded_label" else (2, 1, 64)
        for run, x in zip(_both(meshes, name, *args), (fg, jsp.shard_frame(meshes[1], fg))):
            with pytest.raises(ValueError, match="max_labels") as e:
                run(x)
            msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]
    assert np.asarray(tsp.sharded_label(meshes[0], 1, 4096)(fg)).max() == 192


def test_oversized_halo_is_refused_with_jax_message():
    tm, jm = Mesh(("cpu",) * 8), jmake_mesh(8)
    x = np.zeros((64, 128), bool)   # 8 rows per shard
    x[30:34, 60:70] = True
    for name, args in (("sharded_square_dilation", (9,)),
                       ("sharded_annulus_mask", (3, 12)),
                       ("sharded_rim_mask", (9,)), ("sharded_closing_disk", (5,))):
        msgs = []
        for run in (getattr(tsp, name)(tm, *args), getattr(jsp, name)(jm, *args)):
            with pytest.raises(ValueError, match="halo") as e:
                run(x)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert np.asarray(tsp.sharded_square_dilation(tm, 2)(x))[29, 60]


def test_blocks_stay_on_their_shards_and_inputs_may_be_shards(meshes):
    """A RowShards input is used as it is; every op returns one block per
    shard of the mesh, each of its shard's rows."""
    tm = meshes[0]
    fg = tsp.shard_frame(tm, _snake())
    out = tsp.sharded_square_dilation(tm, 1)(fg)
    assert isinstance(out, tsp.RowShards) and [b.shape[0] for b in out] == [16] * 4
    assert np.array_equal(np.asarray(out), np.asarray(
        tsp.sharded_square_dilation(tm, 1)(np.asarray(fg))))
    lab = tsp.sharded_label(tm, 2, 512)(list(fg))
    assert np.array_equal(np.asarray(lab),
                          tc.label(torch.from_numpy(np.asarray(fg)), 2).numpy())
