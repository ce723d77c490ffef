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


# --- stacks: the JAX functions under ``vmap`` -------------------------------

def _stack_of(names):
    return np.stack([MASKS[n] for n in names])


# masks that converge in different numbers of rounds, in one stack
STACKS = {
    "mixed": _stack_of(["blobs0", "spiral", "empty", "full", "snake", "noise"]),
    "blobs": _stack_of(["blobs0", "blobs1_sparse", "blobs2_dense"]),
    "one": _stack_of(["comb"]),
}


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_stacked_label_and_roots_bit_equal(name, connectivity):
    """A stack of tiles labels each tile on its own: bit-equal to the JAX
    functions under ``vmap`` and to the port's own 2-D calls, the overflow
    flag per tile, and a (2, N, H, W) batch of stacks the same."""
    import jax

    stack = STACKS[name]
    want = np.asarray(jax.vmap(lambda m: jccl.label_roots(m, connectivity))(
        jnp.asarray(stack)))
    got = tccl.label_roots(_t(stack), connectivity)
    assert got.dtype == torch.int32
    _eq(got, want)
    jlab, jover = jax.vmap(lambda m: jccl.label(
        m, connectivity, max_labels=8, with_overflow=True))(jnp.asarray(stack))
    lab, over = tccl.label(_t(stack), connectivity, max_labels=8,
                           with_overflow=True)
    assert lab.dtype == torch.int32 and over.shape == (len(stack),)
    _eq(lab, jlab)
    _eq(over, jover)
    for i in range(len(stack)):
        lab_i, over_i = tccl.label(_t(stack[i]), connectivity, max_labels=8,
                                   with_overflow=True)
        _eq(lab_i, lab[i])
        assert bool(over_i) == bool(over[i]) and over_i.dim() == 0
        _eq(tccl.label_roots(_t(stack[i]), connectivity), got[i])
    both = np.stack([stack, stack[::-1]])
    lab2, over2 = tccl.label(_t(both), connectivity, max_labels=8,
                             with_overflow=True)
    _eq(lab2, np.stack([np.asarray(jlab), np.asarray(jlab)[::-1]]))
    assert over2.shape == both.shape[:2]


@pytest.mark.parametrize("min_size", [1, 5, 40.5])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_stacked_remove_small_and_sizes_bit_equal(name, min_size):
    """remove-small on a stack, with an int or (as the focal-adhesion chain
    passes it) a float minimum size, and the per-tile root sizes."""
    import jax

    stack = STACKS[name]

    def jax_one(m):
        roots = jccl.label_roots(m, 1)
        sizes = jccl._root_sizes(roots)
        keep = sizes[roots.ravel()].reshape(m.shape).astype(jnp.float32) >= min_size
        return m & keep, sizes

    want, want_sizes = jax.vmap(jax_one)(jnp.asarray(stack))
    _eq(tccl.remove_small_objects(_t(stack), min_size), want)
    roots = tccl.label_roots(_t(stack), 1)
    sizes = tccl._root_sizes(roots)
    _eq(sizes, want_sizes)
    _eq(tccl._sizes_at(sizes, roots) >= min_size,
        np.asarray(want) | ~stack)        # background looks up the sentinel bin
    for i in range(len(stack)):
        _eq(tccl.remove_small_objects(_t(stack[i]), min_size), np.asarray(want)[i])


@pytest.mark.parametrize("se_name", ["disk1", "disk2", "asym", "even4x2"])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_stacked_closing_bit_equal(name, se_name):
    import jax

    stack, se = STACKS[name], SES[se_name]
    for fn, jfn in ((tbin.binary_dilation, jbin.binary_dilation),
                    (tbin.binary_erosion, jbin.binary_erosion),
                    (tbin.binary_closing_skimage, jbin.binary_closing_skimage)):
        want = np.asarray(jax.vmap(lambda m: jfn(m, se))(jnp.asarray(stack)))
        got = fn(_t(stack), se)
        assert got.dtype == torch.bool
        _eq(got, want)
        _eq(fn(_t(stack[-1]), se), want[-1])
        _eq(fn(_t(np.stack([stack, stack])), se), np.stack([want, want]))


@pytest.mark.parametrize("max_labels", [4, 64])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_stacked_region_props_match_jax(name, max_labels):
    """region_props on a stack against the JAX function under ``vmap``:
    areas, boxes and n_labels bit-equal; the float outputs within one
    float32 ulp of a float64 numpy reference (the port accumulates in
    float64 and rounds once) and within 1e-5 relative of JAX's sequential
    float32 sums, whose own error grows with the region (up to 3072 pixels
    here; 1e-6 holds for regions of focal-adhesion size, see
    test_torch_fa.py); labels above max_labels are dropped; stacked ==
    per-tile."""
    import jax

    from imageprocess_tpu.morphology import regions as jreg
    from imageprocess_tpu_torch.morphology import regions as treg

    stack = STACKS[name]
    rng = np.random.default_rng(11)
    inten = rng.normal(800.0, 200.0, stack.shape).astype(np.float32)
    lab = tccl.label(_t(stack), 2)
    want = jax.vmap(lambda a, b: jreg.region_props(a, b, max_labels=max_labels))(
        jnp.asarray(lab.numpy()), jnp.asarray(inten))
    got = treg.region_props(lab, _t(inten), max_labels=max_labels)
    assert sorted(got) == sorted(want)
    for k in ("area", "min_r", "min_c", "max_r", "max_c", "n_labels"):
        assert got[k].dtype == torch.int32, k
        _eq(got[k], want[k])
    for k in ("sum", "mean", "centroid_r", "centroid_c"):
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=0, err_msg=k)
    rr, cc = np.indices(stack.shape[1:])
    for i, l in ((i, l) for i in range(len(stack))
                 for l in range(1, min(int(lab[i].max()), max_labels) + 1)):
        m = lab[i].numpy() == l
        ref = {"sum": inten[i][m].sum(dtype=np.float64)}
        ref["mean"] = ref["sum"] / m.sum()
        ref["centroid_r"], ref["centroid_c"] = rr[m].mean(), cc[m].mean()
        for k, v in ref.items():
            assert abs(float(got[k][i, l - 1]) - v) <= 1.2e-7 * abs(v), (k, i, l)
    if max_labels == 4 and name != "one":
        assert int(lab.max()) > max_labels      # some labels were dropped
    for i in range(len(stack)):
        one = treg.region_props(lab[i], _t(inten[i]), max_labels=max_labels)
        for k, v in one.items():
            assert torch.equal(v, got[k][i]), k


def test_stacked_rounds_count_once_per_stack():
    """One convergence flag per round for the whole stack: the count is the
    slowest tile's."""
    rounds = {}
    for name in ("blobs0", "spiral"):
        timer = PhaseTimer("cpu")
        tccl.label(_t(MASKS[name]), 1, timer=timer)
        rounds[name] = timer.counts["rounds"]
    timer = PhaseTimer("cpu")
    tccl.label(_t(_stack_of(["blobs0", "spiral", "blobs0"])), 1, timer=timer)
    assert timer.counts["rounds"] == max(rounds.values())
