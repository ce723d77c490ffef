"""The port's mesh (``parallel/runner.py``): ``make_mesh``, the sharded
steps on a virtual mesh of 4 CPU shards against the JAX package's on a
4-device CPU mesh (tests/conftest.py gives JAX 8 virtual devices), the
batched runners with ``mesh=`` against the same runs without one, the
dispatch order, the U-Net tile batch over the mesh and the dry run.

Against JAX: masks, areas, npx and the extrema are bit-equal; moments and
the interpolated quantiles within 1e-5 relative (XLA's compiled
interpolation rounds a few ulps apart, ROADMAP Queue 3).  Against the
port's own run without a mesh: every value equal."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from imageprocess_tpu.parallel import runner as jrunner
from imageprocess_tpu.pipelines import fa as jfa
from imageprocess_tpu.pipelines import fret as jfret
from imageprocess_tpu.pipelines import nesprin2 as jn2
from imageprocess_tpu_torch.core import roiio, tiffio
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
from imageprocess_tpu_torch.ops.stats import STAT_FIELDS
from imageprocess_tpu_torch.parallel import runner
from imageprocess_tpu_torch.parallel.runner import Mesh, make_mesh
from imageprocess_tpu_torch.pipelines import fa as tfa
from imageprocess_tpu_torch.pipelines import fret as tfret
from imageprocess_tpu_torch.pipelines import intensity as tint
from imageprocess_tpu_torch.pipelines import nesprin2 as tn2

RTOL = 1e-5
EXACT = ("vmin", "vmax", "npx")
CPU4 = Mesh(("cpu",) * 4)
POLYS = [np.array([[10.5, 12.5], [60.5, 15.5], [55.5, 70.5], [8.5, 66.5]]),
         np.array([[70.5, 20.5], [110.5, 25.5], [105.5, 80.5], [72.5, 75.5]]),
         np.array([[20.5, 75.5], [50.5, 78.5], [45.5, 90.5], [22.5, 88.5]])]


@pytest.fixture(scope="module")
def jmesh():
    return jrunner.make_mesh(4)


def _assert_stats(got, want):
    """Port stats {field: (B, C, N)} against JAX's."""
    for f in STAT_FIELDS:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if f in EXACT:
            assert np.array_equal(a, b, equal_nan=f != "npx"), f
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, equal_nan=True,
                                       err_msg=f)


def _unpack(packed):
    """Packed (B, 10, C, N) -> ({field: (B, C, N)}, area (B, N))."""
    p = np.asarray(packed)
    return {f: p[:, k] for k, f in enumerate(STAT_FIELDS)}, p[:, len(STAT_FIELDS), 0]


def test_make_mesh_takes_the_first_devices_of_a_kind():
    m = make_mesh(device="cpu")
    assert m.devices == (torch.device("cpu"),) and m.axis_names == ("batch",)
    assert make_mesh(1, axis="rows", device="cpu").shape == {"rows": 1}
    assert CPU4.shape == {"batch": 4} and len(CPU4.devices) == 4


def test_make_mesh_refuses_more_devices_than_present(monkeypatch):
    with pytest.raises(ValueError, match="2 cpu devices requested but 1 present"):
        make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_mesh(1)                 # no fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 cuda devices requested but 1 present"):
        make_mesh(2, device="cuda")


@pytest.mark.parametrize("batch,n", [(8, 4), (3, 4), (6, 4), (9, 2), (5, 1)])
def test_round_batch_to_mesh_matches_jax(batch, n):
    assert runner.round_batch_to_mesh(batch, Mesh(("cpu",) * n)) == \
        jrunner.round_batch_to_mesh(batch, jrunner.make_mesh(n))
    assert runner.round_batch_to_mesh(batch, None) == batch


def _tiles(seed, B=8, N=3, C=2, t=16):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 4000, (B, N, C, t, t)).astype(np.uint16)
    tiles[:, :, :, :4, :4] = 7       # ties
    square = np.array([[1.5, 2.5], [13.5, 1.5], [14.5, 12.5], [2.5, 13.5]], np.float32)
    lp = np.broadcast_to(square, (B, N, 4, 2)).copy()
    lp[:, 1] -= 0.5
    valid = np.ones((B, N), bool)
    valid[1, 2] = valid[6, 0] = False
    bgs = rng.uniform(10, 200, (B, C)).astype(np.float32)
    return tiles, lp, valid, bgs


def test_sharded_tile_stats_and_fret_match_jax(jmesh):
    tiles, lp, valid, bgs = _tiles(0)
    got, area = _unpack(runner.sharded_batched_tile_stats(CPU4)(tiles, lp, valid, bgs))
    wstats, warea = jrunner.sharded_batched_tile_stats(jmesh)(
        *(jnp.asarray(a) for a in (tiles, lp, valid, bgs)))
    _assert_stats(got, wstats)
    assert np.array_equal(area, np.asarray(warea))
    eps = np.full((8,), 5.0, np.float32)
    for flip in (False, True):
        fs, fa = tfret.sharded_batched_fret_tile_stats(CPU4, flip=flip)(
            tiles, lp, valid, bgs, eps)
        ws, wa = jfret.sharded_batched_fret_tile_stats(jmesh, flip=flip)(
            *(jnp.asarray(a) for a in (tiles, lp, valid, bgs, eps)))
        _assert_stats(fs, ws)
        assert np.array_equal(np.asarray(fa), np.asarray(wa))


def test_sharded_intensity_steps_match_jax(jmesh):
    from imageprocess_tpu_torch.ops.roistats import pad_local_polys, tile_offsets

    rng = np.random.default_rng(1)
    B, C = 4, 2
    imgs = rng.integers(0, 4000, (B, C, 96, 128)).astype(np.float32)
    polys = np.stack([np.asarray(p, np.float32) for p in POLYS])
    polys = np.broadcast_to(polys, (B,) + polys.shape).copy()
    valid = np.ones((B, 3), bool)
    valid[2, 1] = False
    p1000s = np.array([[1000, 50000]] * B, np.int32)
    ts, ta, tbg = runner.sharded_intensity_step(CPU4)(imgs, polys, valid, p1000s)
    ws, wa, wbg = jrunner.sharded_intensity_step(jmesh)(
        *(jnp.asarray(a) for a in (imgs, polys, valid, p1000s)))
    _assert_stats(ts, ws)
    assert np.array_equal(ta.numpy(), np.asarray(wa))
    np.testing.assert_allclose(tbg.numpy(), np.asarray(wbg), rtol=1e-6)
    offs = tile_offsets(POLYS, 96, 128, 64)
    lp, off, _ = pad_local_polys(POLYS, offs, 3, 4)
    lp, off = (np.broadcast_to(a, (B,) + a.shape).copy() for a in (lp, off))
    ts2, ta2, _ = runner.sharded_batched_intensity_tiled(CPU4, tile=64)(
        imgs, lp, off, valid, p1000s)
    ws2, wa2, _ = jrunner.sharded_batched_intensity_tiled(jmesh, tile=64)(
        *(jnp.asarray(a) for a in (imgs, lp, off, valid, p1000s)))
    _assert_stats(ts2, ws2)
    assert np.array_equal(ta2.numpy(), np.asarray(wa2))


def test_sharded_fa_and_nesprin2_steps_match_jax(jmesh):
    from imageprocess_tpu_torch.ops.roistats import pad_local_polys, tile_offsets

    rng = np.random.default_rng(2)
    B, Hf, Wf = 4, 96, 128
    imgs = rng.integers(90, 130, (B, Hf, Wf)).astype(np.uint16)
    yy, xx = np.mgrid[0:Hf, 0:Wf]
    for b in range(B):
        for cy, cx in rng.uniform(20, 70, (4, 2)):
            imgs[b][(yy - cy) ** 2 + (xx - cx) ** 2 <= 9] = 3000
    offs = tile_offsets(POLYS, Hf, Wf, 64, margin=2)
    lp, off, valid = pad_local_polys(POLYS, offs, 4, 8)
    lp, off, valid = (np.broadcast_to(a, (B,) + a.shape).copy() for a in (lp, off, valid))
    kw = dict(tile=64, close_radius=1, max_labels=16, do_remove_small=True)
    got = tfa.sharded_fa_batched_step(CPU4, **kw)(imgs, lp, off, valid, 2.0, 4.0).numpy()
    want = np.asarray(jfa.sharded_fa_batched_step(jmesh, **kw)(
        *(jnp.asarray(a) for a in (imgs, lp, off, valid)), jnp.float32(2.0),
        jnp.float32(4.0)))
    gp, gn, gs, go = tfa.unpack_fa_flat(got, 4, 16)
    wp, wn, ws, wo = jfa.unpack_fa_flat(want, 4, 16)
    assert np.array_equal(gn, wn) and gn.max() > 0 and np.array_equal(go, wo)
    assert np.array_equal(gp["area"], wp["area"])
    for f in ("mean", "centroid_r", "centroid_c"):
        np.testing.assert_allclose(gp[f], wp[f], rtol=RTOL, atol=0, err_msg=f)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    # rim FRET with the annulus: the flat table, field by field
    cfg_kw = dict(donor_ch=1, fret_ch=2, annulus_on=True)
    A = rng.integers(100, 3000, (B, Hf, Wf)).astype(np.uint16)
    pv = np.stack([np.asarray(p, np.float32) for p in POLYS] + [np.zeros((4, 2), np.float32)])
    args = (imgs, A, np.zeros((B, 1, 1), np.uint16),
            np.broadcast_to(pv, (B,) + pv.shape).copy(), valid, lp, off)
    got = tn2.make_nesprin2_batched_step(tn2.Nesprin2Config(**cfg_kw), has_aonly=False,
                                         tile=64, mesh=CPU4)(*args).numpy()
    want = np.asarray(jn2.make_nesprin2_batched_step(
        jn2.Nesprin2Config(**cfg_kw), has_aonly=False, tile=64, mesh=jmesh)(
            *(jnp.asarray(a) for a in args)))
    gc, ge = tn2.unpack_n2_flat(got, 4)
    wc, we = jn2.unpack_n2_flat(want, 4)
    np.testing.assert_allclose(ge, we, rtol=RTOL)
    for f in tn2._N2_FIELDS:
        if f in ("area", "npx", "vmin", "vmax"):
            assert np.array_equal(gc[f], wc[f], equal_nan=True), f
        else:
            np.testing.assert_allclose(gc[f], wc[f], rtol=RTOL, atol=0, equal_nan=True,
                                       err_msg=f)


def _write_key(folder, tag, rng, chans=(1, 2), shape=(96, 128)):
    for ch in chans:
        tiffio.write_tiff16(str(folder / f"{tag}_{ch}.TIF"),
                            rng.integers(100, 3000, shape).astype(np.uint16))
    roiio.save_roi_bundle(str(folder / "roi" / f"{tag}.json"), tag, shape, POLYS)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """Seven stages of two channels, three ROIs each: with chunks of 4 the
    trailing chunk is short."""
    folder = tmp_path_factory.mktemp("mesh")
    (folder / "roi").mkdir()
    rng = np.random.default_rng(3)
    for s in range(1, 8):
        _write_key(folder, f"S{s:02d}", rng)
    return folder


def _same_rows(a, b):
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for k, v in rb.items():
            w = ra[k]
            assert w == v or (isinstance(v, float) and math.isnan(v) and math.isnan(w)), k


RUNNERS = {
    "intensity": lambda folder, **kw: tint.run_intensity_batched(
        str(folder), tint.IntensityConfig(channels=(1, 2), do_xls=False), **kw),
    "fret": lambda folder, **kw: tfret.run_fret_batched(
        str(folder), tfret.FretConfig(donor_ch=1, acceptor_ch=2, do_xls=False), **kw),
}   # rim FRET and FA: tests/test_torch_nesprin2.py, tests/test_torch_fa.py


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runners_on_a_cpu_mesh_equal_the_runs_without(experiment, name):
    """batch_size 3 rounds up to the mesh's 4; the trailing chunk of 3
    pads to 4 with invalid lanes, which give no rows."""
    q = dict(log=lambda *_: None, batch_size=3, device="cpu")
    want = RUNNERS[name](experiment, **q)
    assert len(want) == 7 * len(POLYS)
    _same_rows(RUNNERS[name](experiment, mesh=CPU4, **q), want)
    _same_rows(RUNNERS[name](experiment, mesh=make_mesh(1, device="cpu"), **q), want)


def test_every_shard_step_is_dispatched_before_any_fetch(experiment, monkeypatch):
    """Per chunk, every shard's step is called before any of the chunk's
    results is fetched (else the cards of a mesh would run one after
    another); each shard computes its own block."""
    events = []
    real_step, real_fetch = runner.batched_tile_stats_step, runner.fetch_block

    def step(tiles, *a, **k):
        events.append(("step", tiles.shape[0]))
        return real_step(tiles, *a, **k)

    def fetch(host, done):
        events.append(("fetch", host.shape[0]))
        return real_fetch(host, done)

    monkeypatch.setattr(runner, "batched_tile_stats_step", step)
    monkeypatch.setattr(runner, "fetch_block", fetch)
    rows = RUNNERS["intensity"](experiment, log=lambda *_: None, batch_size=4,
                                mesh=CPU4, device="cpu")
    assert len(rows) == 7 * len(POLYS)
    steps = [i for i, e in enumerate(events) if e[0] == "step"]
    fetches = [i for i, e in enumerate(events) if e[0] == "fetch"]
    assert len(steps) == len(fetches) == 2 * 4             # 2 chunks x 4 shards
    assert all(events[i][1] == 1 for i in steps + fetches)  # 4 lanes / 4 shards
    for c in range(2):
        assert max(steps[4 * c:4 * c + 4]) < min(fetches[4 * c:4 * c + 4])


@pytest.mark.parametrize("n", [3, 4])
def test_unet_tile_batch_on_a_cpu_mesh_gives_the_same_labels(n):
    """The tile batch (padded to a multiple of the mesh size) split over
    the shards: the label map and polygons of the run without a mesh."""
    from imageprocess_tpu_torch.models.unet import UNet
    from imageprocess_tpu_torch.segment import cellseg

    torch.manual_seed(0)
    model = UNet(features=(8, 16))
    frame = np.random.default_rng(0).normal(100.0, 20.0, (80, 112)).astype(np.float32)
    kw = dict(tile=32, overlap=4, min_size_px=5, prob_threshold=0.3, device="cpu")
    mesh = Mesh(("cpu",) * n)
    want = cellseg.label_frame_unet(frame, model, **kw)
    assert np.array_equal(cellseg.label_frame_unet(frame, model, mesh=mesh, **kw), want)
    a = cellseg.segment_frame_unet(frame, model, **kw)
    b = cellseg.segment_frame_unet(frame, model, mesh=mesh, **kw)
    assert len(a) == len(b) and all(np.array_equal(p, q) for p, q in zip(a, b))


def test_auto_seg_devices_above_the_cpu_count_raise(monkeypatch):
    from imageprocess_tpu_torch.segment import auto

    frame = np.zeros((64, 64), np.uint16)
    with pytest.raises(ValueError, match="2 cpu devices requested but 1 present"):
        auto.auto_segment_frame(frame, auto.AutoSegConfig(backend="unet", devices=2),
                                device="cpu")


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    from imageprocess_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7 and all(ln.startswith("dryrun_multichip(4, cpu): ")
                                   and " OK" in ln for ln in lines)


@pytest.mark.cuda
def test_virtual_cuda_mesh_launches_each_kernel_once_per_shard():
    """On a card: 4 shards on cuda:0, one launch of each kernel per shard,
    the packed results equal to the plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    mesh = Mesh(("cuda",) * 4)
    tiles, lp, valid, bgs = _tiles(4)
    tsk.reset_launches()
    got = runner.sharded_batched_tile_stats(mesh)(tiles, lp, valid, bgs)
    assert tsk.launches["tilestats_u16"] == 4
    want = tsk.tile_stats_packed_plain(*(torch.from_numpy(a) for a in (tiles, lp, valid, bgs)))
    gs, ga = _unpack(got)
    ws, wa = _unpack(want)
    _assert_stats(gs, ws)
    assert np.array_equal(ga, wa)
    eps = np.full((8,), 5.0, np.float32)
    rsk.reset_launches()
    fs, fa = tfret.sharded_batched_fret_tile_stats(mesh)(tiles, lp, valid, bgs, eps)
    assert rsk.launches["roistats_f32"] == 4
    ps, pa = tfret.batched_fret_tile_stats(*(torch.from_numpy(a) for a in (
        tiles, lp, valid, bgs, eps)))
    _assert_stats(fs, ps)
    assert torch.equal(fa, pa)
