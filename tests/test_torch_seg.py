"""Port parity: U-Net cell segmentation (``imageprocess_tpu_torch.segment``)
against the JAX package on the CPU.

Bars, and why:
- stretched tiles bit-equal: u16 -> f32, one subtraction, one division,
  one clip, each correctly rounded in both packages;
- the post-process (sigmoid, feathered recomposition in the same order of
  float additions, threshold, small-object removal, flow following, CCL)
  fed the JAX network's own output gives JAX's label map exactly: the
  float steps differ by ulps (sigmoid, interpolation contraction), which
  no pixel of these frames is close enough to a threshold or a rounding
  boundary to feel;
- the whole ``segment_frame_unet`` against JAX's: its bf16 forward differs
  from XLA's by up to ~0.1 logit (``tests/test_torch_unet.py``), which
  moves cell outlines by a pixel here and there, so polygons are matched
  at IoU >= 0.5 and must give recall >= 0.95 and mean IoU >= 0.95;
- the generalist on the five synthcells domains: the JAX package's own
  ``DOMAIN_BARS`` floors (``tests/test_unet_general.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.segment import cellseg as jseg
from imageprocess_tpu.segment.evalseg import match_instances
from imageprocess_tpu_torch.models.checkpoint import load_unet
from imageprocess_tpu_torch.segment import auto as tauto
from imageprocess_tpu_torch.segment import cellseg as tseg
from imageprocess_tpu_torch.timing import PhaseTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "imageprocess_tpu", "models", "pretrained")
GOLDEN = os.path.join(PRETRAINED, "unet_golden_v1")
GENERAL = os.path.join(PRETRAINED, "unet_general_v1")
DOMAIN_BARS = [  # tests/test_unet_general.py: (domain, recall, mean IoU) at IoU >= 0.3
    ("fluor", 0.90, 0.70),
    ("dense", 0.75, 0.65),
    ("inverted", 0.80, 0.65),
    ("ring", 0.80, 0.65),
    ("texture", 0.80, 0.65),
]


def _synth_u16(domain, seed, H, W):
    # the generator file loaded by path: the JAX models package imports flax
    from imageprocess_tpu_torch.models import synthcells

    img, lab = synthcells.synth_frame(np.random.default_rng(seed), H, W, domain)
    return np.clip(img, 0, 65535).astype(np.uint16), lab


def _corner_cells_frame(seed=4, H=384, W=384, cell=(160, 192)):
    """Cells in the top-left corner only, noisy flat background elsewhere,
    so that the cull prepass keeps few tiles."""
    img, _ = _synth_u16("fluor", seed, *cell)
    rng = np.random.default_rng(seed)
    bg = float(np.percentile(img, 5))
    out = rng.normal(bg, 0.01 * bg + 1, (H, W)).clip(0, 65535).astype(np.uint16)
    out[:cell[0], :cell[1]] = img
    return out


@pytest.fixture(scope="module")
def golden_flax():
    from imageprocess_tpu.models.checkpoint import load_checkpoint
    from imageprocess_tpu.models.unet import UNet as FlaxUNet

    model = FlaxUNet(features=(16, 32, 64, 128))
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 1)))
    return model, load_checkpoint(GOLDEN, like)


def _jax_tiles(u16, lo, hi, ys, xs, tile):
    lo, hi = jnp.float32(lo), jnp.float32(hi)
    den = jnp.where(hi <= lo, jnp.float32(1e-6), hi - lo)
    x = jnp.clip((jnp.asarray(u16).astype(jnp.float32) - lo) / den, 0.0, 1.0)
    return np.asarray(jnp.stack([x[y:y + tile, x0:x0 + tile]
                                 for y in ys for x0 in xs]))


@pytest.mark.parametrize("cull,flow_follow", [(False, True), (True, True),
                                              (False, False)])
def test_postprocess_fed_jax_output_gives_jax_labels(golden_flax, cull,
                                                     flow_follow):
    model, params = golden_flax
    u16 = _corner_cells_frame()
    H, W = u16.shape
    tile = 128
    ys, xs = tseg.tile_grid(H, W, tile, 32)
    T = len(ys) * len(xs)
    lohi = tseg._host_stretch_lohi(u16)
    assert lohi is not None and lohi[2] is u16
    # the port's stretched tiles equal JAX's
    lo_t = torch.tensor(lohi[0], dtype=torch.float32)
    hi_t = torch.tensor(lohi[1], dtype=torch.float32)
    x = ((torch.from_numpy(u16).to(torch.float32) - lo_t)
         / torch.where(hi_t <= lo_t, torch.tensor(1e-6), hi_t - lo_t)).clamp(0, 1)
    tiles = tseg.cut_tiles(x, ys, xs, tile)[:, 0].numpy()
    assert np.array_equal(tiles, _jax_tiles(u16, lohi[0], lohi[1], ys, xs, tile))
    # JAX's network output for every tile and the all-zero tile
    batch = np.concatenate([tiles, np.zeros((1, tile, tile), np.float32)])
    out_all = np.asarray(jax.jit(model.apply)(params, jnp.asarray(batch[..., None])))

    keep = tseg.keep_tiles(lohi, ys, xs, tile, 0.05 if cull else 0.0)
    if cull:
        b = -(-keep.size // 16) * 16
        assert 0 < keep.size < b < T            # JAX culls at this frame too
        keep_idx = np.full(b, T, np.int32)
        keep_idx[:keep.size] = keep
        fwd = np.concatenate([out_all[np.clip(keep_idx, 0, T - 1)], out_all[T:]])
        port_out, port_keep = np.concatenate([out_all[keep], out_all[T:]]), keep
    else:
        assert keep.size == T
        b, keep_idx, fwd = 0, np.zeros(1, np.int32), out_all[:T]
        port_out, port_keep = out_all[:T], None
    want, wover = jseg._seg_fused(
        lambda p, t: jnp.asarray(fwd), {}, jnp.asarray(u16),
        jnp.float32(lohi[0]), jnp.float32(lohi[1]), jnp.asarray(keep_idx),
        ys=tuple(ys), xs=tuple(xs), tile=tile, pad_h=0, pad_w=0,
        prob_threshold=0.5, min_size_px=100, max_labels=1024,
        flow_follow=flow_follow, host_stretch=True, n_keep=b)
    got, over = tseg.postprocess(
        torch.from_numpy(np.ascontiguousarray(port_out.transpose(0, 3, 1, 2))),
        port_keep, ys=ys, xs=xs, tile=tile, shape=(H, W),
        flow_follow=flow_follow)
    want = np.asarray(want)
    assert got.dtype == torch.uint16 and want.max() >= 2
    assert np.array_equal(got.numpy(), want)
    assert bool(over) == bool(wover)


@pytest.fixture(scope="module")
def golden_port():
    model, tile = load_unet(GOLDEN)
    return model, tile


def test_segment_frame_unet_matches_jax(golden_flax, golden_port):
    model, params = golden_flax
    u16, _ = _synth_u16("fluor", 7, 384, 512)
    want = jseg.segment_frame_unet(u16, model.apply, params, tile=256)
    timer = PhaseTimer("cpu")
    got = tseg.segment_frame_unet(u16, golden_port[0], tile=256,
                                  device="cpu", timer=timer)
    assert len(want) >= 5
    m = match_instances(got, want, u16.shape, iou_threshold=0.5)
    assert m["recall"] >= 0.95 and m["mean_iou"] >= 0.95, (m, len(got), len(want))
    assert {"upload_stretch", "tile_cut", "forward", "recomposition",
            "remove_small_objects", "follow_flows", "flow_label.ccl", "d2h",
            "polygons"} <= set(timer.times_ms())
    assert timer.counts["forward.tiles"] >= 1
    assert timer.counts["remove_small_objects.rounds"] >= 1


@pytest.mark.parametrize("domain,min_recall,min_iou", DOMAIN_BARS,
                         ids=[d for d, *_ in DOMAIN_BARS])
def test_general_checkpoint_meets_domain_bars(domain, min_recall, min_iou):
    from imageprocess_tpu.models.synthcells import eval_frame

    model, tile = tauto._unet_model(tauto.AutoSegConfig(checkpoint="general"),
                                    "cpu")
    ev = eval_frame(0, domain)
    pred = tseg.segment_frame_unet(ev["img"], model, tile=tile,
                                   min_size_px=100, device="cpu")
    m = match_instances(pred, ev["polys"], ev["img"].shape, iou_threshold=0.3)
    assert m["recall"] >= min_recall, (domain, m["recall"], len(pred))
    assert m["mean_iou"] >= min_iou, (domain, m)


def test_cull_on_equals_cull_off(golden_port):
    u16 = _corner_cells_frame(seed=5, H=448, W=640)
    ys, xs = tseg.tile_grid(*u16.shape, 256, 32)
    keep = tseg.keep_tiles(tseg._host_stretch_lohi(u16), ys, xs, 256, 0.05)
    assert 0 < keep.size < len(ys) * len(xs)
    on, off = (tseg.label_frame_unet(u16, golden_port[0], cull_margin=c,
                                     device="cpu") for c in (0.05, 0.0))
    assert on.max() >= 2
    assert np.array_equal(on, off)


def test_every_tile_culled_returns_no_polygons(golden_flax, golden_port):
    flat = np.full((300, 300), 700, np.uint16)       # no tile above background
    model, params = golden_flax
    assert jseg.segment_frame_unet(flat, model.apply, params) == []
    assert tseg.segment_frame_unet(flat, golden_port[0], device="cpu") == []


def _blobs_model(tiles):
    return (tiles - 0.5) * 20.0     # logit > 0 exactly on bright pixels


def test_toy_model_paths_match_jax():
    """A callable model, the small-tile overlap clamp, a frame smaller than
    the tile (reflect padding), float frames on the device-sort stretch,
    the CCL instead of flows: polygons equal to JAX's."""
    rng = np.random.default_rng(3)
    base = (rng.random((150, 170)) * 200).astype(np.uint16)
    base[60:90, 60:90] = 4000
    base[20:40, 120:150] = 3000
    for img, kw in (
        (base, dict(tile=64)),
        (base.astype(np.float32) + 0.25, dict(tile=64)),   # not u16-valued
        (base[:100, :120], dict(tile=128, overlap=8)),    # frame < tile
    ):
        want = jseg.segment_frame_unet(
            img, lambda p, t: (t - 0.5) * 20.0, {}, min_size_px=50,
            flow_follow=False, **kw)
        got = tseg.segment_frame_unet(img, _blobs_model, min_size_px=50,
                                      flow_follow=False, device="cpu", **kw)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_label_overflow_raises():
    img = np.full((128, 128), 100.0, np.float32)
    for cy in (20, 60, 100):                # 3 separated blobs > max_labels=2
        img[cy - 8:cy + 8, 20:36] = 4000.0
    with pytest.raises(ValueError, match="max_labels"):
        tseg.segment_frame_unet(img, _blobs_model, tile=128, min_size_px=20,
                                max_labels=2, flow_follow=False, device="cpu")


def test_entry_points_refuse_what_is_not_ported(monkeypatch):
    img = np.zeros((64, 64), np.uint16)
    with pytest.raises(NotImplementedError, match="item 12"):
        tseg.segment_frame_unet(img, _blobs_model, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tauto.auto_segment_frame(img, tauto.AutoSegConfig(backend="unet",
                                                          devices=2), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tseg.segment_frame_unet(img, _blobs_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tauto.run_auto_drawer(".", tauto.AutoSegConfig())


def _blob_image(seed=0, shape=(200, 260)):
    rng = np.random.default_rng(seed)
    img = rng.normal(100, 5, shape).astype(np.float32)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    img += 2000 * (((yy - 90) ** 2 + (xx - 120) ** 2) < 40 ** 2)
    img += 1500 * (((yy - 150) ** 2 + (xx - 210) ** 2) < 20 ** 2)
    return img


@pytest.mark.parametrize("thr_mode,thr_k", [("percentile", 0.0), ("mean_std", 1.0)])
def test_threshold_backend_matches_jax(thr_mode, thr_k):
    """Label maps equal to JAX's: the blur sums its taps in another order
    (~3e-7 rel), which moves the threshold by an ulp and flips no pixel of
    this frame."""
    from imageprocess_tpu.segment import auto as jauto

    img = _blob_image(1)
    kw = dict(smooth_sigma=1.5, thr_mode=thr_mode, open_radius=1,
              close_radius=2, min_size=50, max_labels=1024)
    want, wthr, wover = jauto.auto_segment_step(
        jnp.asarray(img), jnp.int32(90000), jnp.float32(thr_k), **kw)
    got, thr, over = tauto.auto_segment_step(
        torch.from_numpy(img), thr_p1000=90000, thr_k=thr_k, **kw)
    assert int(got.max()) >= 2 and not bool(over) and not bool(wover)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert abs(float(thr) - float(wthr)) <= 1e-6 * abs(float(wthr))
    cfg = dict(thr_mode=thr_mode, thr_k=thr_k, smooth_sigma=1.5,
               open_radius=1, close_radius=2, min_size_px=50)
    polys = tauto.auto_segment_frame(img, tauto.AutoSegConfig(**cfg), "cpu")
    jpolys = jauto.auto_segment_frame(img, jauto.AutoSegConfig(**cfg))
    assert len(polys) == len(jpolys) == int(got.max())
    for g, w in zip(polys, jpolys):
        assert np.array_equal(g, w)


def test_run_auto_drawer_matches_jax(tmp_path):
    """Both backends through the batch loop: S01.json written, a 0-cell
    frame writes no file, blank and corrupt frames log and continue, and
    the same bundles as the JAX package's run_auto_drawer."""
    from imageprocess_tpu.core import roiio as jroiio
    from imageprocess_tpu.core import tiffio
    from imageprocess_tpu.segment import auto as jauto

    cells, _ = _synth_u16("fluor", 11, 256, 320)
    tiffio.write_tiff16(str(tmp_path / "S01_4.TIF"), cells)
    near_flat = np.full((96, 96), 100, np.uint16)
    near_flat[40:42, 50:52] = 103                   # not blank, but no cell
    tiffio.write_tiff16(str(tmp_path / "S02_4.TIF"), near_flat)
    tiffio.write_tiff16(str(tmp_path / "S03_4.TIF"), np.zeros((64, 64), np.uint16))
    (tmp_path / "S04_4.TIF").write_bytes(b"II*\x00garbage")
    for backend, extra in (("unet", {}), ("threshold", {"thr_mode": "mean_std",
                                                        "thr_k": 3.0})):
        out = {}
        for name, mod, kw in (("jax", jauto, {}), ("port", tauto, {"device": "cpu"})):
            logs = []
            roi_dir = str(tmp_path / f"roi_{backend}_{name}")
            cfg = mod.AutoSegConfig(backend=backend, channel=4, min_size_px=100,
                                    **extra)
            written = mod.run_auto_drawer(str(tmp_path), cfg, roi_dir=roi_dir,
                                          log=logs.append, **kw)
            out[name] = (written, logs)
        (jw, jlogs), (tw, tlogs) = out["jax"], out["port"]
        assert [os.path.basename(p) for p in tw] == ["S01.json"], tlogs
        assert [os.path.basename(p) for p in jw] == ["S01.json"]
        joined = "\n".join(tlogs)
        assert "S03_4.TIF" in joined and "S04_4.TIF" in joined
        tb, jb = jroiio.load_roi_bundle(tw[0]), jroiio.load_roi_bundle(jw[0])
        assert tb["generated_by"] == jb["generated_by"]
        assert tb["name"] == jb["name"] == "S01"
        assert tb["image_shape"] == jb["image_shape"] == {"height": 256, "width": 320}
        tp = [np.asarray(p) for p in tb["rois"]]
        jp = [np.asarray(p) for p in jb["rois"]]
        m = match_instances(tp, jp, cells.shape, iou_threshold=0.5)
        assert len(jp) >= 3 and m["recall"] >= 0.95 and m["mean_iou"] >= 0.95, m


@pytest.mark.cuda
def test_cuda_segmentation_matches_cpu(golden_port):
    """On a card: the post-process fed the CPU's network output gives the
    CPU's label map, and the whole path agrees with the CPU's at IoU >= 0.5
    (recall and mean IoU >= 0.95; cuDNN's bf16 convs differ from oneDNN's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    u16, _ = _synth_u16("fluor", 7, 384, 512)
    model = golden_port[0]
    tiles, keep, ys, xs = tseg.frame_tiles(u16, device="cpu")
    out = tseg.forward_tiles(model, tiles)
    kw = dict(ys=ys, xs=xs, tile=256, shape=u16.shape)
    cpu_lab, _ = tseg.postprocess(out, keep, **kw)
    cuda_lab, _ = tseg.postprocess(out.cuda(), keep, **kw)
    assert np.array_equal(cuda_lab.cpu().numpy(), cpu_lab.numpy())
    want = tseg.segment_frame_unet(u16, model, device="cpu")
    got = tseg.segment_frame_unet(u16, model, device="cuda")
    m = match_instances(got, want, u16.shape, iou_threshold=0.5)
    assert m["recall"] >= 0.95 and m["mean_iou"] >= 0.95, m
