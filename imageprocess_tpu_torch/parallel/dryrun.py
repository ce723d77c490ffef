"""The multi-device dry run: every sharded path held to its single-device
path on a virtual mesh (the port's counterpart of ``dryrun_multichip`` in
the JAX package's ``__graft_entry__.py``).

    python -m imageprocess_tpu_torch.parallel.dryrun [N] [--device cpu]

A virtual mesh repeats one device N times, so the dry run needs neither N
cards nor N processes: the counterpart of JAX's virtual CPU devices.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _example(B, C=2, H=64, W=128, N=8, V=32):
    """The JAX dry run's frames, polygons, validity and percentiles."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 4096, size=(B, C, H, W)).astype(np.float32)

    def poly(cx, cy, r):
        th = np.linspace(0, 2 * np.pi, V, endpoint=False)
        return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], -1)

    polys = np.stack([poly(10 + 13 * (i % 8), 10 + 11 * (i // 8 % 4), 6 + (i % 3))
                      for i in range(N)]).astype(np.float32)
    polys = np.broadcast_to(polys, (B, N, V, 2)).copy()
    return imgs, polys, np.ones((B, N), bool), np.full((B, C), 1000, np.int32)


def _same(got, want, what: str) -> None:
    """Equal trees of tensors (NaN where NaN), or raise naming *what*."""
    if isinstance(want, dict):
        for k in want:
            _same(got[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    g, w = torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want))
    if g.shape != w.shape or not torch.equal(g.isnan(), w.isnan()) or \
            not torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)):
        raise AssertionError(f"dryrun_multichip: sharded {what} differs from "
                             "the single-device path")


def _host(x):
    """A tree of tensors on the host."""
    from .runner import _tree_map

    return _tree_map(lambda t: t.cpu(), x)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Hold each multi-device path on a virtual *n_devices*-shard mesh of
    *device* to its single-device path, printing one line each:

    1. the sharded intensity step (data parallelism over (stage, time)
       frames), and its tiled form;
    1b. the production minimum-transfer tile-stats step (``tilestats_u16``
        once per shard on a card);
    1c. the sharded FRET tables step (``roistats_f32`` once per shard);
    1c2/1c3. the sharded FA and rim-FRET tables steps;
    1d. a spatial collective: row-sharded connected-component labelling
        (halo exchange + summed change flags), bit-equal to the
        whole-frame labels;
    3. the U-Net tile batch split over the mesh (``roi-auto --devices N``),
       with random weights from a seed: the same polygons.

    Not run: JAX's sharded training step, which waits for the port of
    training (ROADMAP Queue 1 item 11).
    """
    from ..device import resolve_device
    from ..pipelines.fa import fa_batched_step, sharded_fa_batched_step
    from ..pipelines.fret import batched_fret_tile_stats, sharded_batched_fret_tile_stats
    from ..pipelines.nesprin2 import Nesprin2Config, make_nesprin2_batched_step
    from . import runner
    from .runner import Mesh

    dev = resolve_device(device)
    mesh = Mesh((dev,) * n_devices)
    B = n_devices
    tag = f"dryrun_multichip({n_devices}, {dev.type})"

    def on_dev(*arrays):
        return [runner.to_shard(a, dev) for a in arrays]

    # 1) the sharded intensity step, whole-frame and tiled
    imgs, polys, valid, p1000s = _example(B)
    got = runner.sharded_intensity_step(mesh)(imgs, polys, valid, p1000s)
    _same(got, _host(runner.batched_intensity_step(*on_dev(imgs, polys, valid, p1000s))),
          "intensity step")
    from ..ops.roistats import choose_tile, pad_local_polys, tile_offsets

    tile = choose_tile(list(polys[0]), *imgs.shape[2:])
    offs = tile_offsets(list(polys[0]), *imgs.shape[2:], tile)
    lp, off, _ = pad_local_polys(list(polys[0]), offs, polys.shape[1], polys.shape[2])
    lp, off = np.broadcast_to(lp, (B,) + lp.shape).copy(), np.broadcast_to(
        off, (B,) + off.shape).copy()
    got_t = runner.sharded_batched_intensity_tiled(mesh, tile=tile)(
        imgs, lp, off, valid, p1000s)
    _same(got_t, _host(runner.batched_intensity_step_tiled(
        *on_dev(imgs, lp, off, valid, p1000s), tile=tile)), "tiled intensity step")
    print(f"{tag}: intensity OK — stats mean shape {tuple(got[0]['mean'].shape)}, "
          f"bgs {got[2][0].tolist()}")

    # 1b) the minimum-transfer tile-stats step
    rng = np.random.default_rng(1)
    t, N, C = 8, 4, 2
    tiles = rng.integers(0, 65536, (B, N, C, t, t)).astype(np.uint16)
    square = np.array([[1.5, 1.5], [6.5, 1.5], [6.5, 6.5], [1.5, 6.5]], np.float32)
    tlp = np.broadcast_to(square[None, None], (B, N, 4, 2)).copy()
    tvalid = np.ones((B, N), bool)
    bgs = np.full((B, C), 100.0, np.float32)
    packed = runner.sharded_batched_tile_stats(mesh)(tiles, tlp, tvalid, bgs)
    _same(packed, runner.batched_tile_stats_step(*on_dev(tiles, tlp, tvalid, bgs)).cpu(),
          "tile-stats step")
    print(f"{tag}: tile-stats OK — area {float(packed[0, -1, 0, 0])}")

    # 1c) the FRET tables step
    ftiles = rng.integers(1, 65536, (B, N, 2, t, t)).astype(np.uint16)
    feps = np.full((B,), 5.0, np.float32)
    fstats, farea = sharded_batched_fret_tile_stats(mesh)(ftiles, tlp, tvalid, bgs, feps)
    _same((fstats, farea), _host(batched_fret_tile_stats(
        *on_dev(ftiles, tlp, tvalid, bgs, feps))), "FRET tile-stats step")
    if not torch.isfinite(fstats["mean"]).all():
        raise AssertionError(f"{tag}: non-finite FRET means")
    print(f"{tag}: fret tile-stats OK — ratio mean {float(fstats['mean'][0, 0, 0]):.4f}")

    # 1c2) the FA tables step
    Hs, Ws = 64, 96
    fa_imgs = rng.integers(0, 4096, (B, Hs, Ws)).astype(np.uint16)
    fa_lp = np.broadcast_to(np.array([[2.5, 2.5], [20.5, 2.5], [20.5, 20.5],
                                      [2.5, 20.5]], np.float32)[None, None],
                            (B, N, 4, 2)).copy()
    fa_off = np.zeros((B, N, 2), np.int32)
    kw = dict(tile=32, close_radius=1, max_labels=16, do_remove_small=True)
    fa_flat = sharded_fa_batched_step(mesh, **kw)(fa_imgs, fa_lp, fa_off, tvalid, 2.0, 4.0)
    _same(fa_flat, fa_batched_step(*on_dev(fa_imgs, fa_lp, fa_off, tvalid), 2.0, 4.0,
                                   **kw).cpu(), "FA step")
    print(f"{tag}: fa tables OK — flat width {fa_flat.shape[1]}")

    # 1c3) the rim-FRET tables step (QC + rim + annulus + per-ROI stats)
    n2_cfg = Nesprin2Config(donor_ch=1, fret_ch=2, intensity_ch=3, annulus_on=True)
    n2_D = rng.integers(1, 4096, (B, Hs, Ws)).astype(np.uint16)
    n2_A = rng.integers(1, 4096, (B, Hs, Ws)).astype(np.uint16)
    n2_args = (n2_D, n2_A, np.zeros((B, 1, 1), np.uint16), fa_lp, tvalid, fa_lp, fa_off)
    n2_flat = make_nesprin2_batched_step(n2_cfg, has_aonly=False, tile=32,
                                         mesh=mesh)(*n2_args)
    _same(n2_flat, make_nesprin2_batched_step(n2_cfg, has_aonly=False, tile=32)(
        *on_dev(*n2_args)).cpu(), "nesprin2 step")
    print(f"{tag}: nesprin2 tables OK — flat width {n2_flat.shape[1]}")

    # 1d) row-sharded connected components vs the whole-frame labels
    from ..morphology.ccl import label
    from .spatial import sharded_label

    Hs = 16 * n_devices
    fg = np.zeros((Hs, 96), bool)
    for y in range(Hs):  # snake crossing every shard boundary
        x = 10 + int(30 * (0.5 + 0.5 * np.sin(y / 7.0)))
        fg[y, x:x + 2] = True
    fg[0:2, 80:90] = True
    fg[Hs - 3:Hs, 60:70] = True
    lab = np.asarray(sharded_label(mesh, connectivity=2, max_labels=256)(fg))
    _same(lab, label(torch.from_numpy(fg).to(dev), connectivity=2).cpu(), "CCL")
    print(f"{tag}: sharded CCL OK — {int(lab.max())} components, exact parity")

    # 3) the U-Net tile batch split over the mesh: identical polygons
    from ..models.unet import UNet
    from ..segment.cellseg import segment_frame_unet

    torch.manual_seed(0)
    model = UNet(features=(8, 16)).to(dev)
    frame = np.random.default_rng(0).normal(100.0, 20.0, (48, 80)).astype(np.float32)
    kw = dict(tile=32, overlap=4, min_size_px=5, prob_threshold=0.3, device=dev)
    single = segment_frame_unet(frame, model, **kw)
    sharded = segment_frame_unet(frame, model, mesh=mesh, **kw)
    if len(single) != len(sharded) or not all(
            np.array_equal(a, b) for a, b in zip(single, sharded)):
        raise AssertionError(f"{tag}: sharded U-Net polygons differ")
    print(f"{tag}: sharded U-Net inference OK — {len(sharded)} polygons, exact parity")


if __name__ == "__main__":
    argv = sys.argv[1:]
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    n = next((int(a) for a in argv if a.isdigit()), 4)
    dryrun_multichip(n, device=device)
