#!/usr/bin/env python
"""Train the generalist segmentation U-Net with the PyTorch port (the
counterpart of ``scripts/train_unet_general.py``, the JAX package's).

The same recipe: features FEATURES, TRAIN_TILE crops in batches of BATCH,
a pool of POOL synthcells frames of FRAME_HW x FRAME_HW across the five
appearance domains and three cell scales, AdamW with the warmup-cosine
schedule over the run.  Where ``--golden`` names the golden intensity
experiment's ``ANA`` folder (the JAX script's ``GOLDEN``) and it exists,
a share P_GOLDEN of the steps draws from its manual frame (``e2_P1``);
otherwise the script says so in one line, trains on the pool alone and
records ``"p_golden": 0``.  Snapshots every 500 steps go under
OUT/snapshots/, the final checkpoint to OUT, in the flax layout that both
packages read
(``models.checkpoint.save_checkpoint``); then the model segments each
domain's held-out frame (and the golden held-out frame where it exists)
through ``segment.cellseg.segment_frame_unet``, scored by
``segment.evalseg.match_instances``.

Usage: python scripts/train_unet_general_torch.py OUT [--steps N] [--device cuda]
           [--golden DIR]

OUT is required and must lie outside ``imageprocess_tpu/``, whose bundled
checkpoints belong to the JAX package.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

FEATURES = (16, 32, 64, 128)
TRAIN_TILE = 128          # crop size; inference tiles at INFER_TILE
INFER_TILE = 256
BATCH = 8
POOL = 160                # pre-generated synthetic frames
FRAME_HW = 384
P_GOLDEN = 0.2            # share of steps drawn from the real golden frame
SNAP_EVERY = 500


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="checkpoint directory (outside imageprocess_tpu/)")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--golden", help="the golden intensity experiment's ANA folder "
                    "(samples e2_P1 to train on, e1_P0 held out)")
    return ap.parse_args(argv)


def checked_out_dir(out: str) -> str:
    """*out* as an absolute path; exits when it lies inside the JAX
    package."""
    out = os.path.realpath(out)
    ref = os.path.realpath(os.path.join(REPO, "imageprocess_tpu"))
    if os.path.commonpath([out, ref]) == ref:
        raise SystemExit(f"refusing to write {out}: it lies inside {ref}, whose "
                         "checkpoints belong to the JAX package")
    return out


def build_pool(rng, device):
    """Pre-generate POOL synthetic frames across domains and scales."""
    from imageprocess_tpu_torch.models.synthcells import DOMAINS, frame_arrays, synth_frame

    scales = [(6.0, 16.0), (10.0, 28.0), (18.0, 48.0)]
    pool = []
    t0 = time.time()
    for i in range(POOL):
        dom = DOMAINS[i % len(DOMAINS)]
        r_range = scales[rng.integers(len(scales))]
        img, labels = synth_frame(rng, FRAME_HW, FRAME_HW, dom, r_range=r_range)
        pool.append(frame_arrays(img, labels, device=device))
    print(f"pool: {POOL} frames across {len(DOMAINS)} domains "
          f"({time.time() - t0:.0f}s)")
    return pool


def load_golden(golden, sample: str):
    """(frame, polygons) of one golden sample, or None without the folder."""
    if not golden or not os.path.isdir(golden):
        return None
    from imageprocess_tpu_torch.core import roiio, tiffio

    img = tiffio.read_2d(os.path.join(golden, sample, "S01_4.TIF"))
    polys = roiio.load_roi_polygons(os.path.join(golden, sample, "roi", "S01.json"))
    return np.asarray(img, np.float32), polys


def evaluate(model, device, golden=None, tile=INFER_TILE):
    """Cross-domain synthetic suite, plus the golden held-out frame where
    it exists."""
    from imageprocess_tpu_torch.models.synthcells import DOMAINS, eval_frame
    from imageprocess_tpu_torch.segment.cellseg import segment_frame_unet
    from imageprocess_tpu_torch.segment.evalseg import match_instances

    rows = {}
    for dom in DOMAINS:
        ev = eval_frame(0, dom)
        pred = segment_frame_unet(ev["img"], model, tile=tile, min_size_px=100,
                                  device=device)
        m = match_instances(pred, ev["polys"], ev["img"].shape, iou_threshold=0.3)
        rows[dom] = m
        print(f"  {dom:9s} {len(pred):3d} pred vs {len(ev['polys']):3d} gt — "
              f"recall {m['recall']:.2f} meanIoU {m['mean_iou']:.3f}")
    held_out = load_golden(golden, "e1_P0")
    if held_out is not None:
        img, polys = held_out
        pred = segment_frame_unet(img, model, tile=tile, min_size_px=200, device=device)
        m = match_instances(pred, polys, img.shape, iou_threshold=0.3)
        rows["golden_e1_P0"] = m
        print(f"  golden    {len(pred):3d} pred vs {len(polys):3d} gt — "
              f"recall {m['recall']:.2f} meanIoU {m['mean_iou']:.3f}")
    return rows


def main(argv=None):
    args = parse_args(argv)
    out = checked_out_dir(args.out)
    import torch

    from imageprocess_tpu_torch.device import resolve_device
    from imageprocess_tpu_torch.models.checkpoint import save_checkpoint
    from imageprocess_tpu_torch.models.golden import frame_training_arrays, sample_crops
    from imageprocess_tpu_torch.models.train import (TrainConfig, create_train_state,
                                                     train_step)

    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    rng = np.random.default_rng(7)
    train_golden = load_golden(args.golden, "e2_P1")
    if train_golden is None:
        print(f"no golden experiment folder ({args.golden or '--golden not given'}): "
              "training on the synthcells pool alone (p_golden 0)")
        golden, p_golden = None, 0.0
    else:
        golden, p_golden = frame_training_arrays(*train_golden, device=dev), P_GOLDEN
    pool = build_pool(rng, dev)

    cfg = TrainConfig(features=FEATURES, tile=TRAIN_TILE, batch_size=BATCH,
                      decay_steps=args.steps)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    meta = {"tile": INFER_TILE, "train_tile": TRAIN_TILE, "steps": args.steps,
            "train": "synthcells 5-domain mixture"
                     + (" + e2_P1/S01_4" if golden is not None else ""),
            "p_golden": p_golden}

    t0 = time.time()
    ema = None
    for i in range(args.steps):
        src = (golden if golden is not None and rng.random() < p_golden
               else pool[rng.integers(len(pool))])
        imgs, pb, fb = sample_crops(rng, *src, TRAIN_TILE, BATCH)
        state, loss = train_step(state, imgs, pb, fb, w_grad=cfg.grad_loss_weight)
        if i % 50 == 0 or i == args.steps - 1:
            val = float(loss)
            ema = val if ema is None else 0.9 * ema + 0.1 * val
            print(f"step {i}: loss {val:.4f} (ema {ema:.4f}, "
                  f"{time.time() - t0:.0f}s)", flush=True)
        if i and i % SNAP_EVERY == 0:
            save_checkpoint(os.path.join(out, "snapshots", f"step{i}"), state.model, meta)

    save_checkpoint(out, state.model, meta)
    print("saved", out)
    evaluate(state.model, dev, args.golden)


if __name__ == "__main__":
    main()
