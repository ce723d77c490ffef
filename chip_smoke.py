#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It drives the port's main paths on the card, at the shapes of the repo's
benchmark (16 stages x channels (2, 3) of 1536 x 2048 u16 frames with 18
circular ROIs of radius 60 each, 288 rows per run): the batched
tables-only intensity runner
(``imageprocess_tpu_torch.pipelines.intensity.run_intensity_batched``),
the batched FRET tables runner
(``imageprocess_tpu_torch.pipelines.fret.run_fret_batched``, channels 2/3
as donor/acceptor), the serial runners ``run_intensity`` (the CLI's
default intensity path) and ``run_fret``, the Nesprin-2 rim-FRET runners
``run_nesprin2`` and ``run_nesprin2_batched`` and the morphology workload
``run_morphology`` (``imageprocess_tpu_torch.pipelines.nesprin2`` /
``.morphology``, tables only), the focal-adhesion runners ``run_fa_batched``
and ``run_fa_batch`` (``.pipelines.fa``, on an experiment of the same shape
with bright blobs inside each cell), the TIFF image outputs of
``run_intensity``, ``run_fret`` and ``run_nesprin2`` (``do_tif=True``),
their PNG outputs (``do_png=True``), the morphology overlays and the
channel cropper (``.pipelines.crop.run_crop``), the figures that the JAX
package lays out with matplotlib (the rim-FRET panel, the FA overview
figures and crop PNGs), U-Net cell segmentation of
one 1536 x 2048 frame
(``imageprocess_tpu_torch.segment.cellseg.segment_frame_unet``, the bundled
golden checkpoint), ROI refinement (``.segment.drawer.refine_and_save``),
the FRET timelapse deck (``.pipelines.fretppt.run_fret_ppt``) and the
command line users run them through (``imageprocess_tpu_torch.cli``: the
commands, ``--xprof`` and ``doctor``).  Phases, each
of which exits non-zero on failure:

1. the card's name and power limit;
2. build ``kernels/tilestats_u16.cu`` and ``kernels/roistats_f32.cu`` with
   nvcc into ``imageprocess_tpu_torch/_build/``, one nvcc each, started
   together;
3. hold each kernel to its plain PyTorch version on the card.
   ``tilestats_u16``: random, tie-heavy, empty-ROI and padded-lane cases,
   the bench tile (t = 128) in both kernel variants and a t = 272 tile
   from device memory.  ``roistats_f32``, in both of its forms (a full
   frame with tile origins, a stack of tiles): random values with
   negatives, NaN and +-inf inside and outside the masks, ties and signed
   zeros, empty masks and padded lanes, unaligned origins into a bench
   frame, the bench FRET chunk (4 x 18 tiles x 3 channels, t = 128) in
   its three kernel variants (keys and mask in shared memory, the keys
   alone, device memory), a T = 224 tile (keys alone by default) and a
   tile above the shared-memory limit.  Then the cases that stress a radix
   select, for both kernels in every variant: every value equal, every value in one high-byte (u16) or
   top-byte (f32 key) bin, values over 0..65535 and keys from -inf to
   +inf with subnormals and +-0, n = 0, 1 and 2, ranks on either side of a
   bin edge, C = 1, 2 and 3, tiles of 36, 37 and 50 pixels (unaligned and
   row-wise staging).  Masks, npx, area, vmin, vmax and the quantiles must
   be equal; mean, std and vsum within 1e-5 relative;
4. write the dataset (under ``imageprocess_tpu_torch/_build/``);
5. run each batched runner on the card: the first run checks every
   chunk's kernel output against the plain version on the same device
   tensors and counts kernel launches (the counts are set to 0 just before
   the run and read just after); later runs are timed.  Rows are checked
   against a numpy reference for a few ROIs of two stages;
6. a small experiment with a key of another frame shape (the batched
   runners' per-key path) gives the same rows on the card as on the CPU,
   for each runner;
7. the serial runners ``run_intensity`` and ``run_fret`` on the same
   dataset: a warm run, a checked run (every ``roistats_f32`` launch -- one
   per key, its ROI tiles at unaligned origins in the uploaded frame -- held
   to its plain version, the count set to 0 just before and read just
   after: 16 each), two timed runs (warm and steady Mpix/s); their 288
   rows equal the batched runners' (backgrounds, eps, order statistics,
   areas and npx exact, moments within 1e-5 relative);
8. the variant experiment: phase 6's keys plus a PNG union mask, a key
   without ROI (the whole-frame ROI 0), a 600-px ROI (T = 608, the kernel
   from device memory), a full-frame ROI, 8-bit, float32-with-NaN and RGB
   frames; every bg_mode x bg_scope of ``run_intensity`` and of
   ``run_fret`` (both ratio modes): the card's rows equal the CPU's, every
   launch equals its plain version;
9. ``roistats_f32`` at the serial shapes, each launch checked against its
   plain version: one key (F = 1, C = 2, R = 24, T = 128, unaligned
   origins) and the whole-frame ROI 0 of a bench frame (zero-padded to
   2048 x 2048), per call and by graph replay;
10. rim FRET and morphology on the same dataset (channel 2 donor, 3 FRET,
   0.223 um/px, rim 1.0 um = 4 px), once with the annulus off and once with
   the annulus local background (0.9 / 1.8 um, T = 144) and QC thresholds
   that remove pixels (saturation 2500, ratio clip 3.0): ``run_nesprin2``
   warm, checked (every ``roistats_f32`` launch held to its plain version:
   one per pair, two with the annulus), timed and once under
   ``torch.profiler``; ``run_nesprin2_batched(batch_size=4)`` checked (one
   or two launches per chunk; rows equal to the serial rows exactly) and
   timed; the card's rows of the first and last pair equal the CPU's; stage
   S01 against a numpy / scipy replica of the reference math at 1e-4
   relative; ``roistats_f32`` timed at each launch's shape (one pair, one
   chunk; C = 4 frames, C = 2 annulus medians, C = 4 re-ratio stack).
   ``run_morphology``: 288 rows, the card's equal to the CPU's (areas
   exact and equal to the rasterizer's mask counts, moment metrics within
   1e-5 relative), seconds per run;
11. focal adhesions: an experiment of 16 such frames with ten Gaussian
   blobs (sigma 2 to 6.5 px) inside each of the 18 circles, 0.223 um/px,
   alpha 3, closing radius 1 (tile 144): ``run_fa_batched(batch_size=4)``
   and ``run_fa_batch`` warm and timed; every stage yields rows and two
   categories occur; batched rows == serial rows, every value; the card's
   rows of the first and the last stage equal the port's on the CPU (areas,
   categories and counts exact, floats within 1e-5 relative); S01 against a
   numpy / scipy replica of the reference loop; the master workbooks read
   back; one batched run with CUDA-event phases and the CCL round counts,
   one run of each runner under ``torch.profiler`` (launches per frame, the
   device's idle share).  The path launches no hand kernel: the JAX
   package's FA program is XLA;
12. TIFF outputs: ``do_tif=True`` through ``run_intensity`` (with
   ``tif_mask_outside``), ``run_fret`` and ``run_nesprin2`` on the first
   four stages: a checked run (every ``roistats_f32`` launch held to its
   plain version, the count set to 0 just before and read just after: 4
   each), a timed tables-only run and a timed run with the TIFFs (the
   difference per key is the download, the percentiles and the writes);
   the rows with TIFFs equal the tables-only rows; the files, read back
   with PIL, equal the same run's on the CPU (float32 within 1e-6, NaN in
   the same places, previews within one count);
13. PNG outputs and the cropper: PIL's FreeType and the committed font
   first; then, on 2 stages with 4 of the 18 ROIs and at the configs' PNG
   defaults (dpi 300, 500-px crops, FRET's and rim FRET's inset
   colorbar), ``run_intensity``, ``run_fret`` and ``run_nesprin2``
   (annulus and QC) with ``do_png`` and ``run_morphology`` with
   ``MorConfig``'s overlays: a checked run (every ``roistats_f32`` launch
   held to its plain version, the count set to 0 just before and read
   just after), a timed tables-only run and a timed run with the PNGs
   (extra seconds and PNGs per key), the rows with PNGs equal to the
   tables-only rows, stage 1's PNGs against the same run on the CPU (the
   same files and canvases, pixels equal but on at most 0.1 % of a canvas,
   there within one LUT step); ``run_crop`` over the 2 stages with all 18
   ROIs (seconds per frame, stage 1 against the CPU) and
   ``crop_view_tiled`` by CUDA events, its card output against the CPU's
   on the same inputs;
14. segmentation: a deterministic synthcells "fluor" frame (u16), segmented
   to polygons once warm and three times timed (e2e Mpix/s = H*W / wall
   seconds, frame on the host to polygons), once more with per-phase CUDA
   events and the CCL round counts.  Checks: the card's label map agrees
   with the port's on the CPU (recall and mean IoU >= 0.95 at IoU >= 0.5),
   the card's post-process fed the CPU's network output gives the CPU's
   label map exactly, and the generalist checkpoint finds the generator's
   cells (recall >= 0.90, mean IoU >= 0.70 at IoU >= 0.3);
15. refine: 4 synthcells "fluor" frames of 1536 x 2048 u16 (24 cells of
   radius 20-60, a fixed seed) with one rough polygon per generator
   instance of >= 150 px (its convex hull scaled 1.3x about its centroid,
   one-decimal vertices: bbox tiles of 64-256 px); ``refine_and_save`` on
   the card in percentile mode (p40) over the four frames (the first warm,
   the next two steady, the last under ``torch.profiler``: launches per
   polygon, the device's idle share) and in BND mode (k 0.25) over stage 1,
   each writing the full bundle (JSON, mask TIFF, overlay PNG, ImageJ zip);
   recall and mean IoU at IoU >= 0.5 against the generator's outlines
   through ``evalseg.match_instances`` (percentile recall >= 0.9);
   ``segment_inside_polygon`` in ms per polygon, its phases by CUDA events
   and its CCL rounds; stage 1 against the port on the CPU, per polygon:
   percentile thresholds, polygons and whole bundles (JSON, mask and
   overlay pixels, zip entries) equal; BND thresholds within 1e-5
   relative, polygons equal unless a pixel lies between the two
   thresholds and, when every polygon is equal, the whole bundle.  Then the deck:
   ``run_fret_ppt`` over ratio / BF thumbnails written with PIL, read back
   with ``read_pptx_summary`` (slides and pictures counted).  The path
   launches no hand kernel: the JAX package's tile program is XLA;
16. the command line, on the card by default (no ``--device``):
   ``python3 -m imageprocess_tpu_torch.cli intensity`` on the dataset as a
   subprocess (its report equal to ``run_intensity``'s, byte for byte; its
   wall seconds against the direct call: the CLI's overhead); in process,
   ``cli.main`` for ``intensity``, ``intensity --batched`` and ``fret`` with
   both kernels' launches counted around each call (equal to the direct
   runners': 16 ``roistats_f32``; ``tilestats_u16`` at the runner's default
   batch; 4 ``roistats_f32``) and their reports equal to the direct runs';
   ``nesprin2 --batched`` (stage 1), ``morphology``, ``fa --batched``,
   ``crop`` (stage 1), ``roi-auto --backend unet``, ``refine`` (a quarter
   frame) and ``ppt``, each file equal to the direct call's; ``--xprof DIR``
   (a trace that parses as JSON and names the ``roistats_f32`` kernel once
   per key) and ``doctor --json`` (every check ok, ``mesh`` on a virtual
   4-shard mesh of the card),
   both as subprocesses;
17. the figures that the JAX package lays out with matplotlib, drawn with
   PIL: the rim-FRET 2-up panel of ``run_nesprin2`` and
   ``run_nesprin2_batched`` (annulus and QC, ``do_png``, ``save_panel``,
   ``add_scalebar``) on 2 stages, its ``roistats_f32`` launches equal to
   the same run's without the panel (each held to the plain version) and
   the panels equal to the CPU run's pixel for pixel; ``fa --figs
   --export-crops`` (and ``--mat-dir`` with a crafted MATLAB v7.3 file
   where h5py imports, which a line says) through ``cli.main`` on 2 stages
   x 18 cells of the FA experiment, every overview figure and crop equal
   to the direct CPU calls' pixel for pixel; seconds per panel, per
   overview figure and per crop;
18. U-Net training (``models.train``) at the generalist training script's
   full width (features (16, 32, 64, 128), tile 128, batch 8): 200
   ``train_step`` calls on crops of a pool of 8 synthcells frames (the
   script's 160, cut), every loss finite and the final EMA below the first
   loss; one bf16 and one float32-model step on the card against the same
   step on the CPU (loss 1e-3 / 1e-5 relative, gradients 5e-2 / 1e-4
   relative norm); ``save_checkpoint`` -> ``load_unet``, logits bit-equal;
   ``make_sharded_train_step`` on 4 virtual shards of cuda:0 against
   ``train_step`` (float32 model: loss 1e-6 relative, gradients 1e-4
   relative norm, the update equal to one AdamW step from the averaged
   gradients, parameters within 0.1 lr where the two gradients agree to
   10 %); ms per step and Mpix/s at tile 128 and at tile 256 (the golden
   script's crop) with one step under ``torch.profiler``; neither hand
   kernel launches;
19. kernel and plain times per chunk: each kernel's time per call through
   its Python wrapper against the plain version's (CUDA events around 50
   calls, in turns plain / kernel / kernel / plain), the kernel's device
   time by CUDA graph replay (the wrapper's host time left out), the grid
   and resident CTAs per SM, and the bound: the larger of the bytes the
   kernel must move (inputs read once, outputs written once, counted from
   the launched tensors) at 3.35 TB/s and its float32 operations at 67
   TFLOP/s (the H100 SXM's data-sheet rates).

The last two lines of standard output are one JSON object per line: the
kernel table (``ms`` per call, ``device_ms`` by graph replay, ``bound_ms``,
``bound_by``, ``library_ms`` -- null: no single PyTorch call computes
masked moments with six exact order statistics -- and
``launches_per_run``, ``launches_mesh`` (per runner and mesh); ``roistats_f32`` also ``launches_serial`` and its
``serial_shapes`` times, ``launches_nesprin2`` and its ``nesprin2_shapes``
times, ``launches_tiff_outputs``, ``launches_image_outputs``,
``launches_figures``; both ``launches_cli`` and ``launches_train``), then
``{"ok": true, "device": {...}}``.  Without
a card, or outside a checkout, it prints no result and exits non-zero.

``python3 chip_smoke.py --kernels-only`` stops after phase 3.
``python3 chip_smoke.py --kernel-times [--root DIR]`` only builds and
times the two kernels of the checkout at DIR (default: this one) on
synthetic bench-like inputs -- the intensity chunk and FRET stacks of
T = 128 ... 240 -- per call and by graph replay, each launch
checked against its plain version, and prints one JSON line; run with the
roots of two checkouts in one process each, it compares them on one card.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 1536, 2048
N_STAGES = 16
CHANNELS = (2, 3)
N_ROI = 18
ROI_RADIUS = 60
REL_TOL = 1e-5
EXACT_ROWS = (1, 3, 4, 5, 6, 8, 9)   # median p5 p95 vmin vmax npx area
MOMENT_ROWS = (0, 2, 7)              # mean std vsum
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "tilestats_u16": ("imageprocess_tpu_torch/kernels/tilestats_u16.cu",
                      "imageprocess_tpu/ops/pallas_tilestats.py:47"),
    "roistats_f32": ("imageprocess_tpu_torch/kernels/roistats_f32.cu",
                     "imageprocess_tpu/ops/pallas_roistats.py:98"),
}
ROW_EXACT = (1, 3, 4, 5, 6, 8)       # (R, C, 9) rows: median p5 p95 vmin vmax npx
ROW_MOMENTS = (0, 2, 7)              # mean std vsum


class SmokeError(RuntimeError):
    pass


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


# ------------------------------------------------------------------ compare

def compare_packed(got, want, what: str, exact=EXACT_ROWS,
                   moments=MOMENT_ROWS) -> dict:
    """Kernel vs plain statistics on one device, the statistic on axis 1
    ((B, 10, C, N) packed, or (R, 9, C) rows): NaN where NaN, *exact* rows
    equal by value (an infinite quantile only where both are), *moments*
    rows finite and within REL_TOL."""
    import torch

    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    if g.shape != w.shape:
        raise SmokeError(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    nan_g, nan_w = torch.isnan(g), torch.isnan(w)
    if not torch.equal(nan_g, nan_w):
        raise SmokeError(f"{what}: NaN positions differ")
    ok = ~nan_w
    exact = list(exact)
    ge, we = g[:, exact][ok[:, exact]], w[:, exact][ok[:, exact]]
    if not torch.equal(ge, we):
        raise SmokeError(f"{what}: exact rows differ by "
                         f"{(ge - we).abs().nan_to_num(nan=float('inf')).max().item()}")
    mom = list(moments)
    gm, wm = g[:, mom][ok[:, mom]], w[:, mom][ok[:, mom]]
    if not torch.isfinite(gm).all() or not torch.isfinite(wm).all():
        raise SmokeError(f"{what}: infinite moments")
    rel = ((gm - wm).abs() / wm.abs().clamp(min=1e-9))
    max_rel = rel.max().item() if rel.numel() else 0.0
    if max_rel > REL_TOL:
        raise SmokeError(f"{what}: moments differ by {max_rel:.3e} rel > {REL_TOL}")
    rows = exact + mom
    sel = ok[:, rows] & torch.isfinite(w[:, rows])
    diff = (g[:, rows] - w[:, rows]).abs()[sel]
    return {"max_abs_err": diff.max().item() if diff.numel() else 0.0,
            "max_rel_err_moments": max_rel}


def _random_polys(rng, n, t, lattice=True):
    import numpy as np

    out = []
    for _ in range(n):
        k = int(rng.integers(3, 24))
        pts = rng.uniform(1, t - 2, (k, 2))
        c = pts.mean(axis=0)
        pts = pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]
        out.append(np.round(pts * 2) / 2 if lattice else pts)
    return out


def _circle(cx, cy, r, nv=24):
    import numpy as np

    th = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], -1)


def kernel_cases(device):
    """(name, tiles, local_polys, roi_valid, bgs, clip_neg, use_smem)
    tensors on *device*."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.geom import polygon

    rng = np.random.default_rng(7)
    cases = []

    def add(name, tiles, polys, valid, bgs, clip, use_smem=None):
        B, N = valid.shape
        V = max(len(p) for row in polys for p in row)
        lp = np.stack([polygon.pad_polygons(row, V) for row in polys])
        cases.append((
            name,
            torch.from_numpy(tiles).to(device),
            torch.from_numpy(lp.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(bgs.astype(np.float32)).to(device),
            clip, use_smem))

    # random values, half-lattice and free-float vertices, invalid lanes
    B, N, C, t = 2, 5, 2, 64
    tiles = rng.integers(0, 65536, (B, N, C, t, t)).astype(np.uint16)
    polys = [_random_polys(rng, N, t, lattice=(b == 0)) for b in range(B)]
    valid = np.ones((B, N), bool)
    valid[1, 3:] = False
    bgs = np.array([[120.5, 37.25], [0.0, 4000.0]])
    for clip in (True, False):
        add(f"random clip={clip}", tiles, polys, valid, bgs, clip)
    # tie-heavy values around the background (clip boundary)
    vals = np.array([0, 36, 37, 38, 120, 121, 4095], np.uint16)
    tiles = rng.choice(vals, size=(B, N, C, 48, 48)).astype(np.uint16)
    polys = [_random_polys(rng, N, 48) for _ in range(B)]
    bgs = np.array([[37.0, 120.5], [37.0, 120.5]])
    for clip in (True, False):
        add(f"tie-heavy clip={clip}", tiles, polys, np.ones((B, N), bool),
            bgs, clip)
    # empty ROIs (degenerate polygon, one-pixel sliver) and padded lanes
    tiles = rng.integers(0, 4096, (1, 4, 2, 32, 32)).astype(np.uint16)
    polys = [[np.full((4, 2), 5.0),
              np.array([[3.0, 3.0], [3.4, 3.0], [3.4, 3.4]]),
              np.array([[2.5, 2.5], [20.5, 2.5], [20.5, 20.5], [2.5, 20.5]]),
              np.array([[2.5, 2.5], [20.5, 2.5], [20.5, 20.5]])]]
    add("empty + padded", tiles, polys, np.array([[True, True, True, False]]),
        np.array([[10.0, 20.0]]), True)
    # the bench tile: t = 128, two channels (80 KB staged, above 48 KB)
    B, N, C, t = 4, 18, 2, 128
    tiles = rng.integers(0, 65536, (B, N, C, t, t)).astype(np.uint16)
    polys = [[_circle(63.5 + rng.uniform(-1, 1), 63.5 + rng.uniform(-1, 1),
                      ROI_RADIUS) for _ in range(N)] for _ in range(B)]
    valid = np.ones((B, N), bool)
    bgs = rng.uniform(50, 500, (B, C))
    add("bench t=128", tiles, polys, valid, bgs, True)
    add("bench t=128 from device memory", tiles, polys, valid, bgs, True,
        use_smem=False)
    # above the opt-in shared-memory limit: 3 x 272^2 u16 = 444 KB
    B, N, C, t = 1, 2, 3, 272
    tiles = rng.integers(0, 65536, (B, N, C, t, t)).astype(np.uint16)
    polys = [[_circle(135.5, 135.5, 130), _circle(100.5, 140.5, 80)]]
    add("t=272 from device memory", tiles, polys,
        np.ones((B, N), bool), rng.uniform(0, 1000, (B, C)), False,
        use_smem=False)
    return cases


def check_kernel(device) -> dict:
    import torch

    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk

    worst = {"max_abs_err": 0.0, "max_rel_err_moments": 0.0}
    for name, tiles, lp, valid, bgs, clip, use_smem in kernel_cases(device):
        t = tiles.shape[-1]
        smem = tsk.kernel_uses_smem(t, tiles.device) \
            if use_smem is None else use_smem
        got = tsk.tile_stats_packed(tiles, lp, valid, bgs, clip_neg=clip,
                                    use_smem=use_smem)
        want = tsk.tile_stats_packed_plain(tiles, lp, valid, bgs,
                                           clip_neg=clip)
        torch.cuda.synchronize()
        # masks on the card == masks on the CPU (the CPU rasterizer is the
        # one the tests hold bit-equal to the JAX package)
        m_dev = tsk.tile_masks(lp, valid, t).cpu()
        m_cpu = tsk.tile_masks(lp.cpu(), valid.cpu(), t)
        if not torch.equal(m_dev, m_cpu):
            raise SmokeError(f"{name}: card masks differ from CPU masks")
        err = compare_packed(got, want, name)
        for k in worst:
            worst[k] = max(worst[k], err[k])
        print(f"kernel check ok: {name} shape={tuple(tiles.shape)} "
              f"smem={smem} npx_sum={int(want[:, 8].nansum().item())} "
              f"max_abs_err={err['max_abs_err']} "
              f"max_rel_err_moments={err['max_rel_err_moments']}")
    return worst


def roistats_cases(device):
    """(name, frames, masks, offs, opts) tensors on *device*, in the
    kernel's two forms: one frame with tile origins, or a stack of tiles
    with origin 0 (``stack_offsets``); *opts* force a kernel variant
    (``roi_stat_rows``'s use_smem / stage_mask)."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk

    rng = np.random.default_rng(11)
    cases = []

    def frame_form(name, img, masks, offs, **opts):
        offs3 = np.concatenate([np.zeros((len(offs), 1), np.int32),
                                np.asarray(offs, np.int32)], 1)
        cases.append((name, torch.from_numpy(img[None]).to(device),
                      torch.from_numpy(masks).to(device),
                      torch.from_numpy(offs3).to(device), opts))

    def stack_form(name, tiles, masks, **opts):
        cases.append((name, tiles.to(device).contiguous(),
                      torch.from_numpy(masks).to(device),
                      rsk.stack_offsets(len(masks), device), opts))

    def origins(n, H, W, t):
        return np.stack([rng.integers(0, H - t + 1, n),
                         rng.integers(0, W - t + 1, n)], 1)

    # random values with negatives, no clip
    img = rng.normal(-30, 80, (2, 300, 400)).astype(np.float32)
    masks = rng.random((6, 64, 64)) > 0.3
    frame_form("random negatives", img, masks, origins(6, 300, 400, 64))
    stack_form("random negatives, stack form",
               torch.from_numpy(img[:, :64, :384].reshape(2, 64, 6, 64)
                                .transpose(2, 0, 1, 3).copy()), masks)
    # NaN and +-inf inside and outside the masks
    img = rng.uniform(0, 4000, (3, 200, 260)).astype(np.float32)
    bad = rng.random(img.shape)
    img[bad < 0.02] = np.nan
    img[(bad >= 0.02) & (bad < 0.03)] = np.inf
    img[(bad >= 0.03) & (bad < 0.04)] = -np.inf
    img[0, 10:50, 10:50] = np.nan
    masks = rng.random((5, 48, 48)) > 0.5
    frame_form("NaN and inf", img, masks, [[10, 10]] + list(origins(4, 200, 260, 48)))
    # ties and signed zeros (keys of -0.0 and +0.0 are one key)
    vals = np.array([-0.0, 0.0, -1.5, 2.25, 2.25, 7.0, 3e6, -1e-3], np.float32)
    img = rng.choice(vals, size=(3, 96, 96)).astype(np.float32)
    masks = rng.random((4, 48, 48)) > 0.3
    masks[3] = False
    masks[3, 5, 5] = True                                    # n = 1
    frame_form("ties and signed zeros", img, masks, origins(4, 96, 96, 48))
    # empty masks and padded lanes (all-zero masks)
    img = rng.uniform(0, 100, (2, 64, 64)).astype(np.float32)
    masks = np.zeros((5, 32, 32), bool)
    masks[1, 3:20, 4:9] = True
    frame_form("empty masks + padded lanes", img, masks, origins(5, 64, 64, 32))
    # unaligned origins into one bench frame: 18 tiles, t = 128
    img = (rng.normal(120, 15, (2, H, W)) + 3000.0 * (rng.random((2, H, W)) > 0.97)
           ).astype(np.float32)
    masks = rng.random((N_ROI, 128, 128)) > 0.25
    frame_form("unaligned origins into a bench frame", img, masks,
               origins(N_ROI, H - 1, W - 1, 128) | 1)
    # the bench FRET chunk: 4 x 18 tiles x [ratio, donor, acceptor], t = 128
    tiles = torch.from_numpy(rng.integers(60, 3200, (4, N_ROI, 2, 128, 128))
                             .astype(np.uint16))
    stack = rsk.fret_tile_stack(tiles, torch.tensor(rng.uniform(50, 120, (4, 2)),
                                                    dtype=torch.float32),
                                torch.full((4,), 5.0))
    masks = np.broadcast_to(
        _circle_mask(128, 63.5, 63.5, ROI_RADIUS), (4 * N_ROI, 128, 128)).copy()
    masks[-3:] = False                                        # padded lanes
    stack_form("bench FRET chunk", stack, masks)
    stack_form("bench FRET chunk, keys staged, mask from device memory", stack,
               masks, stage_mask=False)
    stack_form("bench FRET chunk from device memory", stack, masks, use_smem=False)
    # T = 224: the keys fit the opt-in shared memory, keys and mask do not
    tiles = torch.from_numpy(rng.normal(900, 300, (4, 3, 224, 224)).astype(np.float32))
    masks = np.stack([_circle_mask(224, 111.5, 111.5, 108 - 9 * i) for i in range(4)])
    stack_form("T=224, keys staged", tiles, masks)
    # above the opt-in shared-memory limit: 272^2 f32 keys = 296 KB
    tiles = torch.from_numpy(rng.normal(1.0, 0.3, (2, 3, 272, 272)).astype(np.float32))
    masks = np.stack([_circle_mask(272, 135.5, 135.5, 130),
                      _circle_mask(272, 100.5, 140.5, 80)])
    stack_form("t=272 above the shared-memory limit", tiles, masks)
    return cases


def _circle_mask(t, cx, cy, r):
    import numpy as np

    yy, xx = np.mgrid[0:t, 0:t]
    return (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r


def check_roistats(device) -> dict:
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk

    worst = {"max_abs_err": 0.0, "max_rel_err_moments": 0.0}
    for name, frames, masks, offs, opts in roistats_cases(device):
        T = masks.shape[-1]
        smem, staged_mask = rsk.kernel_variant(T, frames.device, **opts)
        got = rsk.roi_stat_rows(frames, masks, offs, **opts)
        want = rsk.roi_stat_rows_plain(frames, masks, offs)
        torch.cuda.synchronize()
        err = compare_packed(got.movedim(-1, 1), want.movedim(-1, 1), name,
                             ROW_EXACT, ROW_MOMENTS)
        for k in worst:
            worst[k] = max(worst[k], err[k])
        print(f"roistats check ok: {name} frames={tuple(frames.shape)} "
              f"tiles={tuple(masks.shape)} smem={smem} stage_mask={staged_mask} "
              f"npx_sum={int(want[..., 8].nansum().item())} "
              f"max_abs_err={err['max_abs_err']} "
              f"max_rel_err_moments={err['max_rel_err_moments']}")
    return worst


def _edge_values(u16: bool):
    """102 sorted values whose ranks 5|6 (p5), 50|51 (median) and 95|96
    (p95, with weights 0.05, 0.5 and 0.95) fall on either side of a radix
    bin edge: a high-byte edge for u16, a top-, second- and low-byte edge
    of the f32 sort keys."""
    import numpy as np

    if u16:
        v = np.full(102, 1000, np.uint16)
        v[:6], v[6:50], v[50], v[51], v[52:95] = 255, 300, 511, 512, 700
        v[95], v[96] = 767, 768
        return v
    f = np.float32
    v = np.full(102, 2000.0, f)
    v[:6], v[6:50] = 7.5, 8.5                       # 8.0 starts a top-byte bin
    v[50] = np.nextafter(f(9.0), f(0.0))             # 0x410fffff | 0x41100000
    v[51], v[52:95] = 9.0, 500.0
    v[95], v[96] = 1000.0, np.nextafter(f(1000.0), f(np.inf))
    return v


def _place(rng, n, t, vals=None, C=1, fill=0):
    """A t x t mask with n pixels set at random places and, with *vals*,
    (C, t, t) tiles holding a shuffle of them there per channel (everything
    else *fill*)."""
    import numpy as np

    idx = rng.choice(t * t, size=n, replace=False)
    mask = np.zeros(t * t, bool)
    mask[idx] = True
    if vals is None:
        return mask.reshape(t, t)
    tiles = np.full((C, t * t), fill, vals.dtype)
    for c in range(C):
        tiles[c, idx] = rng.permutation(vals)
    return mask.reshape(t, t), tiles.reshape(C, t, t)


def radix_cases_u16():
    """(name, tiles (B, N, C, t, t) u16, masks (B, N, t, t) bool, bgs (B, C))
    numpy cases that stress the u16 radix select."""
    import numpy as np

    rng = np.random.default_rng(23)
    cases = []
    for C, t in ((1, 64), (3, 50), (2, 37), (3, 128)):
        B, N = 2, 3
        masks = rng.random((B, N, t, t)) > 0.3
        bgs = rng.uniform(0, 300, (B, C)).astype(np.float32)
        # all equal, at an integral background: the sums are exact, so the
        # std is 0 in both versions (not two different rounding residues)
        tiles = np.full((B, N, C, t, t), 1000, np.uint16)
        cases.append((f"all equal C={C} t={t}", tiles, masks,
                      np.full((B, C), 200.0, np.float32)))
        tiles = rng.integers(256, 512, (B, N, C, t, t)).astype(np.uint16)
        cases.append((f"one high-byte bin 256..511 C={C} t={t}", tiles, masks, bgs))
        tiles = rng.integers(0, 65536, (B, N, C, t, t)).astype(np.uint16)
        tiles[..., 0, :3] = [0, 65535, 65535]
        cases.append((f"0..65535 C={C} t={t}", tiles, masks, bgs))
        # n = 0, 1, 2 and 102 values with ranks on bin edges
        masks = np.zeros((1, 4, t, t), bool)
        tiles = rng.integers(0, 65536, (1, 4, C, t, t)).astype(np.uint16)
        for i, n in ((1, 1), (2, 2)):
            masks[0, i] = _place(rng, n, t)
        masks[0, 3], tiles[0, 3] = _place(rng, 102, t, _edge_values(True), C,
                                          fill=9)
        cases.append((f"n=0,1,2 + bin-edge ranks C={C} t={t}", tiles, masks,
                      rng.uniform(0, 300, (1, C)).astype(np.float32)))
    return cases


def radix_cases_f32():
    """(name, frames (F, C, H, W) f32, masks (R, T, T) bool, offs (R, 3)
    int32, the moment rows to compare) numpy cases that stress the f32
    radix select, in both forms."""
    import numpy as np

    rng = np.random.default_rng(29)
    f = np.float32
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.17e-38,
                        -3.4e38, 3.4e38, np.inf, -np.inf, np.nan, 1.0, -1.0],
                       f)
    cases = []

    def stack(name, tiles, masks, moments=ROW_MOMENTS):
        R = len(masks)
        offs = np.stack([np.arange(R), np.zeros(R), np.zeros(R)], 1)
        cases.append((name, tiles, masks, offs.astype(np.int32), moments))

    def frame(name, img, masks, origins):
        offs = np.concatenate([np.zeros((len(origins), 1)), origins], 1)
        cases.append((name, img[None], masks, offs.astype(np.int32), ROW_MOMENTS))

    for C, T in ((1, 64), (3, 37), (3, 128)):
        R = 4
        masks = rng.random((R, T, T)) > 0.3
        stack(f"all equal C={C} T={T}", np.full((R, C, T, T), 3.25, f), masks)
        stack(f"one top-byte bin [2, 8) C={C} T={T}",
              rng.uniform(2.0, 8.0, (R, C, T, T)).astype(f), masks)
        mag = 10.0 ** rng.uniform(-44, 38, (R, C, T, T))
        wide = (mag * rng.choice([-1.0, 1.0], mag.shape)).astype(f)
        pick = rng.random(wide.shape) < 0.2
        wide[pick] = rng.choice(special, int(pick.sum()))
        # sums and squares of +-3.4e38 overflow in any order: the order
        # statistics, vmin, vmax and npx are what this case holds
        stack(f"-inf..+inf, subnormals, +-0 C={C} T={T}", wide, masks, ())
        masks = np.zeros((4, T, T), bool)
        tiles = rng.normal(0, 100, (4, C, T, T)).astype(f)
        for i, n in ((1, 1), (2, 2)):
            masks[i] = _place(rng, n, T)
        masks[3], tiles[3] = _place(rng, 102, T, _edge_values(False), C,
                                    fill=f(np.nan))
        stack(f"n=0,1,2 + bin-edge ranks C={C} T={T}", tiles, masks)
    # frame form: rows staged by cp.async (W, T and origins multiples of 4)
    # or read row by row (W = 101, T = 37, odd origins)
    for H, W, T, odd in ((120, 100, 36, False), (120, 100, 36, True),
                         (90, 101, 37, True)):
        img = rng.normal(50, 30, (3, H, W)).astype(f)
        img[rng.random(img.shape) < 0.02] = np.nan
        masks = rng.random((5, T, T)) > 0.4
        org = np.stack([rng.integers(0, H - T + 1, 5), rng.integers(0, W - T + 1, 5)], 1)
        org = org | 1 if odd else org & ~3
        frame(f"frame form H={H} W={W} T={T} {'odd' if odd else 'aligned'} origins",
              img, masks, np.minimum(org, [H - T, W - T]))
    return cases


def check_radix(device) -> dict:
    """The radix-select edge cases, both kernels, every variant."""
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk

    worst = {"max_abs_err": 0.0, "max_rel_err_moments": 0.0}
    n_cases = 0
    for name, tiles, masks, bgs in radix_cases_u16():
        tl, mk, bg = (torch.from_numpy(a).to(device) for a in (tiles, masks, bgs))
        want = tsk.packed_from_masks_plain(tl, mk, bg)
        for use_smem in (None, False):
            got = tsk.launch_packed(tl, mk, bg, use_smem=use_smem)
            torch.cuda.synchronize()
            err = compare_packed(got, want, f"tilestats {name} smem={use_smem}")
            for k in worst:
                worst[k] = max(worst[k], err[k])
            n_cases += 1
    for name, frames, masks, offs, moments in radix_cases_f32():
        fr, mk, of = (torch.from_numpy(a).to(device) for a in (frames, masks, offs))
        want = rsk.roi_stat_rows_plain(fr, mk, of)
        for opts in ({}, {"stage_mask": False}, {"use_smem": False}):
            got = rsk.roi_stat_rows(fr, mk, of, **opts)
            torch.cuda.synchronize()
            err = compare_packed(got.movedim(-1, 1), want.movedim(-1, 1),
                                 f"roistats {name} {opts}", ROW_EXACT, moments)
            for k in worst:
                worst[k] = max(worst[k], err[k])
            n_cases += 1
    worst["cases"] = n_cases
    return worst


# ------------------------------------------------------------------ dataset

def write_tiff_deflate(path: str, img, rows_per_strip: int = 64) -> None:
    """Baseline little-endian TIFF with Adobe-Deflate strips (zlib) of an
    (H, W) uint8, uint16 or float32 frame or an (H, W, 3) uint8 RGB one,
    numpy and stdlib only."""
    import numpy as np

    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    spp = img.shape[2] if img.ndim == 3 else 1
    raw = img.astype(img.dtype.newbyteorder("<")).tobytes()
    stride = w * spp * img.dtype.itemsize
    strips = [zlib.compress(raw[r * stride:(r + rows_per_strip) * stride], 6)
              for r in range(0, h, rows_per_strip)]
    n = len(strips)
    offs, pos = [], 8
    for s in strips:
        offs.append(pos)
        pos += len(s)
    arrays = pos                          # strip offsets, then byte counts
    bits_at = arrays + 8 * n              # BitsPerSample of an RGB frame
    ifd = bits_at + (2 * spp if spp > 1 else 0)
    bits = 8 * img.dtype.itemsize
    entries = [(256, 3, 1, w), (257, 3, 1, h),
               (258, 3, spp, bits if spp == 1 else bits_at), (259, 3, 1, 8),
               (262, 3, 1, 2 if spp == 3 else 1),
               (273, 4, n, arrays if n > 1 else offs[0]), (277, 3, 1, spp),
               (278, 3, 1, rows_per_strip),
               (279, 4, n, arrays + 4 * n if n > 1 else len(strips[0])),
               (284, 3, 1, 1), (339, 3, 1, 3 if img.dtype.kind == "f" else 1)]
    buf = bytearray(b"II" + struct.pack("<HI", 42, ifd))
    for s in strips:
        buf += s
    buf += struct.pack(f"<{n}I", *offs)
    buf += struct.pack(f"<{n}I", *[len(s) for s in strips])
    if spp > 1:
        buf += struct.pack(f"<{spp}H", *([bits] * spp))
    buf += struct.pack("<H", len(entries))
    for tag, typ, cnt, val in entries:
        inline_short = typ == 3 and cnt == 1
        fmt = "<HHIHH" if inline_short else "<HHII"
        buf += struct.pack(fmt, tag, typ, cnt, val, *((0,) if inline_short else ()))
    buf += struct.pack("<I", 0)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)


def write_tiff16_deflate(path: str, img, rows_per_strip: int = 64) -> None:
    """:func:`write_tiff_deflate` of a frame as uint16."""
    write_tiff_deflate(path, img.astype("<u2"), rows_per_strip)


def write_png_gray(path: str, img) -> None:
    """8-bit grayscale PNG of an (H, W) uint8 array, stdlib only."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].astype("u1").tobytes() for r in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def bench_polys():
    """The benchmark's 18-circle ROI set (bench.py without golden ROIs)."""
    return [_circle(150 + 200 * (i % 8), 150 + 300 * (i // 8), ROI_RADIUS)
            for i in range(N_ROI)]


def make_dataset(folder: str, n_stages: int = N_STAGES, shape=(H, W),
                 seed: int = 42) -> str:
    """Write the bench-shaped experiment: blobs + noise u16 frames (LZW
    through PIL when it is installed, as the benchmark writes them, else
    Deflate) and one ROI JSON per stage.  Returns the compression used."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        Image = None
    h, w = shape
    os.makedirs(os.path.join(folder, "roi"), exist_ok=True)
    rng = np.random.default_rng(seed)
    for s in range(1, n_stages + 1):
        for ch in CHANNELS:
            img = rng.normal(120, 15, (h, w)).astype(np.float32)
            for _ in range(20):
                cy, cx = rng.integers(100, h - 100), rng.integers(100, w - 100)
                r = int(rng.integers(20, 60))
                y0, y1 = max(0, cy - 4 * r), min(h, cy + 4 * r)
                x0, x1 = max(0, cx - 4 * r), min(w, cx + 4 * r)
                yy, xx = np.mgrid[y0:y1, x0:x1]
                img[y0:y1, x0:x1] += 3000.0 * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * r * r))
            img = img.clip(0, 65535).astype(np.uint16)
            path = os.path.join(folder, f"S{s:02d}_{ch}.TIF")
            if Image is not None:
                Image.fromarray(img).save(path, format="TIFF",
                                          compression="tiff_lzw")
            else:
                write_tiff16_deflate(path, img)
        with open(os.path.join(folder, "roi", f"S{s:02d}.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"name": f"S{s:02d}",
                       "image_shape": {"height": h, "width": w},
                       "rois": [p.tolist() for p in bench_polys()]}, f)
    return "lzw" if Image is not None else "deflate"


# ------------------------------------------------------------------ main path

def reference_rows(folder: str, stage: str, roi_ids):
    """numpy reference for a few ROIs of one stage: decode each frame on
    its own, rasterize each polygon in its tile on the CPU (the runner's
    tile placement: free-float vertices rasterize shift-exactly only on
    the half-integer lattice), take the background as np.percentile of
    every 4th pixel, then mean / std / np.percentile over the corrected
    masked pixels."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch import native
    from imageprocess_tpu_torch.geom.rasterize import rasterize_polygons
    from imageprocess_tpu_torch.ops.roistats import (
        choose_tile, pad_local_polys, tile_offsets,
    )

    polys = bench_polys()
    sel = [polys[i - 1] for i in roi_ids]
    t = choose_tile(polys, H, W)
    offs = tile_offsets(sel, H, W, t)
    lp, _, _ = pad_local_polys(sel, offs, len(sel), 32)
    masks = rasterize_polygons(torch.from_numpy(lp), (t, t)).numpy()
    out = {}
    for ch in CHANNELS:
        img = native.decode_tiff(os.path.join(folder, f"{stage}_{ch}.TIF"))
        bg = np.float32(np.percentile(img.ravel()[::4].astype(np.float64), 1.0))
        xf = np.maximum(img.astype(np.float32) - bg, 0)
        for j, i in enumerate(roi_ids):
            oy, ox = offs[j]
            v = xf[oy:oy + t, ox:ox + t][masks[j]].astype(np.float64)
            out[(i, ch)] = {"mean": v.mean(), "std": v.std(),
                            "median": np.percentile(v, 50),
                            "p5": np.percentile(v, 5),
                            "p95": np.percentile(v, 95),
                            "vsum": v.sum(), "npx": v.size,
                            "area_px": int(masks[j].sum()), "bg": float(bg)}
    return out


def run_main_path(folder: str, device: str, reps: int = 3) -> dict:
    import torch

    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
    from imageprocess_tpu_torch.parallel import runner
    from imageprocess_tpu_torch.pipelines.intensity import (
        IntensityConfig, run_intensity_batched,
    )

    cfg = IntensityConfig(channels=CHANNELS,
                          channel_colors={2: "Green", 3: "Red"}, do_xls=True)
    out_root = os.path.join(folder, "RES_smoke")
    workers = max(8, (os.cpu_count() or 1) * 2)
    mpix = N_STAGES * len(CHANNELS) * H * W / 1e6
    logs = []

    def one_run():
        return run_intensity_batched(folder, cfg, out_root=out_root,
                                     log=logs.append, batch_size=4,
                                     prefetch_workers=workers, device=device)

    # checked run: every chunk's kernel output vs the plain version on the
    # same device tensors (outside the launch count: the plain version
    # launches no kernel)
    real_step = runner.batched_tile_stats_step
    chunks, errs, shapes = [], [], []

    def checked_step(tiles, lp, valid, bgs, *, clip_neg=True):
        out = real_step(tiles, lp, valid, bgs, clip_neg=clip_neg)
        want = tsk.tile_stats_packed_plain(tiles, lp, valid, bgs,
                                           clip_neg=clip_neg)
        errs.append(compare_packed(out, want, f"chunk {len(chunks)}"))
        chunks.append(tuple(tiles.shape))
        shapes.append((tiles, lp, valid, bgs))
        return out

    runner.batched_tile_stats_step = checked_step
    tsk.reset_launches()
    t0 = time.perf_counter()
    try:
        rows = one_run()
    finally:
        runner.batched_tile_stats_step = real_step
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    launches = tsk.launches["tilestats_u16"]
    if len(rows) != N_STAGES * N_ROI:
        raise SmokeError(f"{len(rows)} rows, want {N_STAGES * N_ROI}: "
                         f"{logs[-5:]}")
    if launches != len(chunks) or launches == 0:
        raise SmokeError(f"kernel launches {launches} != chunks {len(chunks)}")
    errors = [line for line in logs if "ERROR" in str(line) or "오류" in str(line)]
    if errors:
        raise SmokeError(f"runner logged errors: {errors[:3]}")
    stat_cols = [f"ch{ch}_{f}" for ch in CHANNELS
                 for f in ("mean", "median", "std", "p5", "p95", "vmin",
                           "vmax", "vsum")]
    for r in rows:
        if not all(math.isfinite(r[c]) for c in stat_cols):
            raise SmokeError(f"non-finite stats in row {r['stage']} {r['roi']}")
    for name in ("fluor_intensity_perROI.csv", "fluor_intensity_perROI.xlsx"):
        if not os.path.exists(os.path.join(out_root, "xls", name)):
            raise SmokeError(f"{name} was not written")
    # independent numpy reference on a few ROIs of two stages
    by_key = {(r["stage"], r["roi"]): r for r in rows}
    ref_rel = 0.0
    for stage in ("S01", f"S{N_STAGES:02d}"):
        ref = reference_rows(folder, stage, (1, 9, 18))
        for (i, ch), want in ref.items():
            r = by_key[(stage, i)]
            if r["area_px"] != want["area_px"] or r[f"ch{ch}_npx"] != want["npx"]:
                raise SmokeError(f"{stage} roi {i}: area/npx differ from numpy")
            if r[f"ch{ch}_bg"] != want["bg"]:
                raise SmokeError(f"{stage} ch{ch}: bg {r[f'ch{ch}_bg']} != "
                                 f"numpy {want['bg']}")
            for f in ("mean", "std", "median", "p5", "p95", "vsum"):
                a, b = r[f"ch{ch}_{f}"], want[f]
                rel = abs(a - b) / max(abs(b), 1e-9)
                ref_rel = max(ref_rel, rel)
                if rel > REL_TOL:
                    raise SmokeError(f"{stage} roi {i} ch{ch} {f}: {a} vs "
                                     f"numpy {b} ({rel:.2e} rel)")
    # timed runs (no check wrapper)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rows2 = one_run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(rows2) != len(rows):
            raise SmokeError("timed run lost rows")
    return {
        "rows": len(rows), "chunks": chunks, "launches": launches,
        "warm_s": warm, "steady_s": min(times), "times_s": times,
        "warm_mpix_s": mpix / warm, "steady_mpix_s": mpix / min(times),
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "max_rel_err_moments": max(e["max_rel_err_moments"] for e in errs),
        "numpy_ref_max_rel": ref_rel,
        "sample_inputs": shapes[0], "row_list": rows,
    }


def fret_reference_rows(folder: str, stage: str, roi_ids):
    """numpy reference for a few ROIs of one stage (float64): bg =
    np.percentile of the whole frame at 1.0 (no stride), corrected values
    clipped at 0, eps = max(5, np.percentile of the whole corrected donor
    at 1.0), ratio = (acceptor + eps) / (donor + eps), then mean, median,
    std, p5 and p95 over each ROI's pixels (masks rasterized in their
    tiles, as in ``reference_rows``)."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch import native
    from imageprocess_tpu_torch.geom.rasterize import rasterize_polygons
    from imageprocess_tpu_torch.ops.roistats import (
        choose_tile, pad_local_polys, tile_offsets,
    )

    polys = bench_polys()
    sel = [polys[i - 1] for i in roi_ids]
    t = choose_tile(polys, H, W)
    offs = tile_offsets(sel, H, W, t)
    lp, _, _ = pad_local_polys(sel, offs, len(sel), 32)
    masks = rasterize_polygons(torch.from_numpy(lp), (t, t)).numpy()
    corr = {}
    for ch in CHANNELS:
        img = native.decode_tiff(os.path.join(folder, f"{stage}_{ch}.TIF"))
        img = img.astype(np.float64)
        corr[ch] = np.maximum(img - np.percentile(img.ravel(), 1.0), 0.0)
    d, a = corr[CHANNELS[0]], corr[CHANNELS[1]]
    eps = max(5.0, float(np.percentile(d.ravel(), 1.0)))
    ratio = (a + eps) / (d + eps)
    out = {}
    for j, i in enumerate(roi_ids):
        oy, ox = offs[j]

        def vals(x):
            return x[oy:oy + t, ox:ox + t][masks[j]]

        r, dv, av = vals(ratio), vals(d), vals(a)
        out[i] = {"area_px": int(masks[j].sum()), "eps": eps,
                  "ratio_mean": r.mean(), "ratio_median": np.median(r),
                  "ratio_std": r.std(), "ratio_p5": np.percentile(r, 5),
                  "ratio_p95": np.percentile(r, 95),
                  "donor_mean": dv.mean(), "donor_median": np.median(dv),
                  "yfret_mean": av.mean(), "yfret_median": np.median(av)}
    return out


def run_fret_main_path(folder: str, device: str, reps: int = 3) -> dict:
    """The FRET tables runner on the smoke dataset (channels 2/3 as
    donor/acceptor, batch_size=4): one checked run, then *reps* timed."""
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.parallel import runner
    from imageprocess_tpu_torch.pipelines.fret import FretConfig, run_fret_batched

    cfg = FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1], do_xls=True)
    out_root = os.path.join(folder, "RES_fret")
    workers = max(8, (os.cpu_count() or 1) * 2)
    mpix = N_STAGES * 2 * H * W / 1e6
    logs = []

    def one_run():
        return run_fret_batched(folder, cfg, out_root=out_root,
                                log=logs.append, batch_size=4,
                                prefetch_workers=workers, device=device)

    # checked run: every chunk's kernel output vs the plain version on the
    # same device tensors (the plain version launches no kernel)
    real_step = runner.batched_fret_tile_stats_step
    chunks, errs, inputs = [], [], []

    def checked_step(tiles, lp, valid, bgs, eps, *, clip_neg=True, flip=False):
        out = real_step(tiles, lp, valid, bgs, eps, clip_neg=clip_neg, flip=flip)
        want = rsk.fret_tile_stats_packed_plain(tiles, lp, valid, bgs, eps,
                                                clip_neg=clip_neg, flip=flip)
        errs.append(compare_packed(out, want, f"FRET chunk {len(chunks)}"))
        chunks.append(tuple(tiles.shape))
        inputs.append((tiles, lp, valid, bgs, eps))
        return out

    runner.batched_fret_tile_stats_step = checked_step
    rsk.reset_launches()
    try:
        rows = one_run()
    finally:
        runner.batched_fret_tile_stats_step = real_step
    torch.cuda.synchronize()
    launches = rsk.launches["roistats_f32"]
    if len(rows) != N_STAGES * N_ROI:
        raise SmokeError(f"FRET: {len(rows)} rows, want {N_STAGES * N_ROI}: "
                         f"{logs[-5:]}")
    if launches != len(chunks) or launches == 0:
        raise SmokeError(f"FRET: kernel launches {launches} != chunks {len(chunks)}")
    errors = [line for line in logs if "ERROR" in str(line) or "오류" in str(line)]
    if errors:
        raise SmokeError(f"FRET runner logged errors: {errors[:3]}")
    stat_cols = ["ratio_mean", "ratio_median", "ratio_std", "ratio_p5",
                 "ratio_p95", "donor_mean", "donor_median", "yfret_mean",
                 "yfret_median", "eps"]
    for r in rows:
        if not all(math.isfinite(r[c]) for c in stat_cols):
            raise SmokeError(f"FRET: non-finite stats in row {r['stage']} {r['roi']}")
    for name in ("fret_ratio_perROI.csv", "fret_ratio_perROI.xlsx"):
        if not os.path.exists(os.path.join(out_root, "xls", name)):
            raise SmokeError(f"{name} was not written")
    by_key = {(r["stage"], r["roi"]): r for r in rows}
    ref_rel = 0.0
    for stage in ("S01", f"S{N_STAGES:02d}"):
        for i, want in fret_reference_rows(folder, stage, (1, 9, 18)).items():
            r = by_key[(stage, i)]
            if r["area_px"] != want["area_px"]:
                raise SmokeError(f"FRET {stage} roi {i}: area differs from numpy")
            for f in stat_cols:
                a, b = r[f], want[f]
                rel = abs(a - b) / max(abs(b), 1e-9)
                ref_rel = max(ref_rel, rel)
                if rel > REL_TOL:
                    raise SmokeError(f"FRET {stage} roi {i} {f}: {a} vs numpy "
                                     f"{b} ({rel:.2e} rel)")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rows2 = one_run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(rows2) != len(rows):
            raise SmokeError("FRET: timed run lost rows")
    return {
        "rows": len(rows), "chunks": chunks, "launches": launches,
        "warm_s": times[0], "steady_s": min(times), "times_s": times,
        "warm_mpix_s": mpix / times[0], "steady_mpix_s": mpix / min(times),
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "max_rel_err_moments": max(e["max_rel_err_moments"] for e in errs),
        "numpy_ref_max_rel": ref_rel,
        "sample_inputs": inputs[0], "row_list": rows,
    }


def time_host_decode(folder: str, workers: int) -> float:
    """Wall seconds of the host's share alone: the fused native decode +
    histogram + tile cut of every key, on the runner's thread count (best
    of two)."""
    import concurrent.futures as cf

    import numpy as np

    from imageprocess_tpu_torch import native
    from imageprocess_tpu_torch.ops.roistats import choose_tile, tile_offsets

    polys = bench_polys()
    t = choose_tile(polys, H, W)
    offs = np.asarray(tile_offsets(polys, H, W, t), np.int32)
    keys = [[os.path.join(folder, f"S{s:02d}_{ch}.TIF") for ch in CHANNELS]
            for s in range(1, N_STAGES + 1)]
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(workers) as pool:
            done = list(pool.map(lambda paths: native.decode_tiff_batch_hist_tiles(
                paths, 4, offs, t), keys))
        best = min(best, time.perf_counter() - t0)
        if any(d is None for d in done):
            raise SmokeError("native fused decode failed")
    return best


def check_serial_path(folder: str) -> int:
    """A small experiment whose third stage has another frame shape (so it
    takes the runner's per-key path) and a 16-bit key with ROIs of another
    size: rows on the card equal the rows of the same run on the CPU."""
    from imageprocess_tpu_torch.pipelines.intensity import (
        IntensityConfig, run_intensity_batched,
    )

    write_serial_experiment(folder)
    cfg = IntensityConfig(channels=CHANNELS, do_xls=False)
    rows = {dev: run_intensity_batched(folder, cfg, log=lambda *_: None,
                                       batch_size=2, device=dev)
            for dev in ("cuda", "cpu")}
    _rows_equal(rows["cuda"], rows["cpu"], "serial-path check",
                ("_mean", "_std", "_vsum"))
    return len(rows["cuda"])


def write_serial_experiment(folder: str) -> None:
    """Five stages of small frames, the third of another frame shape (so
    it takes the runners' per-key path), ROI counts 2/1/2/1/2."""
    import numpy as np

    rng = np.random.default_rng(5)
    os.makedirs(os.path.join(folder, "roi"), exist_ok=True)
    poly = [[15.5, 15.5], [60.5, 18.5], [55.5, 70.5], [12.5, 66.5]]
    for s, (h, w) in enumerate([(160, 192), (160, 192), (192, 160),
                                (160, 192), (160, 192)], 1):
        for ch in CHANNELS:
            write_tiff16_deflate(os.path.join(folder, f"S{s:02d}_{ch}.TIF"),
                                 rng.integers(10, 3000, (h, w)).astype("u2"))
        with open(os.path.join(folder, "roi", f"S{s:02d}.json"), "w") as f:
            json.dump({"rois": [poly, [[70, 40], [115, 45], [110, 85]]][:s % 2 + 1]}, f)


def _rows_equal(card, cpu, what: str, moments, n: int = 8) -> None:
    """Two runs' rows: *n* each, equal but for the *moments* columns
    (within REL_TOL relative); NaN where NaN."""
    if len(card) != n or len(cpu) != n:
        raise SmokeError(f"{what}: {len(card)} rows, then {len(cpu)}, want {n}")
    for a, b in zip(card, cpu):
        if list(a) != list(b):
            raise SmokeError(f"{what}: columns {list(a)} vs {list(b)}")
        for k, v in b.items():
            if isinstance(v, float) and math.isnan(v):
                if not (isinstance(a[k], float) and math.isnan(a[k])):
                    raise SmokeError(f"{what}: {k} {a[k]!r} vs NaN")
            elif isinstance(v, float) and k.endswith(moments):
                if abs(a[k] - v) > REL_TOL * max(abs(v), 1e-9):
                    raise SmokeError(f"{what}: {k} {a[k]} vs {v}")
            elif a[k] != v:
                raise SmokeError(f"{what}: {a.get('stage')} roi {a.get('roi')} "
                                 f"{k} {a[k]!r} vs {v!r}")


def check_fret_serial_path(folder: str) -> int:
    """The FRET runner on the same kind of small experiment: rows on the
    card equal the rows of the same run on the CPU."""
    from imageprocess_tpu_torch.pipelines.fret import FretConfig, run_fret_batched

    write_serial_experiment(folder)
    cfg = FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1], do_xls=False)
    rows = {dev: run_fret_batched(folder, cfg, log=lambda *_: None, batch_size=2,
                                  device=dev) for dev in ("cuda", "cpu")}
    _rows_equal(rows["cuda"], rows["cpu"], "FRET serial-path check",
                ("_mean", "_std"))
    return len(rows["cuda"])


# ------------------------------------------------------------------ serial paths

class CheckedRoiRows:
    """While active, every ``roistats_f32`` launch of ``ops.roistats``
    (the tiles of ``roi_stats_tiled``, the whole frames of
    ``roi_stats_full``) is held to the plain version on the same device
    tensors (outside the launch count: the plain version launches no
    kernel); the inputs of the first launch of each mask shape (``first``)
    and of each (channels, mask shape) (``by_launch``) are kept for the
    timings."""

    def __init__(self, what: str):
        from imageprocess_tpu_torch.ops import roistats as trs

        self.trs, self.what = trs, what
        self.real = trs.roi_stat_rows
        self.errs, self.first, self.by_launch = [], {}, {}

    def __enter__(self):
        from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk

        def checked(frames, masks, offs):
            out = self.real(frames, masks, offs)
            if frames.is_cuda:
                want = rsk.roi_stat_rows_plain(frames, masks, offs)
                self.errs.append(compare_packed(
                    out.movedim(-1, 1), want.movedim(-1, 1),
                    f"{self.what} launch {len(self.errs)} {tuple(masks.shape)}",
                    ROW_EXACT, ROW_MOMENTS))
                self.first.setdefault(tuple(masks.shape), (frames, masks, offs))
                self.by_launch.setdefault((frames.shape[1], tuple(masks.shape)),
                                          (frames, masks, offs))
            return out

        self.trs.roi_stat_rows = checked
        return self

    def __exit__(self, *exc):
        self.trs.roi_stat_rows = self.real

    def worst(self) -> dict:
        return {k: max((e[k] for e in self.errs), default=0.0)
                for k in ("max_abs_err", "max_rel_err_moments")}


def run_serial_main_path(folder: str, device: str, runner: str, batched_rows,
                         reps: int = 2) -> dict:
    """A serial runner (``run_intensity`` or ``run_fret``) on the smoke
    dataset: a warm run, a checked run (every ``roistats_f32`` launch held
    to its plain version; the launch count set to 0 just before it and read
    just after), *reps* timed runs; its rows must equal the batched
    runner's (order statistics, backgrounds, eps, areas and npx exact,
    moments within REL_TOL)."""
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.pipelines import fret, intensity

    workers = max(8, (os.cpu_count() or 1) * 2)
    logs = []
    if runner == "intensity":
        cfg = intensity.IntensityConfig(channels=CHANNELS,
                                        channel_colors={2: "Green", 3: "Red"})
        out_root, moments = os.path.join(folder, "RES_serial"), ("_mean", "_std", "_vsum")

        def one_run():
            return intensity.run_intensity(folder, cfg, out_root=out_root,
                                           log=logs.append, prefetch_workers=workers,
                                           device=device)
        report = ("fluor_intensity_perROI.csv", "fluor_intensity_perROI.xlsx")
    else:
        cfg = fret.FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1])
        out_root, moments = os.path.join(folder, "RES_serial_fret"), ("_mean", "_std")

        def one_run():
            return fret.run_fret(folder, cfg, out_root=out_root, log=logs.append,
                                 prefetch_workers=workers, device=device)
        report = ("fret_ratio_perROI.csv", "fret_ratio_perROI.xlsx")
    mpix = N_STAGES * len(CHANNELS) * H * W / 1e6
    t0 = time.perf_counter()
    one_run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rsk.reset_launches()
    with CheckedRoiRows(f"serial {runner}") as chk:
        rows = one_run()
    torch.cuda.synchronize()
    launches = rsk.launches["roistats_f32"]
    if launches != N_STAGES or len(chk.errs) != N_STAGES:
        raise SmokeError(f"serial {runner}: {launches} roistats_f32 launches, "
                         f"{len(chk.errs)} checked, want {N_STAGES}")
    errors = [line for line in logs if "ERROR" in str(line) or "오류" in str(line)]
    if errors:
        raise SmokeError(f"serial {runner} logged errors: {errors[:3]}")
    for name in report:
        if not os.path.exists(os.path.join(out_root, "xls", name)):
            raise SmokeError(f"serial {runner}: {name} was not written")
    _rows_equal(rows, batched_rows, f"serial {runner} vs batched", moments,
                N_STAGES * N_ROI)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        again = one_run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(again) != len(rows):
            raise SmokeError(f"serial {runner}: a timed run lost rows")
    return {"rows": len(rows), "launches": launches, "warm_s": warm,
            "steady_s": min(times), "times_s": times, "warm_mpix_s": mpix / warm,
            "steady_mpix_s": mpix / min(times), "key_inputs": chk.first,
            "profile": profile_run(one_run), **chk.worst()}


def profile_run(fn, top: int = 8) -> dict:
    """One call of *fn* under ``torch.profiler`` (CPU and CUDA activities):
    its wall seconds, the device time (the union of the kernel and copy
    intervals, so overlaps count once), the device's idle share of the
    wall, and the *top* kernel and copy names by summed device time.
    Annotation ranges on the device's timeline (``Optimizer.step#...``)
    are not kernels and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall, "device_ms": busy_ms, "events": len(spans),
            "idle_share": 1.0 - busy_ms / (wall * 1e3),
            "top": [(n[:60], round(ms, 4)) for n, ms in names]}


# ------------------------------------------------------------------ rim FRET, morphology

N2_PX_UM, N2_RIM_UM = 0.223, 1.0     # rim 4 px
N2_CONFIGS = {  # name: (Nesprin2Config options, roistats_f32 launches per pair or chunk)
    "annulus off": ({}, 1),
    "annulus on + QC": (dict(annulus_on=True, ann_in_um=0.9, ann_out_um=1.8,
                             sat_filter_on=True, sat_threshold=2500.0,
                             clip_ratio_on=True, clip_ratio_max=3.0), 2),
}
N2_MOMENTS = ("_mean", "_std")


def n2_config(name: str, **kw):
    from imageprocess_tpu_torch.pipelines.nesprin2 import Nesprin2Config

    return Nesprin2Config(donor_ch=CHANNELS[0], fret_ch=CHANNELS[1], px_um=N2_PX_UM,
                          rim_um=N2_RIM_UM, **N2_CONFIGS[name][0], **kw)


def nesprin2_reference_rows(folder: str, stage: str, cfg) -> list:
    """numpy / scipy replica of the reference rim-FRET math for one pair,
    in float64: saturation -> NaN, each channel's background np.percentile
    of its finite pixels, clip at 0, eps = max(eps_abs, np.percentile of
    the finite corrected donor inside the union), the ratio and its clip ->
    NaN, the rim from ``scipy.ndimage.distance_transform_edt`` of the
    union, and per ROI the annulus (``binary_dilation`` with squares)
    ``np.nanmedian`` backgrounds, the re-ratio and the statistics over the
    finite pixels of mask & rim.  The masks are the port's own rasterizer
    output on the CPU (the union on the full frame, each ROI in its tile, as
    the runner places them)."""
    import numpy as np
    import scipy.ndimage as ndi
    import torch

    from imageprocess_tpu_torch import native
    from imageprocess_tpu_torch.geom.polygon import pad_polygons
    from imageprocess_tpu_torch.geom.rasterize import rasterize_polygons
    from imageprocess_tpu_torch.ops.roistats import (
        choose_tile, pad_local_polys, tile_offsets,
    )

    polys = bench_polys()
    D, A = (native.decode_tiff(os.path.join(folder, f"{stage}_{ch}.TIF"))
            .astype(np.float64) for ch in CHANNELS)
    if cfg.sat_filter_on:
        sat = (D >= cfg.sat_threshold) | (A >= cfg.sat_threshold)
        D[sat] = np.nan
        A[sat] = np.nan
    pv = pad_polygons([np.asarray(p, np.float32) for p in polys], 32)
    union = rasterize_polygons(torch.from_numpy(pv), (H, W)).any(dim=0).numpy()
    margin = cfg.ann_out_px + 1 if cfg.annulus_on else 0
    t = choose_tile(polys, H, W, margin=margin)
    offs = tile_offsets(polys, H, W, t, margin=margin)
    lp, _, _ = pad_local_polys(polys, offs, len(polys), 32)
    masks = rasterize_polygons(torch.from_numpy(lp), (t, t)).numpy()

    def bgc(img):
        return np.maximum(img - np.percentile(img[np.isfinite(img)], cfg.percentile), 0.0)

    Dc, Ac = bgc(D), bgc(A)
    eps = max(cfg.eps_abs, float(np.percentile(Dc[union & np.isfinite(Dc)],
                                               cfg.eps_percentile)))

    def ratio(n, d):
        r = (n + eps) / (d + eps)
        return np.where(r > cfg.clip_ratio_max, np.nan, r) if cfg.clip_ratio_on else r

    R, R_alt = ratio(Ac, Dc), ratio(Dc, Ac)
    dist = ndi.distance_transform_edt(union)
    rim = (dist > 0) & (dist <= cfg.rim_px)

    def square(k):
        return np.ones((2 * k + 1, 2 * k + 1), bool)

    def nanmed(v):
        return float(np.nanmedian(v)) if np.isfinite(v).any() else 0.0

    rows = []
    for i, m in enumerate(masks):
        sl = (slice(offs[i, 0], offs[i, 0] + t), slice(offs[i, 1], offs[i, 1] + t))
        roi_mask = m & rim[sl]
        r_roi, r_alt = R[sl], R_alt[sl]
        if cfg.annulus_on:
            ann = ndi.binary_dilation(m, square(cfg.ann_out_px)) & \
                ~ndi.binary_dilation(m, square(cfg.ann_in_px))
            nc = np.maximum(Ac[sl] - nanmed(Ac[sl][ann]), 0.0)
            dc = np.maximum(Dc[sl] - nanmed(Dc[sl][ann]), 0.0)
            r_roi, r_alt = ratio(nc, dc), ratio(dc, nc)
        v = r_roi[roi_mask]
        v = v[np.isfinite(v)]
        rows.append({
            "area_px": int(roi_mask.sum()), "npx": int(v.size), "eps": eps,
            "ratio_mean": v.mean(), "ratio_median": np.median(v), "ratio_std": v.std(),
            "ratio_p5": np.percentile(v, 5), "ratio_p95": np.percentile(v, 95),
            "ratio_DoverF_mean": np.nanmean(r_alt[roi_mask]),
            "donor_mean": np.nanmean(Dc[sl][roi_mask]),
            "fret_mean": np.nanmean(Ac[sl][roi_mask])})
    return rows


def run_nesprin2_paths(folder: str, device: str, name: str, reps: int = 2) -> dict:
    """``run_nesprin2`` and ``run_nesprin2_batched(batch_size=4)`` on the
    smoke dataset under one config of ``N2_CONFIGS``.  Serial: a warm run,
    a checked run (every ``roistats_f32`` launch held to its plain version,
    the count set to 0 just before it and read just after), *reps* timed
    runs, one run under ``torch.profiler``; the rows of the first and the
    last pair against the same runner on the CPU, and stage S01 against the
    numpy / scipy replica at 1e-4 relative.  Batched: a checked run whose
    rows must equal the serial rows exactly, *reps* timed runs."""
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.pipelines import nesprin2

    per, n_rows = N2_CONFIGS[name][1], N_STAGES * N_ROI
    cfg = n2_config(name)
    mpix = N_STAGES * 2 * H * W / 1e6
    logs = []
    runners = {
        "serial": lambda: nesprin2.run_nesprin2(
            folder, cfg, out_root=os.path.join(folder, "RES_n2"), log=logs.append,
            device=device),
        "batched": lambda: nesprin2.run_nesprin2_batched(
            folder, cfg, out_root=os.path.join(folder, "RES_n2_batched"),
            log=logs.append, batch_size=4,
            prefetch_workers=max(8, (os.cpu_count() or 1) * 2), device=device)}
    out = {}
    for kind, one_run in runners.items():
        t0 = time.perf_counter()
        one_run()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        rsk.reset_launches()
        with CheckedRoiRows(f"nesprin2 {kind} ({name})") as chk:
            rows = one_run()
        torch.cuda.synchronize()
        launches = rsk.launches["roistats_f32"]
        want = per * (N_STAGES if kind == "serial" else N_STAGES // 4)
        if launches != want or len(chk.errs) != want:
            raise SmokeError(f"nesprin2 {kind} ({name}): {launches} roistats_f32 "
                             f"launches, {len(chk.errs)} checked, want {want}")
        errors = [line for line in logs if "ERROR" in str(line) or "오류" in str(line)]
        if errors:
            raise SmokeError(f"nesprin2 {kind} ({name}) logged errors: {errors[:3]}")
        if len(rows) != n_rows:
            raise SmokeError(f"nesprin2 {kind} ({name}): {len(rows)} rows, want {n_rows}")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = one_run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if len(again) != n_rows:
                raise SmokeError(f"nesprin2 {kind} ({name}): a timed run lost rows")
        out[kind] = {"rows": rows, "launches": launches, "warm_s": warm,
                     "steady_s": min(times), "times_s": times,
                     "warm_mpix_s": mpix / warm, "steady_mpix_s": mpix / min(times),
                     "inputs": chk.by_launch, **chk.worst()}
    serial = out["serial"]["rows"]
    _rows_equal(out["batched"]["rows"], serial, f"nesprin2 batched vs serial ({name})",
                (), n_rows)
    for stem in ("RES_n2", "RES_n2_batched"):
        for ext in ("csv", "xlsx"):
            if not os.path.exists(os.path.join(folder, stem, "xls",
                                               f"nesprin2_fret_perROI.{ext}")):
                raise SmokeError(f"nesprin2 ({name}): {stem}/xls/...{ext} not written")
    area, npx_ref = sum(r["area_px"] for r in serial), 0
    # QC may leave an ROI's rim without a finite ratio (a NaN row, equal on
    # the card and in the plain version); without QC every row is finite
    stat_cols = ("ratio_mean", "ratio_median", "ratio_p95", "donor_mean")
    nan_rows = sum(not all(math.isfinite(r[c]) for c in stat_cols) for r in serial)
    if nan_rows > (n_rows // 4 if cfg.sat_filter_on or cfg.clip_ratio_on else 0) \
            or not all(math.isfinite(r["eps"]) and r["area_px"] > 0 for r in serial):
        raise SmokeError(f"nesprin2 ({name}): {nan_rows} rows with non-finite "
                         "statistics, or a non-finite eps or an empty rim")
    # the card against the CPU, first and last pair
    for stage in (1, N_STAGES):
        cpu = nesprin2.run_nesprin2(folder, n2_config(name, subset_stage=stage,
                                                      do_xls=False),
                                    log=lambda *_: None, device="cpu")
        card = [r for r in serial if r["stage"] == f"S{stage:02d}"]
        _rows_equal(card, cpu, f"nesprin2 card vs CPU ({name}) S{stage:02d}",
                    N2_MOMENTS, N_ROI)
    # the numpy / scipy replica, one pair
    ref_rel = 0.0
    ref = nesprin2_reference_rows(folder, "S01", cfg)
    for r, want_row in zip(serial[:N_ROI], ref):
        if r["area_px"] != want_row["area_px"]:
            raise SmokeError(f"nesprin2 ({name}) S01 roi {r['roi']}: area "
                             f"{r['area_px']} vs replica {want_row['area_px']}")
        npx_ref += want_row["npx"]
        for k, b in want_row.items():
            if k in ("area_px", "npx"):
                continue
            if math.isnan(b) and math.isnan(r[k]):
                continue
            rel = abs(r[k] - b) / max(abs(b), 1e-9)
            ref_rel = max(ref_rel, rel)
            if not rel <= 1e-4:
                raise SmokeError(f"nesprin2 ({name}) S01 roi {r['roi']} {k}: {r[k]} vs "
                                 f"replica {b} ({rel:.2e} rel)")
    area_s01 = sum(r["area_px"] for r in serial[:N_ROI])
    if cfg.sat_filter_on and not npx_ref < area_s01:
        raise SmokeError(f"nesprin2 ({name}): the QC thresholds removed no pixel")
    pr = profile_run(runners["serial"])
    return {"serial": out["serial"], "batched": out["batched"], "profile": pr,
            "replica_max_rel": ref_rel, "rim_px_total": area, "nan_rows": nan_rows,
            "s01_rim_px": area_s01, "s01_finite_px": npx_ref, "tile": next(
                iter(out["serial"]["inputs"]))[1][-1]}


MOR_CLOSE = ("area_um2", "major_um", "minor_um", "aspect_ratio", "roundness",
             "centroid_x", "centroid_y", "circularity", "solidity")


def run_morphology_path(folder: str, device: str, reps: int = 2) -> dict:
    """``run_morphology`` (tables only, channel 2) on the smoke dataset: 288
    rows on the card against the same run on the CPU (areas and the vertex
    math exact, what derives from the moment sums within REL_TOL; the
    orientation of these circles is the direction of a near-null axis and
    is left out), ``area_px`` against the rasterizer's own tile masks, the
    report files, and *reps* timed runs."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.geom.rasterize import rasterize_polygons
    from imageprocess_tpu_torch.ops.roistats import (
        choose_tile, pad_local_polys, tile_offsets,
    )
    from imageprocess_tpu_torch.pipelines import morphology

    cfg = morphology.MorConfig(px_um=N2_PX_UM, sel_ch=CHANNELS[0], save_full=False,
                               save_crop=False)
    out_root = os.path.join(folder, "RES_MOR_smoke")
    logs = []

    def one_run(dev=device):
        return morphology.run_morphology(folder, cfg, out_root=out_root,
                                         log=logs.append, device=dev)

    t0 = time.perf_counter()
    rows = one_run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    cpu = one_run("cpu")
    n_rows = N_STAGES * N_ROI
    if len(rows) != n_rows or len(cpu) != n_rows:
        raise SmokeError(f"morphology: {len(rows)} rows, {len(cpu)} on the CPU, "
                         f"want {n_rows}: {logs[-3:]}")
    polys = bench_polys()
    t = choose_tile(polys, H, W)
    lp, _, _ = pad_local_polys(polys, tile_offsets(polys, H, W, t), N_ROI, 32)
    counts = rasterize_polygons(torch.from_numpy(lp), (t, t)).sum(dim=(1, 2)).tolist()
    worst = 0.0
    for a, b in zip(rows, cpu):
        if list(a) != list(b):
            raise SmokeError(f"morphology: columns {list(a)} vs {list(b)}")
        if a["area_px"] != b["area_px"] or a["area_px"] != counts[a["roi"] - 1]:
            raise SmokeError(f"morphology {a['stage']} roi {a['roi']}: area "
                             f"{a['area_px']}, CPU {b['area_px']}, mask "
                             f"{counts[a['roi'] - 1]}")
        for k, v in b.items():
            if k == "orientation_deg":
                continue
            if k in MOR_CLOSE:
                rel = abs(a[k] - v) / max(abs(v), 1e-9)
                worst = max(worst, rel)
                if not rel <= REL_TOL:
                    raise SmokeError(f"morphology {a['stage']} roi {a['roi']} {k}: "
                                     f"{a[k]} vs CPU {v} ({rel:.2e} rel)")
            elif a[k] != v:
                raise SmokeError(f"morphology {a['stage']} roi {a['roi']} {k}: "
                                 f"{a[k]!r} vs CPU {v!r}")
    if not np.isfinite([r[k] for r in rows for k in MOR_CLOSE]).all():
        raise SmokeError("morphology: non-finite metrics")
    for ext in ("csv", "xlsx"):
        if not os.path.exists(os.path.join(out_root, "xls", f"morphology_perROI.{ext}")):
            raise SmokeError(f"morphology_perROI.{ext} was not written")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        one_run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"rows": len(rows), "warm_s": warm, "times_s": times,
            "steady_s": min(times), "max_rel": worst, "profile": profile_run(one_run)}


BIG_ROI = 600      # px across: choose_tile gives 608, the device-memory variant


def write_variant_experiment(folder: str) -> dict:
    """``write_serial_experiment`` plus one key per case the serial
    runners take: a PNG union mask (S06), no ROI (S07), a 600-px ROI beside
    a small one on a 640 x 800 frame (S08), a full-frame ROI beside a
    small one (S09), 8-bit (S10), float32 with NaN (S11) and RGB (S12)
    frames.  Returns the rows each runner must give (skip_no_roi=False)."""
    import numpy as np

    write_serial_experiment(folder)
    rng = np.random.default_rng(9)
    small = [[15.5, 15.5], [60.5, 18.5], [55.5, 70.5], [12.5, 66.5]]
    h, w = 160, 192
    whole = [[-3, -3], [w + 3, -3], [w + 3, h + 3], [-3, h + 3]]
    keys = {6: ("u16", "png"), 7: ("u16", None),
            8: ("big", [_circle(400.0, 320.0, BIG_ROI / 2 - 1, 64).tolist(), small]),
            9: ("u16", [whole, small]), 10: ("u8", [small]),
            11: ("f32", [small, [[70, 40], [115, 45], [110, 85]]]), 12: ("rgb", [small])}
    for s, (kind, rois) in keys.items():
        shape = (640, 800) if kind == "big" else (h, w)
        for ch in CHANNELS:
            if kind in ("u16", "big"):
                img = rng.integers(10, 3000, shape).astype("u2")
            elif kind == "u8":
                img = rng.integers(0, 256, shape).astype("u1")
            elif kind == "f32":
                img = rng.uniform(10.0, 3000.0, shape).astype("f4")
                img[rng.random(shape) < 0.03] = np.nan
            else:
                img = rng.integers(0, 256, shape + (3,)).astype("u1")
            write_tiff_deflate(os.path.join(folder, f"S{s:02d}_{ch}.TIF"), img)
        if rois == "png":
            m = np.zeros(shape, "u1")
            m[30:90, 40:120] = 255
            write_png_gray(os.path.join(folder, "roi", f"S{s:02d}.png"), m)
        elif rois is not None:
            with open(os.path.join(folder, "roi", f"S{s:02d}.json"), "w") as f:
                json.dump({"rois": rois}, f)
    return {"intensity": 18, "fret": 16}


def check_variant_paths(folder: str) -> dict:
    """Every bg_mode x bg_scope of ``run_intensity`` (skip_no_roi=False)
    and of ``run_fret`` (both ratio modes over the six) on the variant
    experiment: the card's rows equal the CPU's, and every launch equals
    its plain version."""
    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.pipelines import fret, intensity

    want = write_variant_experiment(folder)
    quiet = lambda *_: None  # noqa: E731
    launches, shapes = 0, set()
    with CheckedRoiRows("variant") as chk:
        for i, (mode, scope) in enumerate((m, s) for m in ("percentile", "hist-mode", "none")
                                          for s in ("full", "roi_union")):
            icfg = intensity.IntensityConfig(channels=CHANNELS, bg_mode=mode,
                                             bg_scope=scope, skip_no_roi=False,
                                             do_xls=False)
            fcfg = fret.FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1],
                                   bg_mode=mode, bg_scope=scope, do_xls=False,
                                   ratio_mode=("FRET/Donor", "Donor/FRET")[i % 2])
            rsk.reset_launches()
            card = intensity.run_intensity(folder, icfg, log=quiet, device="cuda")
            fcard = fret.run_fret(folder, fcfg, log=quiet, device="cuda")
            launches += rsk.launches["roistats_f32"]
            cpu = intensity.run_intensity(folder, icfg, log=quiet, device="cpu")
            fcpu = fret.run_fret(folder, fcfg, log=quiet, device="cpu")
            _rows_equal(card, cpu, f"variant intensity {mode} {scope}",
                        ("_mean", "_std", "_vsum"), want["intensity"])
            _rows_equal(fcard, fcpu, f"variant FRET {mode} {scope}",
                        ("_mean", "_std"), want["fret"])
        shapes = sorted(chk.first)
    return {"configs": 6, "launches": launches, "tile_shapes": shapes,
            "checked": len(chk.errs), **chk.worst()}


def whole_frame_inputs(folder: str):
    """The launch of the whole-frame ROI 0 at the bench frame size: stage
    S01's corrected frames through ``ops.roistats.roi_stats_full`` (the
    frame zero-padded to one 2048 x 2048 tile), held to the plain version
    on the way; returns its (frames, masks, offs)."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch import native
    from imageprocess_tpu_torch.ops import roistats as trs
    from imageprocess_tpu_torch.ops.background import bg_value

    imgs = np.stack([native.decode_tiff(os.path.join(folder, f"S01_{ch}.TIF"))
                     for ch in CHANNELS])
    x = torch.from_numpy(imgs.astype(np.int32)).cuda()
    bgs = torch.stack([bg_value(im, 1000, None, "percentile", 4) for im in x])
    bc = torch.clamp(x.float() - bgs[:, None, None], min=0.0)
    with CheckedRoiRows("whole frame") as chk:
        trs.roi_stats_full(bc, torch.ones((1, H, W), dtype=torch.bool, device=bc.device))
    return next(iter(chk.first.values()))


def time_roi_rows(inputs, extent=None, reps: int = 50, per_graph: int = 20,
                  graph_reps: int = 10) -> dict:
    """``roistats_f32`` on one launch's inputs: per call (CUDA events, in
    turns plain / kernel / kernel / plain) and by graph replay, checked
    against the plain version; the bound counts what the statistics need
    read and written: for each valid ROI (a mask with a pixel set; the
    bucket's padding lanes are left out) the C values and the mask of its
    tile's part inside the unpadded frame of *extent* = (H, W) (the
    frame's own size by default), its origin and its C x 9 output."""
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk

    frames, masks, offs = inputs
    kern = lambda: rsk.roi_stat_rows(frames, masks, offs)  # noqa: E731
    plain = lambda: rsk.roi_stat_rows_plain(frames, masks, offs)  # noqa: E731
    out = kern()
    err = compare_packed(out.movedim(-1, 1), plain().movedim(-1, 1),
                         f"timing {tuple(masks.shape)}", ROW_EXACT, ROW_MOMENTS)
    warm = max(1, reps // 10)
    p1, k1, k2, p2 = (cuda_ms(plain, reps, warm), cuda_ms(kern, reps, warm),
                      cuda_ms(kern, reps, warm), cuda_ms(plain, reps, warm))
    R, T, _ = masks.shape
    C = frames.shape[1]
    H, W = extent or frames.shape[-2:]
    valid = masks.reshape(R, -1).any(dim=1)
    rows = torch.clamp(H - offs[valid, 1], 0, T).to(torch.int64)
    cols = torch.clamp(W - offs[valid, 2], 0, T).to(torch.int64)
    px = int((rows * cols).sum().item())
    nv = int(valid.sum().item())
    nbytes = px * (C * 4 + 1) + nv * (offs.shape[1] * 4 + C * 9 * 4)
    ops = 7.0 * out[..., 8].sum().item()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    use_smem, stage_mask = rsk.kernel_variant(T, frames.device)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "turns": [p1, k1, k2, p2],
            "device_ms": graph_ms(kern, per_graph, graph_reps), "bytes": nbytes,
            "valid": nv, "lanes": R,
            "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "grid": R * C, "shape": [list(frames.shape), list(masks.shape)],
            "use_smem": use_smem, "stage_mask": stage_mask,
            "npx": int(out[..., 8].sum().item()), **err}


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, per_graph: int = 20, reps: int = 10) -> float:
    """Device time of one *fn()* launch: *per_graph* launches captured in a
    CUDA graph, the graph replayed *reps* times between CUDA events, so the
    Python wrapper's host time between launches is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * per_graph)


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def kernel_bound(inputs, outputs, ops: float) -> dict:
    """The least time the card could take for a kernel's work: each input
    read once and each output written once at the device-memory rate, or
    *ops* float32 operations at the card's peak, whichever is longer."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_chunk(inputs) -> dict:
    """Per-chunk times on the same device tensors, in turns (plain,
    kernel, kernel, plain): the kernel against the plain PyTorch version
    of the same work (statistics of already-rasterized masks), and the
    whole step (rasterize + statistics) both ways."""
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk

    tiles, lp, valid, bgs = inputs
    masks = tsk.tile_masks(lp, valid, tiles.shape[-1])
    kern = lambda: tsk.launch_packed(tiles, masks, bgs)  # noqa: E731
    plain = lambda: tsk.packed_from_masks_plain(tiles, masks, bgs)  # noqa: E731
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    step = lambda: tsk.tile_stats_packed(tiles, lp, valid, bgs)  # noqa: E731
    step_plain = lambda: tsk.tile_stats_packed_plain(tiles, lp, valid, bgs)  # noqa: E731
    out = kern()
    # per masked pixel and channel: count, - bg, clip, sum, min, max, and
    # the variance's subtract, square, add
    ops = 9.0 * out[:, 8].sum().item()
    B, N, C, t, _ = tiles.shape
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "turns": [p1, k1, k2, p2], "device_ms": graph_ms(kern),
            **kernel_bound((tiles, masks, bgs), (out,), ops),
            "grid": B * N * C, "ctas_per_sm": tsk.occupancy(t, tiles.device),
            "rasterize_ms": cuda_ms(lambda: tsk.tile_masks(lp, valid,
                                                           tiles.shape[-1])),
            "step_ms": cuda_ms(step), "step_plain_ms": cuda_ms(step_plain)}


def time_fret_chunk(inputs) -> dict:
    """Per-chunk FRET times on the same device tensors, in turns (plain,
    kernel, kernel, plain): the kernel against the plain PyTorch statistics
    of the same [ratio, donor, acceptor] stack, and the whole step
    (rasterize + stack + statistics) both ways."""
    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk

    tiles, lp, valid, bgs, eps = inputs
    B, N, _, t, _ = tiles.shape
    masks = tsk.tile_masks(lp, valid, t).reshape(B * N, t, t)
    stack = rsk.fret_tile_stack(tiles, bgs, eps)
    offs = rsk.stack_offsets(B * N, tiles.device)
    kern = lambda: rsk.roi_stat_rows(stack, masks, offs)  # noqa: E731
    plain = lambda: rsk.roi_stat_rows_plain(stack, masks, offs)  # noqa: E731
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    step = lambda: rsk.fret_tile_stats_packed(tiles, lp, valid, bgs, eps)  # noqa: E731
    step_plain = lambda: rsk.fret_tile_stats_packed_plain(  # noqa: E731
        tiles, lp, valid, bgs, eps)
    sp1, sk1, sk2, sp2 = (cuda_ms(step_plain), cuda_ms(step), cuda_ms(step),
                          cuda_ms(step_plain))
    out = kern()
    # per valid pixel and channel: finiteness, sum, min, max, and the
    # variance's subtract, square, add
    ops = 7.0 * out[..., 8].sum().item()
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "turns": [p1, k1, k2, p2], "device_ms": graph_ms(kern),
            **kernel_bound((stack, masks, offs), (out,), ops),
            "grid": out.shape[0] * out.shape[1],
            "ctas_per_sm": rsk.occupancy(t, tiles.device),
            "step_ms": (sk1 + sk2) / 2, "step_plain_ms": (sp1 + sp2) / 2,
            "step_turns": [sp1, sk1, sk2, sp2]}


def kernel_times() -> dict:
    """Per-call (CUDA events) and device (graph replay) times of both
    kernels of the imported checkout on synthetic bench-like inputs: the
    intensity chunk (4, 18, 2, 128, 128) and FRET stacks of 4 x 18 tiles x
    3 channels at T = 128 ... 240 (multiples of 16, as
    ``ops.roistats.choose_tile`` gives them, up to and around the
    shared-memory limits), circles of radius T / 2 - 4; for a checkout
    with ``kernel_variant`` also the device time of every roistats variant
    that fits.  Each kernel is first held to its plain version on the
    same inputs."""
    import functools

    import numpy as np
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk

    rng = np.random.default_rng(31)
    dev = torch.device("cuda")
    B, N = 4, N_ROI

    def values(shape):  # background near 300, 3 % bright pixels
        v = rng.normal(300.0, 40.0, shape) + 3000.0 * (rng.random(shape) > 0.97)
        return torch.from_numpy(np.clip(v, 0, 65535).astype(np.uint16)).to(dev)

    def circles(T):
        m = _circle_mask(T, (T - 1) / 2, (T - 1) / 2, T / 2 - 4)
        return torch.from_numpy(np.broadcast_to(m, (B * N, T, T)).copy()).to(dev)

    out = {}
    tiles, masks = values((B, N, 2, 128, 128)), circles(128).view(B, N, 128, 128)
    bgs = torch.full((B, 2), 100.0, device=dev)
    kern = functools.partial(tsk.launch_packed, tiles, masks, bgs)
    compare_packed(kern(), tsk.packed_from_masks_plain(tiles, masks, bgs),
                   "tilestats_u16 t=128")
    out["tilestats_u16 t=128"] = {"ms": cuda_ms(kern), "device_ms": graph_ms(kern)}
    for T in (128, 144, 160, 192, 208, 224, 240):
        stack = rsk.fret_tile_stack(values((B, N, 2, T, T)),
                                    torch.full((B, 2), 100.0, device=dev),
                                    torch.full((B,), 5.0, device=dev))
        m, offs = circles(T), rsk.stack_offsets(B * N, dev)
        kern = functools.partial(rsk.roi_stat_rows, stack, m, offs)
        compare_packed(kern().movedim(-1, 1),
                       rsk.roi_stat_rows_plain(stack, m, offs).movedim(-1, 1),
                       f"roistats_f32 T={T}", ROW_EXACT, ROW_MOMENTS)
        row = {"ms": cuda_ms(kern), "device_ms": graph_ms(kern)}
        if hasattr(rsk, "kernel_variant"):  # every variant that fits, forced
            row["use_smem"], row["stage_mask"] = rsk.kernel_variant(T, dev)
            keys_fit, both_fit = rsk.smem_fits(T, dev)
            forced = {"device memory": {"use_smem": False}}
            if keys_fit:
                forced["keys staged"] = {"use_smem": True, "stage_mask": False}
            if both_fit:
                forced["keys and mask staged"] = {"use_smem": True, "stage_mask": True}
            row["variants_device_ms"] = {
                name: graph_ms(functools.partial(rsk.roi_stat_rows, stack, m, offs,
                                                 **opts))
                for name, opts in forced.items()}
        else:
            row["use_smem"] = rsk.kernel_uses_smem(T, dev)
        out[f"roistats_f32 T={T}"] = row
    return out


# ------------------------------------------------------------------ segmentation

SEG_SEED = 0
SEG_MIN_TRUE_PX = 150      # synthcells.eval_frame drops smaller true slivers
SEG_PHASES = ("host_prepass", "upload_stretch", "tile_cut", "forward",
              "recomposition", "remove_small_objects", "follow_flows",
              "flow_label.histogram", "flow_label.dilation", "flow_label.ccl",
              "flow_label.readback", "d2h", "polygons")


def seg_frame(shape=(H, W), seed: int = SEG_SEED):
    """A deterministic synthcells "fluor" frame at the bench's frame shape
    (u16) and the generator's labels, with true instances below 150 px
    dropped, as ``synthcells.eval_frame`` does."""
    import numpy as np

    from imageprocess_tpu_torch.models import synthcells

    rng = np.random.default_rng(100_000 + seed)
    img, labels = synthcells.synth_frame(rng, *shape, "fluor",
                                         r_range=(10.0, 32.0))
    ids, counts = np.unique(labels[labels > 0], return_counts=True)
    labels = np.where(np.isin(labels, ids[counts < SEG_MIN_TRUE_PX]), 0, labels)
    return np.clip(img, 0, 65535).astype(np.uint16), labels


def match_label_maps(pred, true, iou_threshold: float) -> dict:
    """Greedy IoU matching of the instances of two label maps (0 =
    background), largest IoU first: recall = matched / true instances,
    mean IoU over the matched pairs."""
    import numpy as np

    p = pred.astype(np.int64).ravel()
    t = true.astype(np.int64).ravel()
    n_p, n_t = int(p.max()) + 1, int(t.max()) + 1
    inter = np.bincount(t * n_p + p, minlength=n_t * n_p).reshape(n_t, n_p)
    area_t, area_p = inter.sum(1), inter.sum(0)
    iou = inter / np.maximum(area_t[:, None] + area_p[None, :] - inter, 1)
    iou[0, :] = 0.0
    iou[:, 0] = 0.0
    used_t, used_p, matched = set(), set(), []
    for k in np.argsort(-iou, axis=None):
        ti, pi = divmod(int(k), n_p)
        if iou[ti, pi] < iou_threshold:
            break
        if ti not in used_t and pi not in used_p:
            used_t.add(ti)
            used_p.add(pi)
            matched.append(iou[ti, pi])
    n_true = int((area_t[1:] > 0).sum())
    return {"recall": len(matched) / max(n_true, 1),
            "mean_iou": float(np.mean(matched)) if matched else 0.0,
            "n_true": n_true, "n_pred": int((area_p[1:] > 0).sum()),
            "matched": len(matched)}


def run_seg_path(device: str, reps: int = 3, shape=(H, W)) -> dict:
    """U-Net segmentation of one bench-shaped frame on the card through
    ``segment_frame_unet`` (golden checkpoint, tile 256, overlap 32,
    n_iter 120): a warm run, *reps* timed runs, one run with per-phase CUDA
    events, then the checks against the port on the CPU and the
    generalist's quality against the generator's labels."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.models.checkpoint import load_unet
    from imageprocess_tpu_torch.segment import auto, cellseg
    from imageprocess_tpu_torch.timing import PhaseTimer

    frame, truth = seg_frame(shape)
    cfg = auto.AutoSegConfig(backend="unet")
    model, tile = auto._unet_model(cfg, device)
    mpix = frame.size / 1e6

    def one_run(timer=None):
        t0 = time.perf_counter()
        kw = {} if timer is None else {"timer": timer}
        polys = cellseg.segment_frame_unet(frame, model, tile=tile,
                                           device=device, **kw)
        torch.cuda.synchronize()
        return polys, time.perf_counter() - t0

    polys, warm = one_run()
    times = [one_run()[1] for _ in range(reps)]
    timer = PhaseTimer(device)
    polys_t, traced = one_run(timer)
    phases = timer.times_ms()
    if not polys or len(polys_t) != len(polys):
        raise SmokeError(f"seg: {len(polys)} polygons, then {len(polys_t)}")
    for p in polys:
        if p.ndim != 2 or p.shape[1] != 2 or len(p) < 3 or not np.isfinite(p).all():
            raise SmokeError(f"seg: malformed polygon of shape {p.shape}")
    missing = [ph for ph in SEG_PHASES if ph not in phases]
    if missing:
        raise SmokeError(f"seg: phases not seen: {missing}")

    # the card against the port on the CPU, same frame and weights
    lab_card = cellseg.label_frame_unet(frame, model, tile=tile, device=device)
    cpu_model, _ = load_unet(auto.DEFAULT_UNET_CKPT)
    tiles, keep, ys, xs = cellseg.frame_tiles(frame, tile, device="cpu")
    out_cpu = cellseg.forward_tiles(cpu_model, tiles)
    post = dict(ys=ys, xs=xs, tile=tile, shape=frame.shape)
    lab_cpu = cellseg.postprocess(out_cpu, keep, **post)[0].numpy()
    lab_fed = cellseg.postprocess(out_cpu.to(device), keep, **post)[0].cpu().numpy()
    if lab_card.shape != frame.shape or lab_card.dtype != np.uint16:
        raise SmokeError(f"seg: label map {lab_card.shape} {lab_card.dtype}")
    if not np.array_equal(lab_fed, lab_cpu):
        raise SmokeError("seg: the card's post-process fed the CPU's network "
                         f"output differs from the CPU's on "
                         f"{int((lab_fed != lab_cpu).sum())} pixels")
    vs_cpu = match_label_maps(lab_card, lab_cpu, 0.5)
    if vs_cpu["recall"] < 0.95 or vs_cpu["mean_iou"] < 0.95:
        raise SmokeError(f"seg: card vs CPU label maps {vs_cpu}")
    # the generalist against the generator's labels (the "fluor" floors)
    gmodel, gtile = auto._unet_model(auto.AutoSegConfig(checkpoint="general"),
                                     device)
    lab_gen = cellseg.label_frame_unet(frame, gmodel, tile=gtile, device=device)
    vs_truth = match_label_maps(lab_gen, truth, 0.3)
    if vs_truth["recall"] < 0.90 or vs_truth["mean_iou"] < 0.70:
        raise SmokeError(f"seg: generalist vs generator labels {vs_truth}")
    return {
        "polygons": len(polys), "warm_s": warm, "steady_s": min(times),
        "times_s": times, "warm_mpix_s": mpix / warm,
        "steady_mpix_s": mpix / min(times), "traced_s": traced,
        "phases_ms": phases, "counts": dict(timer.counts),
        "tiles_total": len(ys) * len(xs), "vs_cpu": vs_cpu,
        "vs_truth": vs_truth, "true_cells": int(vs_truth["n_true"]),
    }


# ------------------------------------------------------------------ focal adhesions

FA_CHANNEL = CHANNELS[0]
FA_BLOBS = 10                        # per cell
FA_CATEGORIES = ("OK", "Large", "Small")


def fa_config(**kw):
    from imageprocess_tpu_torch.pipelines.fa import FaConfig

    return FaConfig(channel=FA_CHANNEL, px_size=N2_PX_UM, alpha=3.0, close_radius=1,
                    **kw)


def make_fa_dataset(folder: str, n_stages: int = N_STAGES, shape=(H, W),
                    seed: int = 7) -> None:
    """The focal-adhesion experiment: *n_stages* u16 frames of the bench
    shape (noise around 120) with, inside each of the 18 bench circles,
    ``FA_BLOBS`` bright Gaussian blobs (sigma 2 to 6.5 px, so that areas
    fall on both sides of the 30 um2 bound at 0.223 um/px), and the bench
    ROI JSON of every stage under ``roi/``."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        Image = None
    h, w = shape
    os.makedirs(os.path.join(folder, "roi"), exist_ok=True)
    rng = np.random.default_rng(seed)
    centers = [(150 + 300 * (i // 8), 150 + 200 * (i % 8)) for i in range(N_ROI)]
    for s in range(1, n_stages + 1):
        img = rng.normal(120, 15, (h, w)).astype(np.float32)
        for cy0, cx0 in centers:
            for _ in range(FA_BLOBS):
                rad, th = 45 * math.sqrt(rng.random()), 2 * math.pi * rng.random()
                cy, cx = cy0 + rad * math.sin(th), cx0 + rad * math.cos(th)
                sig = rng.uniform(2.0, 6.5)
                r = int(4 * sig) + 1
                y0, x0 = int(cy) - r, int(cx) - r
                yy, xx = np.mgrid[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1]
                img[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1] += rng.uniform(1500, 3000) * \
                    np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * sig * sig))
        img = img.clip(0, 65535).astype(np.uint16)
        path = os.path.join(folder, f"S{s:02d}_{FA_CHANNEL}.TIF")
        if Image is not None:
            Image.fromarray(img).save(path, format="TIFF", compression="tiff_lzw")
        else:
            write_tiff16_deflate(path, img)
        with open(os.path.join(folder, "roi", f"S{s:02d}.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"name": f"S{s:02d}", "image_shape": {"height": h, "width": w},
                       "rois": [p.tolist() for p in bench_polys()]}, f)


def fa_reference_rows(folder: str, stage: str, cfg) -> list:
    """numpy / scipy replica of the reference FA batch loop for one stage,
    in float64: threshold mean + alpha * std of the whole frame, bg the 1st
    percentile of ``img[::10, ::10]``, and per cell on its bbox grown by 5 px
    the polygon mask (the port's host rasterizer), remove-small with
    ``scipy.ndimage.label`` (4-connected), the closing as dilation and
    border-true erosion, 8-connected labels, area and mean."""
    import numpy as np
    import scipy.ndimage as ndi

    from imageprocess_tpu_torch import native
    from imageprocess_tpu_torch.geom.rasterize import rasterize_polygon_np
    from imageprocess_tpu_torch.morphology.binary import disk

    img = native.decode_tiff(os.path.join(folder, f"{stage}_{FA_CHANNEL}.TIF")) \
        .astype(np.float64)
    thr = img.mean() + cfg.alpha * img.std()
    bg = float(np.percentile(img[::10, ::10], 1.0))
    rows = []
    for i, poly in enumerate(bench_polys()):
        xs, ys = poly[:, 0], poly[:, 1]
        x0, x1 = max(0, int(np.floor(xs.min())) - 5), min(W, int(np.ceil(xs.max())) + 5)
        y0, y1 = max(0, int(np.floor(ys.min())) - 5), min(H, int(np.ceil(ys.max())) + 5)
        crop = img[y0:y1, x0:x1]
        bw = (crop > thr) & rasterize_polygon_np(poly - np.array([x0, y0], float),
                                                 crop.shape)
        if cfg.min_px > 0:
            lab4, n4 = ndi.label(bw)
            sizes = ndi.sum(bw, lab4, np.arange(1, n4 + 1))
            bw &= ~np.isin(lab4, np.where(sizes < cfg.min_px)[0] + 1)
        if cfg.close_radius > 0:
            se = disk(cfg.close_radius)
            bw = ndi.binary_erosion(ndi.binary_dilation(bw, se), se, border_value=1)
        lab, n = ndi.label(bw, structure=np.ones((3, 3)))
        for r in range(1, n + 1):
            area = float((lab == r).sum())
            rows.append({"Cell_ID": i + 1, "Area_px": area,
                         "Category": "Small" if area < cfg.min_px else
                         "Large" if area > cfg.max_px else "OK",
                         "Mean_Intensity_Raw": float(crop[lab == r].mean()),
                         "Background_Level": bg, "Global_Threshold": float(thr)})
    return rows


FA_CLOSE = ("Mean_Intensity_Raw", "Mean_Intensity_Corr", "Int_Density_Raw",
            "Int_Density_Corr", "Background_Level", "Global_Threshold")


def _fa_rows_close(got, want, what: str, keys=None, rtol: float = REL_TOL) -> float:
    """Two lists of FA rows: as many, cells, areas and categories (and
    every other column) equal, the columns of ``FA_CLOSE`` within *rtol*
    relative.  *keys*: the columns to compare (default: *want*'s)."""
    if len(got) != len(want):
        raise SmokeError(f"{what}: {len(got)} rows vs {len(want)}")
    worst = 0.0
    for a, b in zip(got, want):
        for k in keys or b:
            if k in FA_CLOSE:
                rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-9)
                worst = max(worst, rel)
                if not rel <= rtol:
                    raise SmokeError(f"{what} cell {b['Cell_ID']} {k}: {a[k]} vs "
                                     f"{b[k]} ({rel:.2e} rel)")
            elif a[k] != b[k]:
                raise SmokeError(f"{what} cell {b['Cell_ID']} {k}: {a[k]!r} vs {b[k]!r}")
    return worst


def run_fa_paths(folder: str, device: str, reps: int = 2) -> dict:
    """``run_fa_batched(batch_size=4)`` and ``run_fa_batch`` over the FA
    experiment: a warm and *reps* timed runs each; every stage yields rows
    and two categories occur; batched rows == serial rows, every value;
    the card's rows of S01 and the last stage against the port on the CPU
    (areas, categories and counts equal, the float columns within
    REL_TOL); S01 against the numpy / scipy replica; the master workbook
    read back; one batched run with a ``PhaseTimer`` (CCL rounds of both
    CCLs, the chunk step's device time by CUDA events) and one under
    ``torch.profiler`` (launches per frame, the device's idle share)."""
    import torch

    from imageprocess_tpu_torch.core import tiffio
    from imageprocess_tpu_torch.pipelines import fa
    from imageprocess_tpu_torch.report.xlsxlite import read_xlsx
    from imageprocess_tpu_torch.timing import PhaseTimer

    cfg = fa_config()
    roi_dir = os.path.join(folder, "roi")
    logs = []
    workers = max(8, (os.cpu_count() or 1) * 2)

    def batched(timer=None, out="RES_fa_batched"):
        kw = {} if timer is None else {"timer": timer}
        return fa.run_fa_batched(folder, roi_dir, os.path.join(folder, out), cfg,
                                 log=logs.append, batch_size=4,
                                 prefetch_workers=workers, device=device, **kw)

    def serial():
        return fa.run_fa_batch(folder, roi_dir, os.path.join(folder, "RES_fa"), cfg,
                               log=logs.append, device=device)

    mpix = N_STAGES * H * W / 1e6
    out = {}
    for kind, one_run in (("batched", batched), ("serial", serial)):
        t0 = time.perf_counter()
        res = one_run()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = one_run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if again != res:
                raise SmokeError(f"FA {kind}: a timed run gave other rows")
        out[kind] = {"results": res, "warm_s": warm, "times_s": times,
                     "steady_s": min(times), "warm_mpix_s": mpix / warm,
                     "steady_mpix_s": mpix / min(times)}
    errors = [line for line in logs if "ERROR" in str(line) or "오류" in str(line)
              or "Error" in str(line)]
    if errors:
        raise SmokeError(f"FA runners logged errors: {errors[:3]}")
    res = out["serial"]["results"]
    stages = [f"S{s:02d}" for s in range(1, N_STAGES + 1)]
    if sorted(res) != stages or not all(res[s] for s in stages):
        raise SmokeError(f"FA: stages with rows {sorted(res)}, want {stages}")
    if out["batched"]["results"] != res:
        for s in stages:
            _fa_rows_close(out["batched"]["results"].get(s, []), res[s],
                           f"FA batched vs serial {s}", rtol=0.0)
        raise SmokeError("FA: batched rows != serial rows")
    cats = {c: sum(r["Category"] == c for rows in res.values() for r in rows)
            for c in FA_CATEGORIES}
    if sum(n > 0 for n in cats.values()) < 2:
        raise SmokeError(f"FA: fewer than two categories occur: {cats}")
    n_rows = sum(map(len, res.values()))
    cells = {(s, r["Cell_ID"]) for s, rows in res.items() for r in rows}
    # the card against the port on the CPU, first and last stage
    cpu_rel = 0.0
    for s in (stages[0], stages[-1]):
        img = tiffio.read_2d(os.path.join(folder, f"{s}_{FA_CHANNEL}.TIF"),
                             squeeze="smallest_axis")
        rois = fa._load_rois(os.path.join(roi_dir, f"{s}.json"))
        fa_rows, thr, bg, _ = fa.analyze_image(img, rois, cfg, device="cpu")
        cpu_rel = max(cpu_rel, _fa_rows_close(
            res[s], fa._stage_rows(s, fa_rows, thr, bg, cfg), f"FA card vs CPU {s}"))
    ref = fa_reference_rows(folder, stages[0], cfg)
    ref_rel = _fa_rows_close(res[stages[0]], ref, f"FA replica {stages[0]}")
    # the master workbook, read back
    for stem in ("RES_fa", "RES_fa_batched"):
        sheets = read_xlsx(os.path.join(folder, stem, cfg.master_name))
        if list(sheets) != ["File_Summary", "Cell_Summary", "All_Data"]:
            raise SmokeError(f"FA {stem}: master sheets {list(sheets)}")
        fs, cs, ad = (sheets[k] for k in sheets)
        totals = {row[0]: row[fs[0].index("Total_FA_Count")] for row in fs[1:]}
        if totals != {s: len(res[s]) for s in stages} or len(ad) != n_rows + 1 \
                or len(cs) != len(cells) + 1:
            raise SmokeError(f"FA {stem}: the master workbook's counts differ from "
                             f"the rows ({totals}, {len(ad) - 1} of {n_rows} rows, "
                             f"{len(cs) - 1} of {len(cells)} cells)")
        for s in stages:
            if not os.path.exists(os.path.join(folder, stem, "individual_results",
                                               f"{s}_results.csv")):
                raise SmokeError(f"FA {stem}: {s}_results.csv was not written")
    timer = PhaseTimer(device)
    t0 = time.perf_counter()
    if batched(timer, "RES_fa_traced") != res:
        raise SmokeError("FA: the traced run gave other rows")
    traced = time.perf_counter() - t0
    pr = profile_run(lambda: batched(out="RES_fa_traced"))
    ps = profile_run(serial)
    return {"batched": out["batched"], "serial": out["serial"], "rows": n_rows,
            "cells": len(cells), "categories": cats, "cpu_max_rel": cpu_rel,
            "replica_max_rel": ref_rel, "replica_rows": len(ref),
            "phases_ms": timer.times_ms(), "counts": dict(timer.counts),
            "traced_s": traced, "profile": pr, "profile_serial": ps}


# ------------------------------------------------------------------ TIFF outputs

TIFF_STAGES = 4


def _tiff_files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith((".tif", ".tmp")))


def compare_tiffs(card_root: str, cpu_root: str, what: str) -> dict:
    """The card's TIFF outputs against the CPU run's: the same names, no
    ``.tmp`` left, float32 frames within 1e-6 (of the pixel plus of the
    frame's largest magnitude) with NaN in the same places, 16-bit previews
    within one count."""
    import numpy as np
    from PIL import Image

    names = _tiff_files(card_root)
    if names != _tiff_files(cpu_root) or not names or \
            any(n.endswith(".tmp") for n in names):
        raise SmokeError(f"{what}: files {names} vs the CPU run's "
                         f"{_tiff_files(cpu_root)}")
    worst32, worst16 = 0.0, 0
    for name in names:
        a = np.array(Image.open(os.path.join(card_root, name)))
        b = np.array(Image.open(os.path.join(cpu_root, name)))
        if a.shape != (H, W) or a.shape != b.shape or a.dtype != b.dtype:
            raise SmokeError(f"{what} {name}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        if a.dtype == np.float32:
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                raise SmokeError(f"{what} {name}: NaN in other places")
            ok = ~np.isnan(b)
            scale = float(np.abs(b[ok]).max()) if ok.any() else 0.0
            err = np.abs(a[ok].astype(np.float64) - b[ok])
            if not (err <= 1e-6 * np.abs(b[ok]) + 1e-6 * scale).all():
                raise SmokeError(f"{what} {name}: max abs err {err.max()}")
            worst32 = max(worst32, float((err / max(scale, 1e-30)).max()))
        elif a.dtype == np.uint16:
            d = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
            worst16 = max(worst16, d)
            if d > 1:
                raise SmokeError(f"{what} {name}: preview differs by {d} counts")
        else:
            raise SmokeError(f"{what} {name}: dtype {a.dtype}")
    return {"files": len(names), "max_err32_of_scale": worst32, "max_err16": worst16}


def run_tiff_outputs(data: str, device: str) -> dict:
    """``do_tif=True`` through ``run_intensity``, ``run_fret`` and
    ``run_nesprin2`` on the first ``TIFF_STAGES`` stages of the smoke
    dataset: a checked run with the TIFFs (every ``roistats_f32`` launch
    held to its plain version, the count set to 0 just before and read just
    after), a timed tables-only run and a timed run with the TIFFs (their
    difference per key is what download, percentiles and writes cost); the
    rows with the TIFFs equal the tables-only rows; the files against the
    same run on the CPU."""
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.pipelines import fret, intensity, nesprin2

    folder = os.path.join(data, "tiff_outputs")
    os.makedirs(os.path.join(folder, "roi"), exist_ok=True)
    for s in range(1, TIFF_STAGES + 1):
        for name in [f"S{s:02d}_{ch}.TIF" for ch in CHANNELS] + \
                [os.path.join("roi", f"S{s:02d}.json")]:
            shutil.copy(os.path.join(data, name), os.path.join(folder, name))
    workers = max(8, (os.cpu_count() or 1) * 2)
    runners = {
        "run_intensity": (lambda cfg_kw, out, dev: intensity.run_intensity(
            folder, intensity.IntensityConfig(
                channels=CHANNELS, channel_colors={2: "Green", 3: "Red"}, do_xls=False,
                **cfg_kw),
            out_root=out, log=lambda *_: None, prefetch_workers=workers, device=dev),
            dict(tif_mask_outside=True)),
        "run_fret": (lambda cfg_kw, out, dev: fret.run_fret(
            folder, fret.FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1],
                                    do_xls=False, **cfg_kw),
            out_root=out, log=lambda *_: None, prefetch_workers=workers, device=dev),
            {}),
        "run_nesprin2": (lambda cfg_kw, out, dev: nesprin2.run_nesprin2(
            folder, n2_config("annulus off", do_xls=False, **cfg_kw), out_root=out,
            log=lambda *_: None, device=dev), {}),
    }
    res = {}
    for name, (run, extra) in runners.items():
        card_root = os.path.join(folder, f"RES_{name}_card")
        rsk.reset_launches()
        with CheckedRoiRows(f"{name} do_tif") as chk:
            rows = run(dict(do_tif=True, **extra), card_root, device)
        torch.cuda.synchronize()
        launches = rsk.launches["roistats_f32"]
        if launches != TIFF_STAGES or len(chk.errs) != TIFF_STAGES:
            raise SmokeError(f"{name} do_tif: {launches} roistats_f32 launches, "
                             f"{len(chk.errs)} checked, want {TIFF_STAGES}")
        t0 = time.perf_counter()
        tables = run({}, os.path.join(folder, f"RES_{name}_tables"), device)
        torch.cuda.synchronize()
        t_tables = time.perf_counter() - t0
        if _tiff_files(os.path.join(folder, f"RES_{name}_tables")):
            raise SmokeError(f"{name}: a tables-only run wrote TIFFs")
        shutil.rmtree(card_root)
        t0 = time.perf_counter()
        again = run(dict(do_tif=True, **extra), card_root, device)
        torch.cuda.synchronize()
        t_tif = time.perf_counter() - t0
        _rows_equal(rows, tables, f"{name} do_tif vs tables-only", (),
                    TIFF_STAGES * N_ROI)
        _rows_equal(again, tables, f"{name} do_tif (timed) vs tables-only", (),
                    TIFF_STAGES * N_ROI)
        cpu_root = os.path.join(folder, f"RES_{name}_cpu")
        t0 = time.perf_counter()
        run(dict(do_tif=True, **extra), cpu_root, "cpu")
        cpu_s = time.perf_counter() - t0
        res[name] = {"launches": launches, "tables_s": t_tables, "tif_s": t_tif,
                     "extra_s_per_key": (t_tif - t_tables) / TIFF_STAGES,
                     "cpu_s": cpu_s, **chk.worst(),
                     **compare_tiffs(card_root, cpu_root, f"{name} TIFFs")}
    shutil.rmtree(folder, ignore_errors=True)
    return res


# ------------------------------------------------------------------ PNG outputs and the cropper

IMAGE_STAGES = 2
IMAGE_ROIS = 4             # of the 18: the PNG crops per key
PNG_FRAC = 1e-3            # share of a PNG's pixels that may differ, by one LUT step


def check_font() -> str:
    """PIL's FreeType and the committed font, before any PNG is drawn: the
    text of every scalebar, title and colorbar needs both."""
    import hashlib

    import PIL
    from PIL import features

    from imageprocess_tpu_torch.report import pilcomp

    if not features.check("freetype2"):
        raise SmokeError(f"PIL {PIL.__version__} was built without FreeType")
    with open(pilcomp.FONT_PATH, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    name = " ".join(pilcomp._dejavu(10 * 300 / 72.0, exact=True).getname())
    return (f"PIL {PIL.__version__}, FreeType {features.version('freetype2')}, "
            f"{os.path.relpath(pilcomp.FONT_PATH, REPO)} ({name}, sha256 {sha[:16]})")


def _png_files(root: str, stage: str = "") -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".png") and f.startswith(stage))


def compare_pngs(card_root: str, cpu_root: str, stage: str, step: int, what: str) -> dict:
    """The card run's PNGs of *stage* against the CPU run's: the same names
    and canvas sizes, decoded pixels equal but for at most ``PNG_FRAC`` of
    a file's pixels within *step* (one LUT step: a ratio a few ulps off can
    move a pixel across a LUT boundary)."""
    import numpy as np
    from PIL import Image

    names = _png_files(card_root, stage)
    if not names or names != _png_files(cpu_root, stage):
        raise SmokeError(f"{what}: PNGs {names} vs the CPU run's "
                         f"{_png_files(cpu_root, stage)}")
    worst, frac = 0, 0.0
    for name in names:
        a = np.asarray(Image.open(os.path.join(card_root, name)).convert("RGB"), np.int16)
        b = np.asarray(Image.open(os.path.join(cpu_root, name)).convert("RGB"), np.int16)
        if a.shape != b.shape:
            raise SmokeError(f"{what} {name}: canvas {a.shape} vs {b.shape}")
        d = np.abs(a - b).max(-1)
        worst, frac = max(worst, int(d.max())), max(frac, float((d > 0).mean()))
        if d.max() > step or (d > 0).mean() > PNG_FRAC:
            raise SmokeError(f"{what} {name}: pixels differ by up to {d.max()} on "
                             f"{100 * (d > 0).mean():.3f} % of the canvas")
    return {"compared": len(names), "max_px_diff": worst, "max_diff_share": frac}


class CapturedCropView:
    """While active, the inputs of each ``crop_view_tiled`` call of
    ``pipelines.crop`` are kept (for its timing and its card-vs-CPU
    check)."""

    def __init__(self):
        from imageprocess_tpu_torch.pipelines import crop

        self.mod, self.real, self.calls = crop, crop.crop_view_tiled, []

    def __enter__(self):
        def captured(*args, **kw):
            self.calls.append((args, kw))
            return self.real(*args, **kw)

        self.mod.crop_view_tiled = captured
        return self

    def __exit__(self, *exc):
        self.mod.crop_view_tiled = self.real


def run_image_outputs(data: str, device: str) -> dict:
    """The PNG outputs at the configs' PNG defaults (dpi 300, 500-px crops,
    FRET's and rim FRET's inset colorbar) on ``IMAGE_STAGES`` stages with
    ``IMAGE_ROIS`` of the 18 ROIs: ``run_intensity``, ``run_fret`` and
    ``run_nesprin2`` (annulus and QC) with ``do_png``, ``run_morphology``
    with ``MorConfig``'s image defaults.  Per runner: a checked run (every
    ``roistats_f32`` launch held to its plain version, the count set to 0
    just before and read just after), a timed tables-only run and a timed
    run with the PNGs, the rows with PNGs equal to the tables-only rows,
    and stage 1's PNGs against the same run on the CPU.  Then ``run_crop``
    over the stages with all 18 ROIs (seconds per frame; stage 1 against
    the CPU) and ``crop_view_tiled`` by CUDA events on the card against
    the CPU on the same inputs."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.core import roiio
    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.pipelines import crop, fret, intensity, morphology
    from imageprocess_tpu_torch.pipelines import nesprin2
    from imageprocess_tpu_torch.report import cmaps, render

    font = check_font()
    folder = os.path.join(data, "image_outputs")
    os.makedirs(os.path.join(folder, "roi"), exist_ok=True)
    for s in range(1, IMAGE_STAGES + 1):
        for ch in CHANNELS:
            shutil.copy(os.path.join(data, f"S{s:02d}_{ch}.TIF"), folder)
        roiio.save_roi_bundle(os.path.join(folder, "roi", f"S{s:02d}.json"), f"S{s:02d}",
                              (H, W), bench_polys()[:IMAGE_ROIS])

    def step(*names) -> int:
        return max(int(np.abs(np.diff(cmaps.lut_u8(c)[:, :3].astype(np.int16), 0)).max())
                   for c in names)

    quiet = lambda *_: None  # noqa: E731
    runners = {  # name: (run(png, out, device, **kw), roistats launches per key, LUT step)
        "run_intensity": (lambda png, out, dev, **kw: intensity.run_intensity(
            folder, intensity.IntensityConfig(
                channels=CHANNELS, channel_colors={2: "Green", 3: "Red"}, do_xls=False,
                do_png=png, **kw), out_root=out, log=quiet, device=dev), 1,
            step("gray", render.get_cmap_for_color("Green"),
                 render.get_cmap_for_color("Red"))),
        "run_fret": (lambda png, out, dev, **kw: fret.run_fret(
            folder, fret.FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1],
                                    do_xls=False, do_png=png, **kw),
            out_root=out, log=quiet, device=dev), 1, step("gray", "jet")),
        "run_nesprin2": (lambda png, out, dev, **kw: nesprin2.run_nesprin2(
            folder, n2_config("annulus on + QC", do_xls=False, do_png=png, **kw),
            out_root=out, log=quiet, device=dev), 2, step("gray", "turbo")),
        "run_morphology": (lambda png, out, dev, **kw: morphology.run_morphology(
            folder, morphology.MorConfig(sel_ch=CHANNELS[0], do_xls=False, save_full=png,
                                         save_crop=png, **kw),
            out_root=out, log=quiet, device=dev), 0, step("gray")),
    }
    res = {"font": font}
    for name, (run, per_key, lut_step) in runners.items():
        card_root = os.path.join(folder, f"RES_{name}_card")
        rsk.reset_launches()
        with CheckedRoiRows(f"{name} do_png") as chk:
            rows = run(True, card_root, device)
        torch.cuda.synchronize()
        launches = rsk.launches["roistats_f32"]
        if launches != per_key * IMAGE_STAGES or len(chk.errs) != launches:
            raise SmokeError(f"{name} PNGs: {launches} roistats_f32 launches, "
                             f"{len(chk.errs)} checked, want {per_key * IMAGE_STAGES}")
        t0 = time.perf_counter()
        tables = run(False, os.path.join(folder, f"RES_{name}_tables"), device)
        torch.cuda.synchronize()
        t_tables = time.perf_counter() - t0
        if _png_files(os.path.join(folder, f"RES_{name}_tables")):
            raise SmokeError(f"{name}: a tables-only run wrote PNGs")
        n_png = len(_png_files(card_root))
        shutil.rmtree(card_root)
        t0 = time.perf_counter()
        again = run(True, card_root, device)
        torch.cuda.synchronize()
        t_png = time.perf_counter() - t0
        for got, what in ((rows, "checked"), (again, "timed")):
            _rows_equal(got, tables, f"{name} with PNGs ({what}) vs tables-only",
                        ("_mean", "_std", "_vsum"), IMAGE_STAGES * IMAGE_ROIS)
        cpu_root = os.path.join(folder, f"RES_{name}_cpu")
        t0 = time.perf_counter()
        if name == "run_morphology":            # MorConfig has no stage subset
            s01 = os.path.join(data, "image_s01")
            os.makedirs(os.path.join(s01, "roi"), exist_ok=True)
            shutil.copy(os.path.join(folder, f"S01_{CHANNELS[0]}.TIF"), s01)
            shutil.copy(os.path.join(folder, "roi", "S01.json"), os.path.join(s01, "roi"))
            morphology.run_morphology(s01, morphology.MorConfig(
                sel_ch=CHANNELS[0], do_xls=False), out_root=cpu_root, log=quiet,
                device="cpu")
        else:
            run(True, cpu_root, "cpu", subset_stage=1)
        cpu_s = time.perf_counter() - t0
        res[name] = {"launches": launches, "tables_s": t_tables, "png_s": t_png,
                     "extra_s_per_key": (t_png - t_tables) / IMAGE_STAGES,
                     "pngs_per_key": n_png / IMAGE_STAGES, "cpu_s": cpu_s, **chk.worst(),
                     **compare_pngs(card_root, cpu_root, "S01", lut_step, f"{name} PNGs")}

    # the cropper: every ROI of the bench set on each stage
    roi18 = os.path.join(data, "roi")
    cfg = crop.CropConfig(channel=CHANNELS[0])
    card_root = os.path.join(folder, "CROP_card")
    crop.run_crop(folder, roi18, card_root, cfg, log=quiet, device=device)   # warm
    shutil.rmtree(card_root)
    with CapturedCropView() as views:
        t0 = time.perf_counter()
        written = crop.run_crop(folder, roi18, card_root, cfg, log=quiet, device=device)
        torch.cuda.synchronize()
        crop_s = time.perf_counter() - t0
    if len(written) != IMAGE_STAGES * N_ROI or len(views.calls) != IMAGE_STAGES:
        raise SmokeError(f"run_crop: {len(written)} files, {len(views.calls)} device "
                         f"calls, want {IMAGE_STAGES * N_ROI} and {IMAGE_STAGES}")
    cpu_root = os.path.join(folder, "CROP_cpu")
    crop.run_crop(folder, roi18, cpu_root, crop.CropConfig(channel=CHANNELS[0],
                                                           subset_stage=1),
                  log=quiet, device="cpu")
    res["run_crop"] = {"files": len(written), "s_per_frame": crop_s / IMAGE_STAGES,
                       **compare_pngs(card_root, cpu_root, "S01", step("gray"),
                                      "run_crop PNGs")}
    args, kw = views.calls[0]
    view_ms = cuda_ms(lambda: crop.crop_view_tiled(*args, **kw), reps=20, warmup=3)
    card = [x.cpu() for x in crop.crop_view_tiled(*args, **kw)]
    cpu = crop.crop_view_tiled(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw)
    if not (torch.equal(card[1], cpu[1]) and torch.equal(card[2], cpu[2])):
        raise SmokeError("crop_view_tiled: the card's masks or flags differ from the CPU's")
    err = float((card[0] - cpu[0]).abs().nan_to_num(0.0).max())
    if err > 1e-6:
        raise SmokeError(f"crop_view_tiled: the card's views are {err} off the CPU's")
    res["crop_view_tiled"] = {"ms": view_ms, "tile": kw["tile"],
                              "rois": int(args[1].shape[0]), "max_abs_err_vs_cpu": err}
    shutil.rmtree(folder, ignore_errors=True)
    shutil.rmtree(os.path.join(data, "image_s01"), ignore_errors=True)
    return res


# ------------------------------------------------------------------ refine and the deck

REFINE_STAGES = 4
REFINE_CELLS = 24
REFINE_R = (20.0, 60.0)
REFINE_MIN_PX = 150        # generator instances below it get no rough polygon
REFINE_SCALE = 1.3         # the rough polygon: the instance's hull, scaled about its centroid
# thr_param of each mode, fixed on the CPU on these frames (PERF.md §4): the
# 40th percentile and mean + 0.25 sigma of the rough polygon's pixels both
# separate a cell that fills ~1/1.3^2 of its rough polygon from the background
REFINE_MODES = {"percentile": 40.0, "bnd": 0.25}
REFINE_MIN_RECALL = 0.9    # percentile mode, at IoU >= 0.5
DECK = dict(stages=("S01", "S02"), rois=("1", "2"), times=5)


def refine_frame(stage: int) -> dict:
    """Stage *stage*'s synthcells "fluor" frame (u16, 24 cells of radius
    20-60), the generator's labels without instances below 150 px, their
    outlines (cv2, as ``synthcells.eval_frame`` draws them) and one rough
    polygon per instance: its convex hull (of each row's end pixels) scaled
    1.3x about the instance's pixel centroid, one-decimal vertices clipped to
    the frame."""
    import numpy as np

    from imageprocess_tpu_torch.geom.polygon import convex_hull
    from imageprocess_tpu_torch.models import synthcells
    from imageprocess_tpu_torch.morphology.contours import masks_to_polygons

    rng = np.random.default_rng(200_000 + stage)
    img, labels = synthcells.synth_frame(rng, H, W, "fluor", n_cells=REFINE_CELLS,
                                         r_range=REFINE_R)
    ids, counts = np.unique(labels[labels > 0], return_counts=True)
    labels = np.where(np.isin(labels, ids[counts < REFINE_MIN_PX]), 0, labels)
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    order = np.argsort(lab, kind="stable")   # row-major within each instance
    ys, xs, lab = ys[order], xs[order], lab[order]
    rough = []
    for idx in np.split(np.arange(lab.size), np.flatnonzero(np.diff(lab)) + 1):
        y, x = ys[idx], xs[idx]
        first = np.r_[0, np.flatnonzero(np.diff(y)) + 1]
        last = np.r_[first[1:] - 1, y.size - 1]
        ends = np.c_[np.r_[x[first], x[last]], np.r_[y[first], y[last]]].astype(float)
        c = np.array([x.mean(), y.mean()])
        poly = np.round(c + REFINE_SCALE * (convex_hull(ends) - c), 1)
        rough.append(np.c_[poly[:, 0].clip(0, W - 1), poly[:, 1].clip(0, H - 1)])
    return {"img": np.clip(img, 0, 65535).astype(np.uint16), "rough": rough,
            "truth": masks_to_polygons(labels, min_area=20.0)}


def make_refine_dataset(folder: str) -> dict:
    """``S0k_1.TIF`` frames and their rough ROI JSONs (under ``rough/``),
    built in threads; returns {tag: refine_frame(k)}."""
    from imageprocess_tpu_torch.core import roiio, tiffio

    def one(stage):
        fr = refine_frame(stage)
        tag = f"S{stage:02d}"
        tiffio.write_tiff16(os.path.join(folder, f"{tag}_1.TIF"), fr["img"])
        roiio.save_roi_bundle(os.path.join(folder, "rough", f"{tag}.json"), tag,
                              fr["img"].shape, fr["rough"])
        return tag, fr

    os.makedirs(folder, exist_ok=True)
    with cf.ThreadPoolExecutor(REFINE_STAGES) as pool:
        return dict(pool.map(one, range(1, REFINE_STAGES + 1)))


def refine_run(folder: str, name: str, mode: str, device: str, tags,
               profile_last: bool = False) -> tuple:
    """``refine_and_save`` over the frames of *tags* (their rough JSONs
    copied into a fresh ``roi_<name>/``): (roi dir, per timed frame the wall
    seconds of [segmentation and JSON, mask, overlay, zip], the profile or
    None).  A frame's bundle logs one line per artifact, in that order,
    saved or failed.  With *profile_last* the last frame is refined by a
    second call under ``torch.profiler`` into the same roi dir (its TIFF
    copied into ``profiled/``, so that call sees it alone) and is not among
    the timed frames."""
    import torch

    from imageprocess_tpu_torch.segment.drawer import RefineConfig, refine_and_save

    def refine(img_dir, want):
        written = refine_and_save(img_dir, cfg, roi_dir=roi_dir, device=device,
                                  log=lambda *_: stamps.append(time.perf_counter()))
        if device == "cuda":
            torch.cuda.synchronize()
        if sorted(os.path.basename(p) for p in written) != sorted(f"{t}.json" for t in want) \
                or len(stamps) != 4 * len(want):
            raise SmokeError(f"refine {name}: wrote {written}, {len(stamps)} log lines")

    roi_dir = os.path.join(folder, f"roi_{name}")
    shutil.rmtree(roi_dir, ignore_errors=True)
    os.makedirs(roi_dir)
    timed = tags[:-1] if profile_last else tags
    for tag in timed:
        shutil.copy(os.path.join(folder, "rough", f"{tag}.json"), roi_dir)
    cfg = RefineConfig(thr_param=REFINE_MODES[mode], mode=mode)
    stamps = []
    t0 = time.perf_counter()
    refine(folder, timed)
    marks = [t0] + stamps
    parts = [[marks[i + 1] - marks[i] for i in range(k, k + 4)]
             for k in range(0, len(stamps), 4)]
    prof = None
    if profile_last:
        img_dir = os.path.join(folder, "profiled")
        shutil.rmtree(img_dir, ignore_errors=True)
        os.makedirs(img_dir)
        shutil.copy(os.path.join(folder, f"{tags[-1]}_1.TIF"), img_dir)
        shutil.copy(os.path.join(folder, "rough", f"{tags[-1]}.json"), roi_dir)
        stamps.clear()
        prof = profile_run(lambda: refine(img_dir, tags[-1:]))
    return roi_dir, parts, prof


def bundle_files(roi_dir: str, tag: str) -> tuple:
    """(JSON, mask pixels, overlay pixels, zip entry names and bytes)."""
    import zipfile

    import numpy as np
    from PIL import Image

    with open(os.path.join(roi_dir, f"{tag}.json"), encoding="utf-8") as f:
        js = json.load(f)
    with Image.open(os.path.join(roi_dir, "mask", f"{tag}_mask.tif")) as im:
        mask = np.array(im)
    with Image.open(os.path.join(roi_dir, "overlay", f"{tag}_overlay.png")) as im:
        overlay = np.array(im)
    with zipfile.ZipFile(os.path.join(roi_dir, "zip", f"{tag}.zip")) as zf:
        entries = [(i.filename, zf.read(i)) for i in zf.infolist()]
    return js, mask, overlay, entries


def score_refine(roi_dir: str, frames: dict) -> dict:
    """Every frame's refined polygons against the generator's outlines
    through ``evalseg.match_instances`` at IoU >= 0.5 (frames in threads):
    recall and mean IoU over all frames, and how many rough polygons came
    back unrefined."""
    import numpy as np

    from imageprocess_tpu_torch.core import roiio
    from imageprocess_tpu_torch.segment.evalseg import match_instances

    def one(tag):
        polys = roiio.load_roi_polygons(os.path.join(roi_dir, f"{tag}.json"))
        fr = frames[tag]
        if len(polys) != len(fr["rough"]):
            raise SmokeError(f"refine {tag}: {len(polys)} polygons for "
                             f"{len(fr['rough'])} rough ones")
        kept = sum(np.array_equal(p, r) for p, r in zip(polys, fr["rough"]))
        return match_instances(polys, fr["truth"], (H, W), 0.5), kept

    with cf.ThreadPoolExecutor(len(frames)) as pool:
        res = list(pool.map(one, sorted(frames)))
    ious = [iou for m, _ in res for *_, iou in m["pairs"]]
    n_true = sum(len(frames[t]["truth"]) for t in frames)
    return {"recall": len(ious) / n_true, "mean_iou": float(np.mean(ious)),
            "n_true": n_true, "matched": len(ious),
            "unrefined": sum(k for _, k in res)}


def refine_card_vs_cpu(folder: str, frames: dict, card_dir: str, mode: str) -> dict:
    """Stage 1 refined on the card (*card_dir*) against the port on the
    CPU.  Per rough polygon, ``segment_inside_polygon`` on both devices.
    Percentile mode (a sort quantile): equal thresholds, equal polygons and
    equal bundles (JSON, mask pixels, overlay pixels, zip entries), or the
    check fails.  BND mode (its moments are float32 sums in another order):
    thresholds within 1e-5 relative and, unless a pixel of the polygon's
    bbox lies between the two thresholds, the same polygon; when no polygon
    has such a pixel, equal bundles."""
    import numpy as np

    from imageprocess_tpu_torch.segment.autoseg import segment_inside_polygon

    exact = mode == "percentile"
    tag = sorted(frames)[0]
    img = frames[tag]["img"].astype(np.float32)
    p = REFINE_MODES[mode]
    max_rel, free = 0.0, 0
    for poly in frames[tag]["rough"]:
        a, _, pa = segment_inside_polygon(img, poly, p, mode=mode, device="cuda")
        b, _, pb = segment_inside_polygon(img, poly, p, mode=mode, device="cpu")
        rel = abs(a - b) / abs(b)
        max_rel = max(max_rel, rel)
        if rel > (0.0 if exact else 1e-5):
            raise SmokeError(f"refine {mode}: card threshold {a} vs CPU {b}")
        x0, y0 = np.floor(poly.min(0)).astype(int)
        x1, y1 = np.ceil(poly.max(0)).astype(int)
        box = img[max(y0, 0):y1, max(x0, 0):x1]
        lo, hi = min(a, b), max(a, b)
        if ((box >= lo) & (box < hi)).any():
            continue   # BND: a pixel flips between the thresholds, may differ
        free += 1
        if (pa is None) != (pb is None) or (pa is not None and not np.array_equal(pa, pb)):
            raise SmokeError(f"refine {mode}: card polygon != CPU polygon "
                             f"(thresholds {a} / {b}, no pixel between)")
    n = len(frames[tag]["rough"])
    if exact and free != n:
        raise SmokeError(f"refine {mode}: {free} of {n} polygons compared")
    if free == n:
        cpu_dir, _, _ = refine_run(folder, f"{mode}_cpu", mode, "cpu", [tag])
        card, cpu = bundle_files(card_dir, tag), bundle_files(cpu_dir, tag)
        if card[0] != cpu[0] or card[3] != cpu[3]:
            raise SmokeError(f"refine {mode}: card JSON or zip != CPU's")
        for what, x, y in (("mask", card[1], cpu[1]), ("overlay", card[2], cpu[2])):
            if x.shape != y.shape or not np.array_equal(x, y):
                raise SmokeError(f"refine {mode}: card {what} != CPU {what}")
    return {"thr_max_rel": max_rel, "polygons": n, "checked_equal": free,
            "bundle_equal": free == n}


def run_deck(folder: str) -> dict:
    """``run_fret_ppt`` over ``S01_t00_roi1_ratio.png`` / ``_bf.png``
    thumbnails (2 stages x 2 ROIs x 5 timepoints) written with PIL; the deck
    read back with ``read_pptx_summary``."""
    import numpy as np
    from PIL import Image

    from imageprocess_tpu_torch.pipelines.fretppt import run_fret_ppt
    from imageprocess_tpu_torch.report.pptxlite import read_pptx_summary

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(7)
    for s in DECK["stages"]:
        for r in DECK["rois"]:
            for t in range(DECK["times"]):
                for suffix in ("ratio", "bf"):
                    arr = (rng.random((96, 96, 3)) * 255).astype(np.uint8)
                    Image.fromarray(arr).save(
                        os.path.join(folder, f"{s}_t{t:02d}_roi{r}_{suffix}.png"))
    t0 = time.perf_counter()
    ok, path = run_fret_ppt(folder, log=lambda *_: None)
    wall = time.perf_counter() - t0
    if not ok:
        raise SmokeError(f"deck: {path}")
    summary = read_pptx_summary(path)
    n_slides = len(DECK["stages"]) * len(DECK["rois"])
    pics = [s["pictures"] for s in summary["slides"]]
    if pics != [2 * DECK["times"]] * n_slides or \
            len(summary["media"]) != n_slides * 2 * DECK["times"]:
        raise SmokeError(f"deck: pictures per slide {pics}, "
                         f"{len(summary['media'])} media")
    return {"slides": len(pics), "pictures": sum(pics), "s": wall,
            "bytes": os.path.getsize(path)}


def run_refine_path(folder: str) -> dict:
    """ROI refinement on the card (``refine_and_save(device="cuda")``) over
    4 synthcells frames with rough polygons: percentile mode over all four
    (the first warm, the next two steady, the last under
    ``torch.profiler``), BND mode over stage 1, each scored against the
    generator's outlines; ms per polygon of ``segment_inside_polygon``,
    then its phases (CUDA events) and CCL rounds over stage 1; stage 1
    against the CPU, both modes in two threads; then the deck."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.segment.autoseg import segment_inside_polygon
    from imageprocess_tpu_torch.timing import PhaseTimer

    t0 = time.perf_counter()
    frames = make_refine_dataset(folder)
    data_s = time.perf_counter() - t0
    tags = sorted(frames)
    first = tags[0]
    n_polys = {t: len(frames[t]["rough"]) for t in tags}
    runs = {"percentile": refine_run(folder, "percentile", "percentile", "cuda", tags,
                                     profile_last=True),
            "bnd": refine_run(folder, "bnd", "bnd", "cuda", [first])}
    scores = {"percentile": score_refine(runs["percentile"][0], frames),
              "bnd": score_refine(runs["bnd"][0], {first: frames[first]})}
    if scores["percentile"]["recall"] < REFINE_MIN_RECALL:
        raise SmokeError(f"refine: percentile recall {scores['percentile']}")

    img = frames[first]["img"].astype(np.float32)
    loop_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for poly in frames[first]["rough"]:
            segment_inside_polygon(img, poly, REFINE_MODES["percentile"], device="cuda")
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t1)
    timer = PhaseTimer("cuda")
    for poly in frames[first]["rough"]:
        segment_inside_polygon(img, poly, REFINE_MODES["percentile"], device="cuda",
                               timer=timer)
    phases = timer.times_ms()
    prof = runs["percentile"][2]
    with cf.ThreadPoolExecutor(len(REFINE_MODES)) as pool:
        vs_cpu = dict(zip(REFINE_MODES, pool.map(
            lambda mode: refine_card_vs_cpu(folder, frames, runs[mode][0], mode),
            REFINE_MODES)))
    deck = run_deck(os.path.join(folder, "deck"))
    n_all = sum(n_polys.values())
    frame_s = {mode: [sum(parts) for parts in r[1]] for mode, r in runs.items()}
    steady = runs["percentile"][1][1:]
    return {"data_s": data_s, "polygons": n_polys, "frame_s": frame_s,
            "warm_s": frame_s["percentile"][0],
            "steady_s": sum(frame_s["percentile"][1:]) / len(steady),
            "steady_parts_s": [sum(col) / len(steady) for col in zip(*steady)],
            "ms_per_polygon": 1e3 * min(loop_s) / n_polys[first],
            "loop_s": loop_s, "n_all": n_all, "scores": scores,
            "phases_ms": phases, "counts": dict(timer.counts),
            "profiled": tags[-1], "profile": prof,
            "launches_per_polygon": prof["events"] / n_polys[tags[-1]],
            "vs_cpu": vs_cpu, "deck": deck}


# ------------------------------------------------------------------ the command line

CLI_TIMEOUT = 300          # s, each subprocess of the CLI phase
REFINE_CROP = (768, 1024)  # the top-left quarter of refine's stage 1


def tree_files(root: str) -> dict:
    """{relative path: bytes, or {entry: bytes} for a zip archive (XLSX,
    PPTX, ImageJ zip: entry times differ)} under *root*, the run logs
    (named by their start time) and the profiler traces left out."""
    import zipfile

    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            rel = os.path.relpath(p, root)
            if rel.split(os.sep)[0] == "logs" or n.endswith(".pt.trace.json"):
                continue
            if zipfile.is_zipfile(p):
                with zipfile.ZipFile(p) as z:
                    out[rel] = {i: z.read(i) for i in z.namelist()}
            else:
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return out


def same_tree(got: str, want: str, what: str, expect=()) -> int:
    """The files under *got* equal those under *want* (bytes; zip archives
    entry by entry), and include *expect*; returns the number of files."""
    g, w = tree_files(got), tree_files(want)
    if sorted(g) != sorted(w):
        raise SmokeError(f"CLI {what}: files {sorted(g)} vs {sorted(w)}")
    bad = [k for k in w if g[k] != w[k]]
    if bad:
        raise SmokeError(f"CLI {what}: {bad[:3]} differ from the direct call's")
    missing = [e for e in expect if e not in w]
    if missing:
        raise SmokeError(f"CLI {what}: {missing} not written")
    return len(w)


def cli_subprocess(args, what: str) -> tuple:
    """``python3 -m imageprocess_tpu_torch.cli *args*`` from the checkout's
    root, without ``--device``: (wall seconds, stdout)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "imageprocess_tpu_torch.cli", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise SmokeError(f"CLI {what}: exit {res.returncode}: "
                         f"{(res.stderr or res.stdout).strip()[-600:]}")
    return wall, res.stdout


def run_cli_phase(data: str, card_kind: str, direct: dict) -> dict:
    """The port's command line as users run it, on the card (no
    ``--device``).  *direct* holds the earlier phases' direct calls of
    ``run_intensity`` ("serial") and ``run_fret_batched`` ("fret"), their
    launch counts; their reports, and ``run_intensity_batched``'s, lie under
    ``RES_serial``, ``RES_fret`` and ``RES_smoke``.

    - ``intensity`` at full width as a subprocess: its report equals
      ``run_intensity``'s, byte for byte; its wall seconds against the
      direct call in this process (the CLI's overhead: interpreter, imports,
      CUDA context, kernel libraries; ``--help`` alone as well);
    - in process, ``cli.main`` for ``intensity`` (turns with the direct call
      as the CLI makes it: argparse and the config), ``intensity --batched``
      (the runner's default batch, against a direct call with it) and
      ``fret``: launches counted around each call equal the direct runners',
      reports equal theirs;
    - ``nesprin2 --batched`` (stage 1), ``morphology`` (tables), ``fa
      --batched``, ``crop`` (stage 1), ``roi-auto --backend unet`` (refine's
      four synthcells frames), ``refine`` (a quarter of refine's stage 1)
      and ``ppt`` (the deck's thumbnails): every file equals the direct
      call's on the same input;
    - ``--xprof DIR`` as a subprocess: the trace parses as JSON and names
      the ``roistats_f32`` kernel once per key;
    - ``doctor --json`` as a subprocess: every check ok, ``backend``
      naming the card and both kernels, ``mesh`` the virtual 4-shard mesh
      of the card."""
    import contextlib
    import io

    import numpy as np
    import torch

    from imageprocess_tpu_torch import cli
    from imageprocess_tpu_torch import native
    from imageprocess_tpu_torch.core import roiio, tiffio
    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
    from imageprocess_tpu_torch.pipelines import crop, intensity
    from imageprocess_tpu_torch.pipelines import morphology, nesprin2
    from imageprocess_tpu_torch.segment import auto, drawer

    root = os.path.join(data, "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    quiet = lambda *_: None  # noqa: E731
    steps, launches = {}, {}
    channels = [str(c) for c in CHANNELS]
    colors = ["--colors", "2=Green", "3=Red"]

    def out(name):
        return os.path.join(root, name)

    def main(name, argv):
        """``cli.main(argv)`` in this process, its log captured, the
        launches of both kernels counted around it."""
        rsk.reset_launches()
        tsk.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--lang", "en"])
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        text = buf.getvalue()
        if rc != 0 or "[ERROR]" in text or "[error]" in text:
            raise SmokeError(f"CLI {name}: exit {rc}: {text[-600:]}")
        return {"roistats_f32": rsk.launches["roistats_f32"],
                "tilestats_u16": tsk.launches["tilestats_u16"]}

    def counted(fn):
        rsk.reset_launches()
        tsk.reset_launches()
        fn()
        torch.cuda.synchronize()
        return {"roistats_f32": rsk.launches["roistats_f32"],
                "tilestats_u16": tsk.launches["tilestats_u16"]}

    def want(name, got, expect):
        if got != expect or not any(got.values()):
            raise SmokeError(f"CLI {name}: launches {got}, the direct call's {expect}")

    # full width, as a subprocess with no --device
    argv = ["intensity", data, "--channels", *channels, *colors]
    steps["intensity (subprocess)"], _ = cli_subprocess(
        argv + ["--out", out("sub"), "--lang", "en"], "intensity (subprocess)")
    same_tree(os.path.join(out("sub"), "xls"), os.path.join(data, "RES_serial", "xls"),
              "intensity (subprocess) vs run_intensity", ["fluor_intensity_perROI.csv"])
    steps["--help (subprocess)"], _ = cli_subprocess(["--help"], "--help")

    # in process: the CLI and the direct call as the CLI makes it, in turns
    cfg = intensity.IntensityConfig(channels=CHANNELS, channel_colors={2: "Green", 3: "Red"})

    def direct_serial():
        t0 = time.perf_counter()
        intensity.run_intensity(data, cfg, out_root=out("direct"), log=quiet,
                                run_log=True, progress=True, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    turns = []
    for k in range(4):
        if k in (0, 3):
            turns.append(direct_serial())
        else:
            got = main("intensity", argv + ["--out", out("serial")])
            turns.append(steps["intensity"])
            want("intensity", got, {"roistats_f32": direct["serial"]["launches"],
                                    "tilestats_u16": 0})
            launches["intensity"] = got
    same_tree(os.path.join(out("serial"), "xls"), os.path.join(data, "RES_serial", "xls"),
              "intensity vs run_intensity", ["fluor_intensity_perROI.csv"])
    direct_s, cli_s = min(turns[0], turns[3]), min(turns[1], turns[2])

    got = main("intensity --batched", argv + ["--batched", "--out", out("batched")])
    ref = counted(lambda: intensity.run_intensity_batched(
        data, cfg, out_root=out("batched_direct"), log=quiet, device="cuda"))
    want("intensity --batched", got, ref)
    launches["intensity --batched"] = got
    same_tree(os.path.join(out("batched"), "xls"), os.path.join(data, "RES_smoke", "xls"),
              "intensity --batched vs run_intensity_batched", ["fluor_intensity_perROI.csv"])
    if not os.path.exists(os.path.join(out("batched"), "logs")):
        raise SmokeError("CLI intensity --batched: no RES/logs/run_*.txt")

    got = main("fret", ["fret", data, "--donor-ch", channels[0], "--acceptor-ch",
                        channels[1], "--out", out("fret")])
    want("fret", got, {"roistats_f32": direct["fret"]["launches"], "tilestats_u16": 0})
    launches["fret"] = got
    same_tree(os.path.join(out("fret"), "xls"), os.path.join(data, "RES_fret", "xls"),
              "fret vs run_fret_batched", ["fret_ratio_perROI.csv"])

    # smaller runs, each against the direct call on the same input
    files = {}
    n2_argv = ["--donor-ch", channels[0], "--fret-ch", channels[1], "--px-um", str(N2_PX_UM),
               "--rim-um", str(N2_RIM_UM), "--subset-stage", "1"]
    got = main("nesprin2 --batched", ["nesprin2", data, *n2_argv, "--batched",
                                      "--out", out("n2")])
    ref = counted(lambda: nesprin2.run_nesprin2_batched(
        data, n2_config("annulus off", subset_stage=1), out_root=out("n2_direct"),
        log=quiet, device="cuda"))
    want("nesprin2 --batched", got, ref)
    launches["nesprin2 --batched"] = got
    files["nesprin2 --batched"] = same_tree(out("n2"), out("n2_direct"), "nesprin2",
                                            [os.path.join("xls", "nesprin2_fret_perROI.csv")])

    main("morphology", ["morphology", data, "--px-um", str(N2_PX_UM), "--channel",
                        channels[0], "--no-full", "--no-crop", "--out", out("mor")])
    morphology.run_morphology(data, morphology.MorConfig(
        px_um=N2_PX_UM, sel_ch=CHANNELS[0], save_full=False, save_crop=False),
        out_root=out("mor_direct"), log=quiet, device="cuda")
    files["morphology"] = same_tree(out("mor"), out("mor_direct"), "morphology",
                                    [os.path.join("xls", "morphology_perROI.csv")])

    fa_dir = os.path.join(data, "fa")
    main("fa --batched", ["fa", fa_dir, "--roi-dir", os.path.join(fa_dir, "roi"),
                          "--out", out("fa"), "--channel", str(FA_CHANNEL),
                          "--px-size", str(N2_PX_UM), "--alpha", "3", "--close-radius",
                          "1", "--batched"])
    files["fa --batched"] = same_tree(out("fa"), os.path.join(fa_dir, "RES_fa_batched"),
                                      "fa --batched vs run_fa_batched",
                                      ["FA_Results_Master.xlsx"])

    main("crop", ["crop", data, "--channel", channels[0], "--subset-stage", "1",
                  "--out", out("crop")])
    crop.run_crop(data, os.path.join(data, "roi"), out("crop_direct"),
                  crop.CropConfig(channel=CHANNELS[0], subset_stage=1), log=quiet,
                  device="cuda")
    files["crop"] = same_tree(out("crop"), out("crop_direct"), "crop")

    refine_dir = os.path.join(data, "refine")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # two forwards, one algorithm
    try:
        main("roi-auto --backend unet", ["roi-auto", refine_dir, "--backend", "unet",
                                         "--channel", "1", "--out", out("auto")])
        auto.run_auto_drawer(refine_dir, auto.AutoSegConfig(backend="unet", channel=1),
                             roi_dir=out("auto_direct"), log=quiet, device="cuda")
    finally:
        torch.backends.cudnn.deterministic = prev
    files["roi-auto --backend unet"] = same_tree(
        out("auto"), out("auto_direct"), "roi-auto",
        [f"S{s:02d}.json" for s in range(1, REFINE_STAGES + 1)])

    # refine: the top-left quarter of stage 1 and the rough polygons inside it
    hq, wq = REFINE_CROP
    img_dir = out("refine_img")
    os.makedirs(img_dir)
    frame = native.decode_tiff(os.path.join(refine_dir, "S01_1.TIF"))
    tiffio.write_tiff16(os.path.join(img_dir, "S01_1.TIF"),
                        np.ascontiguousarray(frame[:hq, :wq]))
    rough = [p for p in roiio.load_roi_polygons(os.path.join(refine_dir, "rough", "S01.json"))
             if p[:, 0].max() < wq - 1 and p[:, 1].max() < hq - 1]
    if not rough:
        raise SmokeError("CLI refine: no rough polygon inside the quarter frame")
    for name in ("refine", "refine_direct"):
        roiio.save_roi_bundle(os.path.join(out(name), "S01.json"), "S01", (hq, wq), rough)
    main("refine", ["refine", img_dir, "--thr", str(REFINE_MODES["percentile"]),
                    "--out", out("refine")])
    drawer.refine_and_save(img_dir, drawer.RefineConfig(thr_param=REFINE_MODES["percentile"]),
                           roi_dir=out("refine_direct"), log=quiet, device="cuda")
    files["refine"] = same_tree(out("refine"), out("refine_direct"), "refine", [
        "S01.json", os.path.join("mask", "S01_mask.tif"),
        os.path.join("overlay", "S01_overlay.png"), os.path.join("zip", "S01.zip")])

    deck = out("deck")
    shutil.copytree(os.path.join(refine_dir, "deck"), deck,
                    ignore=shutil.ignore_patterns("*.pptx"))
    main("ppt", ["ppt", deck])
    files["ppt"] = same_tree(deck, os.path.join(refine_dir, "deck"), "ppt vs run_fret_ppt",
                             ["FRET_timelapse_auto.pptx"])

    # --xprof, as a subprocess with no --device
    trace_dir = out("trace")
    steps["intensity --xprof (subprocess)"], _ = cli_subprocess(
        argv + ["--out", out("xprof"), "--xprof", trace_dir, "--lang", "en"],
        "intensity --xprof")
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise SmokeError(f"CLI --xprof: traces {traces}")
    with open(os.path.join(trace_dir, traces[0]), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernel_events = [e for e in events if e.get("cat") == "kernel"
                     and "roi_stats_f32" in e.get("name", "")]
    if len(kernel_events) != direct["serial"]["launches"]:
        raise SmokeError(f"CLI --xprof: {len(kernel_events)} roi_stats_f32 kernels in the "
                         f"trace, want {direct['serial']['launches']}")
    launches["intensity --xprof (trace)"] = {"roistats_f32": len(kernel_events),
                                             "tilestats_u16": 0}

    # doctor
    steps["doctor --json (subprocess)"], text = cli_subprocess(
        ["doctor", "--json", "--backend-timeout", "240", "--lang", "en"], "doctor")
    report = json.loads(next(ln for ln in text.splitlines() if ln.startswith("{")))
    status = {k: v["status"] for k, v in report["checks"].items()}
    backend = report["checks"]["backend"]["detail"]
    if status != {"deps": "ok", "native": "ok", "numerics": "ok", "write": "ok",
                  "backend": "ok", "mesh": "ok"} or not report["ok"] \
            or card_kind not in backend or "tilestats_u16" not in backend \
            or "roistats_f32" not in backend \
            or "virtual 4-shard cuda mesh" not in report["checks"]["mesh"]["detail"]:
        raise SmokeError(f"CLI doctor: {report}")
    shutil.rmtree(root, ignore_errors=True)
    return {"steps_s": steps, "launches": launches, "files": files,
            "refine_polygons": len(rough),
            "direct_s": direct_s, "cli_s": cli_s, "turns_s": turns,
            "doctor": {k: v["detail"] for k, v in report["checks"].items()}}


# ------------------------------------------------------------------ the figures

FIG_STAGES = 2             # of the tables dataset (rim-FRET panel) and of the FA experiment


def _same_pngs(card_root: str, cpu_root: str, names, what: str) -> int:
    """The PNGs *names* under both roots are equal pixel for pixel; returns
    how many."""
    import numpy as np
    from PIL import Image

    for name in names:
        a = np.asarray(Image.open(os.path.join(card_root, name)).convert("RGB"))
        b = np.asarray(Image.open(os.path.join(cpu_root, name)).convert("RGB"))
        if a.shape != b.shape or not np.array_equal(a, b):
            diff = "canvas" if a.shape != b.shape else int((a != b).any(-1).sum())
            raise SmokeError(f"{what} {name}: the card's PNG differs from the CPU's "
                             f"({diff} pixels)")
    return len(names)


def write_mat_v73(path: str, polys) -> None:
    """A MATLAB-v7.3-layout boundary file (dataset ``bdokcc``, a cell of
    cells of references onto (2, N) [y; x] arrays), one boundary a cell."""
    import h5py
    import numpy as np

    with h5py.File(path, "w") as f:
        refs = f.create_group("#refs#")
        outer = []
        for i, p in enumerate(polys):
            d = refs.create_dataset(f"c{i}", data=np.asarray(p, float)[:, [1, 0]].T)
            cell = refs.create_dataset(f"cell{i}", data=np.array(
                [d.ref], dtype=h5py.ref_dtype)[:, None])
            outer.append(cell.ref)
        f.create_dataset("bdokcc", data=np.array(outer, dtype=h5py.ref_dtype)[:, None])


def run_figures(data: str) -> dict:
    """The figures that the JAX package lays out with matplotlib.

    - The rim-FRET 2-up panel: ``run_nesprin2`` and ``run_nesprin2_batched``
      (annulus and QC, ``do_png``, ``save_panel``, ``add_scalebar``) on
      ``FIG_STAGES`` stages of the tables dataset with ``IMAGE_ROIS`` ROIs,
      on the card (every ``roistats_f32`` launch held to its plain version)
      and once without the panel (launches equal, seconds per panel from
      the difference), then on the CPU: the panels equal pixel for pixel.
    - ``fa --figs --export-crops`` through ``cli.main`` on the card (no
      ``--device``) over ``FIG_STAGES`` stages of the FA experiment (18
      cells each), with ``--mat-dir`` and a crafted v7.3 file for S01 where
      h5py imports; the figures and crops equal the direct CPU calls' pixel
      for pixel; then the direct card calls timed (seconds per overview
      figure and per crop, each with its stage's ``analyze_image`` rerun,
      timed alone too)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from imageprocess_tpu_torch import cli
    from imageprocess_tpu_torch.core import roiio, tiffio
    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
    from imageprocess_tpu_torch.pipelines import fa, nesprin2

    quiet = lambda *_: None  # noqa: E731
    root = os.path.join(data, "figures")
    shutil.rmtree(root, ignore_errors=True)
    n2_dir = os.path.join(root, "n2")
    os.makedirs(os.path.join(n2_dir, "roi"))
    for s in range(1, FIG_STAGES + 1):
        for ch in CHANNELS:
            shutil.copy(os.path.join(data, f"S{s:02d}_{ch}.TIF"), n2_dir)
        roiio.save_roi_bundle(os.path.join(n2_dir, "roi", f"S{s:02d}.json"), f"S{s:02d}",
                              (H, W), bench_polys()[:IMAGE_ROIS])
    res = {"panel": {}}

    def n2_run(runner, out, device, panel):
        cfg = n2_config("annulus on + QC", do_xls=False, do_png=True, save_panel=panel,
                        add_scalebar=True)
        return getattr(nesprin2, runner)(n2_dir, cfg, out_root=os.path.join(root, out),
                                         log=quiet, device=device)

    panel_dir = os.path.join("PNG", "panel")
    cpu_rows = n2_run("run_nesprin2", "n2_cpu", "cpu", True)
    panels = sorted(os.path.join(panel_dir, f) for f in os.listdir(
        os.path.join(root, "n2_cpu", panel_dir)))
    if len(panels) != FIG_STAGES:
        raise SmokeError(f"panel: the CPU run wrote {panels}")
    for runner in ("run_nesprin2", "run_nesprin2_batched"):
        t0 = time.perf_counter()
        rsk.reset_launches()
        plain_rows = n2_run(runner, f"n2_{runner}_plain", "cuda", False)
        torch.cuda.synchronize()
        plain_s, plain_launches = time.perf_counter() - t0, rsk.launches["roistats_f32"]
        t0 = time.perf_counter()
        rsk.reset_launches()
        with CheckedRoiRows(f"{runner} save_panel") as chk:
            rows = n2_run(runner, f"n2_{runner}", "cuda", True)
        torch.cuda.synchronize()
        panel_s, launches = time.perf_counter() - t0, rsk.launches["roistats_f32"]
        if launches != plain_launches or launches != 2 * FIG_STAGES \
                or len(chk.errs) != launches:
            raise SmokeError(f"panel {runner}: {launches} roistats_f32 launches "
                             f"({len(chk.errs)} checked), {plain_launches} without the "
                             f"panel, want {2 * FIG_STAGES}")
        if os.path.exists(os.path.join(root, f"n2_{runner}_plain", panel_dir)):
            raise SmokeError(f"panel {runner}: a run without save_panel wrote panels")
        _rows_equal(rows, plain_rows, f"{runner} with the panel vs without",
                    ("_mean", "_std", "_vsum"), FIG_STAGES * IMAGE_ROIS)
        _rows_equal(rows, cpu_rows, f"{runner} card vs CPU", ("_mean", "_std", "_vsum"),
                    FIG_STAGES * IMAGE_ROIS)
        res["panel"][runner] = {
            "launches": launches, "launches_without_panel": plain_launches,
            "compared": _same_pngs(os.path.join(root, f"n2_{runner}"),
                                   os.path.join(root, "n2_cpu"), panels,
                                   f"panel {runner}"),
            "s": panel_s, "s_without_panel": plain_s,
            "s_per_panel": (panel_s - plain_s) / FIG_STAGES, **chk.worst()}

    # fa --figs --export-crops through the command line, on the card
    fa_src, fa_dir = os.path.join(data, "fa"), os.path.join(root, "fa")
    os.makedirs(os.path.join(fa_dir, "roi"))
    for s in range(1, FIG_STAGES + 1):
        shutil.copy(os.path.join(fa_src, f"S{s:02d}_{FA_CHANNEL}.TIF"), fa_dir)
        shutil.copy(os.path.join(fa_src, "roi", f"S{s:02d}.json"),
                    os.path.join(fa_dir, "roi"))
    try:
        import h5py
        res["h5py"] = h5py.__version__
    except ImportError:
        res["h5py"] = None
    mat_dir = None
    if res["h5py"]:
        mat_dir = os.path.join(root, "mat")
        os.makedirs(mat_dir)
        write_mat_v73(os.path.join(mat_dir, "BNDb_e1s1.mat"),
                      [_circle(150 + 200 * i, 150, 40.0) for i in range(3)])
    argv = ["fa", fa_dir, "--roi-dir", os.path.join(fa_dir, "roi"), "--channel",
            str(FA_CHANNEL), "--px-size", str(N2_PX_UM), "--alpha", "3",
            "--close-radius", "1", "--figs", "--export-crops", "--lang", "en"]
    if mat_dir:
        argv += ["--mat-dir", mat_dir]
    rsk.reset_launches()
    tsk.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--out", os.path.join(root, "fa_cli")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    if rc != 0 or "[ERROR]" in buf.getvalue():
        raise SmokeError(f"CLI fa --figs --export-crops: exit {rc}: {buf.getvalue()[-600:]}")
    cfg = fa_config()
    cpu_root = os.path.join(root, "fa_cpu")
    figs = fa.save_fa_figs(fa_dir, os.path.join(fa_dir, "roi"), cpu_root, cfg,
                           mat_dir=mat_dir, log=quiet, device="cpu")
    crops = fa.export_fa_crops(fa_dir, os.path.join(fa_dir, "roi"), cpu_root, cfg,
                               log=quiet, device="cpu")
    names = sorted(os.path.relpath(p, cpu_root) for p in figs + crops)
    got = sorted(_png_files(os.path.join(root, "fa_cli")))
    if got != names or len(figs) != FIG_STAGES or len(crops) != FIG_STAGES * N_ROI:
        raise SmokeError(f"CLI fa figures: {got[:4]}... ({len(got)}) vs the direct "
                         f"calls' {names[:4]}... ({len(names)})")
    compared = _same_pngs(os.path.join(root, "fa_cli"), cpu_root, names,
                          "CLI fa --figs --export-crops")
    if mat_dir:     # the overlay is drawn: magenta in S01's figure, none in S02's
        from PIL import Image

        for s, want in ((1, True), (2, False)):
            a = np.asarray(Image.open(os.path.join(cpu_root, "fig", f"S{s:02d}_FA.png"))
                           .convert("RGB")).astype(int)
            magenta = ((a[..., 0] > 180) & (a[..., 2] > 180) & (a[..., 1] < 100)).sum()
            if (magenta > 0) != want:
                raise SmokeError(f"fa --mat-dir: {magenta} magenta pixels in S{s:02d}")
    # the direct calls on the card, timed, and analyze_image alone
    card_root = os.path.join(root, "fa_card")
    t0 = time.perf_counter()
    fa.save_fa_figs(fa_dir, os.path.join(fa_dir, "roi"), card_root, cfg,
                    mat_dir=mat_dir, log=quiet, device="cuda")
    torch.cuda.synchronize()
    figs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fa.export_fa_crops(fa_dir, os.path.join(fa_dir, "roi"), card_root, cfg,
                       log=quiet, device="cuda")
    torch.cuda.synchronize()
    crops_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for img_path, json_path, _ in fa.list_fa_pairs(fa_dir, os.path.join(fa_dir, "roi"),
                                                    FA_CHANNEL):
        fa.analyze_image(tiffio.read_2d(img_path, squeeze="smallest_axis"),
                         fa._load_rois(json_path), cfg, device="cuda")
    torch.cuda.synchronize()
    analyze_s = (time.perf_counter() - t0) / FIG_STAGES
    res["fa"] = {"cli_s": cli_s, "files": compared, "mat_dir": bool(mat_dir),
                 "launches": {"roistats_f32": rsk.launches["roistats_f32"],
                              "tilestats_u16": tsk.launches["tilestats_u16"]},
                 "s_per_figure": figs_s / FIG_STAGES,
                 "s_per_crop": crops_s / (FIG_STAGES * N_ROI),
                 "analyze_s_per_stage": analyze_s}
    shutil.rmtree(root, ignore_errors=True)
    return res


# ------------------------------------------------------------------ the mesh

MESH_SHARDS = 4                      # virtual shards on cuda:0
MESH_BATCH = 8                       # chunk size: 2 frames per shard


def _same_rows(got, want, what: str) -> None:
    """Two row lists equal, value for value (NaN where NaN)."""
    if len(got) != len(want):
        raise SmokeError(f"{what}: {len(got)} rows, want {len(want)}")
    for a, b in zip(got, want):
        if list(a) != list(b):
            raise SmokeError(f"{what}: columns differ")
        for k, v in b.items():
            w = a[k]
            if not (w == v or (isinstance(v, float) and math.isnan(v)
                               and isinstance(w, float) and math.isnan(w))):
                raise SmokeError(f"{what}: {k} {w!r} != {v!r} (stage "
                                 f"{b.get('stage', b.get('Image'))})")


def run_mesh_runners(data: str, fa_dir: str) -> dict:
    """The four batched tables runners, each run three ways on the card --
    no mesh, ``make_mesh(1)`` and a virtual mesh of ``MESH_SHARDS`` shards
    on cuda:0 -- at chunk size ``MESH_BATCH``.  Per way a checked run
    (every tile-step launch held to its plain version on the same device
    tensors; the launch counts set to 0 just before the run and read just
    after) and a timed run (counts read again).  The tables equal the
    no-mesh run's; the launches of ``tilestats_u16`` and ``roistats_f32``
    equal the chunks times the shards (times two with the annulus) --
    none on the FA path, which has no hand kernel."""
    import torch

    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
    from imageprocess_tpu_torch.parallel import runner
    from imageprocess_tpu_torch.parallel.runner import Mesh, make_mesh
    from imageprocess_tpu_torch.pipelines import fa, fret, intensity, nesprin2

    workers = max(8, (os.cpu_count() or 1) * 2)
    logs = []
    q = dict(log=logs.append, batch_size=MESH_BATCH, prefetch_workers=workers,
             device="cuda")
    chunks = -(-N_STAGES // MESH_BATCH)
    n2_name = "annulus on + QC"
    runs = {  # name: (run(mesh, out), launches per chunk and shard)
        "run_intensity_batched": (lambda mesh, out: intensity.run_intensity_batched(
            data, intensity.IntensityConfig(channels=CHANNELS, do_xls=False),
            out_root=out, mesh=mesh, **q), {"tilestats_u16": 1, "roistats_f32": 0}),
        "run_fret_batched": (lambda mesh, out: fret.run_fret_batched(
            data, fret.FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1],
                                  do_xls=False), out_root=out, mesh=mesh, **q),
            {"tilestats_u16": 0, "roistats_f32": 1}),
        "run_nesprin2_batched": (lambda mesh, out: nesprin2.run_nesprin2_batched(
            data, n2_config(n2_name, do_xls=False), out_root=out, mesh=mesh, **q),
            {"tilestats_u16": 0, "roistats_f32": N2_CONFIGS[n2_name][1]}),
        "run_fa_batched": (lambda mesh, out: fa.run_fa_batched(
            fa_dir, os.path.join(fa_dir, "roi"), out, fa_config(do_master_report=False),
            mesh=mesh, **q), {"tilestats_u16": 0, "roistats_f32": 0}),
    }
    meshes = {"no mesh": (None, 1), "make_mesh(1)": (make_mesh(1), 1),
              f"virtual {MESH_SHARDS}-shard": (Mesh(("cuda:0",) * MESH_SHARDS),
                                               MESH_SHARDS)}
    real_t, real_f = runner.batched_tile_stats_step, runner.batched_fret_tile_stats_step
    errs = {"tilestats_u16": [], "roistats_f32": []}

    def checked_t(tiles, lp, valid, bgs, *, clip_neg=True):
        out = real_t(tiles, lp, valid, bgs, clip_neg=clip_neg)
        errs["tilestats_u16"].append(compare_packed(out, tsk.tile_stats_packed_plain(
            tiles, lp, valid, bgs, clip_neg=clip_neg), "mesh tilestats launch"))
        return out

    def checked_f(tiles, lp, valid, bgs, eps, *, clip_neg=True, flip=False):
        out = real_f(tiles, lp, valid, bgs, eps, clip_neg=clip_neg, flip=flip)
        errs["roistats_f32"].append(compare_packed(out, rsk.fret_tile_stats_packed_plain(
            tiles, lp, valid, bgs, eps, clip_neg=clip_neg, flip=flip),
            "mesh FRET launch"))
        return out

    def counts():
        return {"tilestats_u16": tsk.launches["tilestats_u16"],
                "roistats_f32": rsk.launches["roistats_f32"]}

    out = {}
    for name, (run, per) in runs.items():
        base = None
        for label, (mesh, shards) in meshes.items():
            dest = os.path.join(data, "RES_mesh", name, label.replace(" ", "_"))
            want = {k: v * chunks * shards for k, v in per.items()}
            runner.batched_tile_stats_step = checked_t
            runner.batched_fret_tile_stats_step = checked_f
            try:
                with CheckedRoiRows(f"mesh {name} {label}") as chk:
                    tsk.reset_launches()
                    rsk.reset_launches()
                    rows = run(mesh, dest)
                    torch.cuda.synchronize()
                    checked = counts()
            finally:
                runner.batched_tile_stats_step = real_t
                runner.batched_fret_tile_stats_step = real_f
            errs["roistats_f32"].extend(chk.errs)
            tsk.reset_launches()
            rsk.reset_launches()
            t0 = time.perf_counter()
            rows_t = run(mesh, dest)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts()
            for got in (checked, launches):
                if got != want:
                    raise SmokeError(f"{name} ({label}): launches {got}, want {want} "
                                     f"({chunks} chunks x {shards} shards)")
            if name == "run_fa_batched":
                rows = [r for tag in sorted(rows) for r in rows[tag]]
                rows_t = [r for tag in sorted(rows_t) for r in rows_t[tag]]
            if base is None:
                base = rows
                if len(rows) < N_STAGES:
                    raise SmokeError(f"{name}: {len(rows)} rows: {logs[-3:]}")
            _same_rows(rows, base, f"{name} ({label}) vs no mesh")
            _same_rows(rows_t, base, f"{name} ({label}, timed run) vs no mesh")
            out[f"{name} ({label})"] = {"rows": len(rows), "wall_s": wall,
                                         "launches": launches}
    bad = [line for line in logs if "ERROR" in str(line) or "오류" in str(line)]
    if bad:
        raise SmokeError(f"mesh runners logged errors: {bad[:3]}")
    return {"runs": out, "checked_launches": {k: len(v) for k, v in errs.items()},
            "max_abs_err": {k: max((e["max_abs_err"] for e in v), default=0.0)
                            for k, v in errs.items()}}


def run_mesh_seg() -> dict:
    """``label_frame_unet`` on the synthcells frame with the virtual mesh
    (the tile batch split over the shards, one replica per shard device):
    after a warm run, turns without / with / with / without the mesh; every
    label map equals the first; the best seconds of each."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.parallel.runner import Mesh
    from imageprocess_tpu_torch.segment import auto, cellseg

    frame, _ = seg_frame()
    model, tile = auto._unet_model(auto.AutoSegConfig(backend="unet"), "cuda")
    mesh = Mesh(("cuda:0",) * MESH_SHARDS)
    want = cellseg.label_frame_unet(frame, model, tile=tile, device="cuda")
    times = {"s": [], "mesh_s": []}
    for key in ("s", "mesh_s", "mesh_s", "s"):
        t0 = time.perf_counter()
        lab = cellseg.label_frame_unet(frame, model, tile=tile, device="cuda",
                                       mesh=mesh if key == "mesh_s" else None)
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
        if not np.array_equal(lab, want):
            raise SmokeError(f"seg ({key}): labels differ on "
                             f"{int((lab != want).sum())} pixels from the first run")
    return {"labels": int(want.max()), **{k: min(v) for k, v in times.items()}}


def run_mesh_frame_ops(fa_dir: str) -> dict:
    """Every ``parallel.spatial`` function on a 1536 x 2048 FA frame split
    over the virtual mesh (``MESH_SHARDS`` shards of 384 rows) against the
    port's whole-frame op on the card: masks and labels bit-equal,
    quantiles and backgrounds equal, the FA mean / deviation within
    REL_TOL; seconds of each sharded call."""
    import numpy as np
    import torch

    from imageprocess_tpu_torch.core import tiffio
    from imageprocess_tpu_torch.geom.rasterize import rasterize_polygons
    from imageprocess_tpu_torch.morphology import binary, ccl, edt
    from imageprocess_tpu_torch.ops.percentile import masked_quantile
    from imageprocess_tpu_torch.parallel import spatial
    from imageprocess_tpu_torch.parallel.runner import Mesh
    from imageprocess_tpu_torch.pipelines.fa import fa_global_stats

    mesh = Mesh(("cuda:0",) * MESH_SHARDS, "rows")
    dev = torch.device("cuda", 0)
    img = tiffio.read_2d(os.path.join(fa_dir, f"S01_{FA_CHANNEL}.TIF"), dtype=None)
    x = torch.from_numpy(img.astype(np.float32)).to(dev)
    polys = torch.from_numpy(np.stack([p.astype(np.float32) for p in bench_polys()]))
    cells = rasterize_polygons(polys.to(dev), img.shape).any(dim=0)
    mu, sd, bg = (float(v) for v in fa_global_stats(img, device="cuda"))
    blobs = (x > mu + 3.0 * sd) & cells
    k, rim, a_in, a_out, close_r = 3, 4, 4, 8, 1    # window radii in px
    sq = np.ones((2 * k + 1, 2 * k + 1), bool)
    cases = {  # name: (sharded call, whole-frame result)
        "shard_frame": (lambda: spatial.shard_frame(mesh, img),
                        torch.from_numpy(img.astype(np.int32)).to(dev)),
        "sharded_quantile_u16": (lambda: spatial.sharded_quantile_u16(mesh, 1000)(img),
                                 masked_quantile(x, torch.ones_like(cells), 1000)),
        "sharded_bg_correct_u16": (
            lambda: spatial.sharded_bg_correct_u16(mesh, 1000)(img),
            torch.clamp(x - masked_quantile(x, torch.ones_like(cells), 1000), min=0.0)),
        "sharded_square_dilation": (lambda: spatial.sharded_square_dilation(mesh, k)(blobs),
                                    binary.square_dilation(blobs, k)),
        "sharded_square_erosion": (lambda: spatial.sharded_square_erosion(mesh, k)(cells),
                                   binary.binary_erosion(cells, sq, True)),
        "sharded_rim_mask": (lambda: spatial.sharded_rim_mask(mesh, rim)(cells),
                             edt.rim_mask(cells, rim)),
        "sharded_annulus_mask": (
            lambda: spatial.sharded_annulus_mask(mesh, a_in, a_out)(cells),
            binary.annulus_mask(cells, a_in, a_out)),
        "sharded_label": (lambda: spatial.sharded_label(mesh, 2, 4096)(blobs),
                          ccl.label(blobs, 2)),
        "sharded_remove_small": (lambda: spatial.sharded_remove_small(mesh, 40, 1, 4096)(blobs),
                                 ccl.remove_small_objects(blobs, 40, 1)),
        "sharded_closing_disk": (lambda: spatial.sharded_closing_disk(mesh, close_r)(blobs),
                                 binary.binary_closing_skimage(blobs, binary.disk(close_r))),
    }
    out = {}
    for name, (call, want) in cases.items():
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        got = got.gather(dev) if isinstance(got, spatial.RowShards) else got
        if got.dtype == torch.uint16:
            got = got.to(torch.int32)
        if got.shape != want.shape or not torch.equal(
                got.nan_to_num(-1.0) if got.is_floating_point() else got,
                want.nan_to_num(-1.0) if want.is_floating_point() else want):
            raise SmokeError(f"{name} on the mesh differs from the whole-frame op")
    t0 = time.perf_counter()
    smu, ssd, sbg = spatial.sharded_fa_stats(mesh)(img)
    out["sharded_fa_stats"] = time.perf_counter() - t0
    if sbg != bg or abs(smu - mu) > REL_TOL * abs(mu) or abs(ssd - sd) > REL_TOL * abs(sd):
        raise SmokeError(f"sharded_fa_stats ({smu}, {ssd}, {sbg}) vs the frame's "
                         f"({mu}, {sd}, {bg})")
    t0 = time.perf_counter()
    lab, thr, sbg = spatial.sharded_fa_segment(mesh, 3.0, 40.0, close_r, 4096)(img, cells)
    out["sharded_fa_segment"] = time.perf_counter() - t0
    bw = (x > torch.tensor(mu + 3.0 * sd, dtype=torch.float32)) & cells
    bw = binary.binary_closing_skimage(ccl.remove_small_objects(bw, 40, 1),
                                       binary.disk(close_r))
    if not torch.equal(lab.gather(dev), ccl.label(bw, 2)) or sbg != bg:
        raise SmokeError("sharded_fa_segment differs from the whole-frame chain")
    return {"s": out, "components": int(ccl.label(blobs, 2).max()),
            "rows_per_shard": img.shape[0] // MESH_SHARDS}


def run_mesh_paths(data: str, fa_dir: str) -> dict:
    """The multi-device phase on one card: the runners, the U-Net tile
    batch and the frame ops on the virtual mesh, and ``make_mesh`` of one
    card more than the machine has refused."""
    import torch

    from imageprocess_tpu_torch.parallel.runner import make_mesh

    t0 = time.perf_counter()
    res = {"runners": run_mesh_runners(data, fa_dir), "seg": run_mesh_seg(),
           "frame_ops": run_mesh_frame_ops(fa_dir)}
    n = torch.cuda.device_count()
    try:
        make_mesh(n + 1)
    except ValueError as e:
        res["refusal"] = str(e)
    else:
        raise SmokeError(f"make_mesh({n + 1}) on {n} card(s) did not raise")
    res["s"] = time.perf_counter() - t0
    return res


# ------------------------------------------------------------------ training

TRAIN_FEATURES = (16, 32, 64, 128)   # scripts/train_unet_general_torch.py's widths
TRAIN_TILE, TRAIN_BATCH = 128, 8     # its crops and batch
TRAIN_STEPS = 200
TRAIN_POOL = 8                       # frames in the pool: the script's 160, cut
TRAIN_FRAME_HW = 384
GOLDEN_TRAIN_TILE = 256              # train_unet_golden.py's crop (the roi-auto default)
TRAIN_WINDOWS, TRAIN_WINDOW_STEPS = 3, 20
TRAIN_SHARDS = 4


def train_pool(rng, device: str) -> list:
    """TRAIN_POOL synthcells frames as the training script builds its pool:
    the domains in turn, one of its three cell scales each, training
    arrays by ``frame_arrays`` on *device*."""
    from imageprocess_tpu_torch.models.synthcells import DOMAINS, frame_arrays, synth_frame

    scales = [(6.0, 16.0), (10.0, 28.0), (18.0, 48.0)]
    pool = []
    for i in range(TRAIN_POOL):
        img, labels = synth_frame(rng, TRAIN_FRAME_HW, TRAIN_FRAME_HW,
                                  DOMAINS[i % len(DOMAINS)],
                                  r_range=scales[rng.integers(len(scales))])
        pool.append(frame_arrays(img, labels, device=device))
    return pool


def _grad_rel(a, b) -> float:
    """Relative norm of the difference of two models' ``.grad``, all
    parameters together."""
    num = sum(float((p.grad.cpu() - q.grad.cpu()).norm()) ** 2
              for p, q in zip(a.parameters(), b.parameters()))
    den = sum(float(q.grad.cpu().norm()) ** 2 for q in b.parameters())
    return math.sqrt(num / den)


def _params_moved(a, b, skip=()) -> float:
    """Largest absolute difference of two models' parameters."""
    want = b.state_dict()
    return max(float((v.cpu() - want[k].cpu()).abs().max())
               for k, v in a.state_dict().items() if k not in skip)


def _params_where_gradients_agree(a, b, skip, lr: float) -> dict:
    """The largest parameter difference of two models after one step, in
    lr, over the elements whose two gradients agree to 10 % (|g_a - g_b|
    <= 0.1 min(|g_a|, |g_b|)); the count of the other elements and their
    largest difference.  Adam's first update is lr g / (|g| + 1e-8), so
    where the two paths' float32 roundings of a gradient near zero differ
    in sign or size the parameters differ by up to 2 lr, as for the
    zero-gradient biases; where the gradients agree to 10 % the updates
    differ by at most lr / 40."""
    import torch

    agree, other, n_other = 0.0, 0.0, 0
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        if name in skip:
            continue
        keep = (p.grad - q.grad).abs() <= 0.1 * torch.minimum(p.grad.abs(), q.grad.abs())
        diff = (p.detach() - q.detach()).abs()
        agree = max(agree, float(torch.where(keep, diff, 0).max()))
        other = max(other, float(torch.where(keep, 0, diff).max()))
        n_other += int((~keep).sum())
    return {"params_over_lr": agree / lr, "apart": n_other, "apart_over_lr": other / lr}


def time_train_steps(tile: int, batch: int, rng, pool, device: str = "cuda") -> dict:
    """ms per ``train_step`` at *tile* x *batch* (full width, bf16, the
    batches sampled beforehand): warm-up, then TRAIN_WINDOWS windows of
    TRAIN_WINDOW_STEPS steps, each closed by a synchronise; the median
    window.  Also one step under ``torch.profiler``."""
    import torch

    from imageprocess_tpu_torch.models.golden import sample_crops
    from imageprocess_tpu_torch.models.train import (TrainConfig, create_train_state,
                                                     train_step)

    cfg = TrainConfig(features=TRAIN_FEATURES, tile=tile, batch_size=batch)
    state = create_train_state(cfg, torch.Generator().manual_seed(5), device=device)
    t0 = time.perf_counter()
    crops = [sample_crops(rng, *pool[rng.integers(len(pool))], tile, batch)
             for _ in range(TRAIN_WINDOW_STEPS)]
    sample_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_WINDOW_STEPS
    for b in crops[:5]:
        train_step(state, *b)
    torch.cuda.synchronize()
    windows = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        for b in crops:
            train_step(state, *b)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / len(crops))
    ms = sorted(windows)[len(windows) // 2]
    prof = profile_run(lambda: train_step(state, *crops[0]), top=8)
    return {"tile": tile, "batch": batch, "ms_per_step": ms, "windows_ms": windows,
            "mpix_s": batch * tile * tile / (ms * 1e3), "sample_crops_ms": sample_ms,
            "profile": prof}


def run_train_path(device: str = "cuda") -> dict:
    """U-Net training on the card (``models.train``, the generalist
    script's recipe at full width): TRAIN_STEPS steps of ``train_step`` on
    crops of a synthcells pool (every loss finite, the final EMA below the
    first loss); one bf16 and one float32-model step on the card against
    the same step on the CPU; ``save_checkpoint`` -> ``load_unet``, the
    reloaded model's logits bit-equal to the trained one's; the sharded
    step on TRAIN_SHARDS virtual shards of cuda:0 against the
    single-device step; ms per step at tile 128 and 256 with a profile.
    The launch counts of both hand kernels are set to 0 before the phase
    and read after it: the path launches neither."""
    import tempfile

    import numpy as np
    import torch

    from imageprocess_tpu_torch.device import no_tf32
    from imageprocess_tpu_torch.models.checkpoint import load_unet, save_checkpoint
    from imageprocess_tpu_torch.models.golden import sample_crops
    from imageprocess_tpu_torch.models.train import (
        TrainConfig, create_train_state, make_sharded_train_step, train_step,
        zero_gradient_biases)
    from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
    from imageprocess_tpu_torch.parallel.runner import Mesh

    t_phase = time.perf_counter()
    tsk.reset_launches()
    rsk.reset_launches()
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    pool = train_pool(rng, device)
    pool_s = time.perf_counter() - t0
    cfg = TrainConfig(features=TRAIN_FEATURES, tile=TRAIN_TILE, batch_size=TRAIN_BATCH,
                      decay_steps=TRAIN_STEPS)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device=device)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        batch = sample_crops(rng, *pool[rng.integers(len(pool))], TRAIN_TILE, TRAIN_BATCH)
        state, loss = train_step(state, *batch, w_grad=cfg.grad_loss_weight)
        losses.append(loss)
    losses = torch.stack(losses).cpu().numpy()
    train_s = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise SmokeError(f"train: non-finite losses at steps "
                         f"{np.flatnonzero(~np.isfinite(losses)).tolist()}")
    ema = [float(losses[0])]
    for v in losses[1:]:
        ema.append(0.9 * ema[-1] + 0.1 * float(v))
    if not ema[-1] < ema[0] or state.step != TRAIN_STEPS:
        raise SmokeError(f"train: EMA {ema[0]:.4f} -> {ema[-1]:.4f} after "
                         f"{state.step} steps")

    # one step on the card against the same step on the CPU
    batch = sample_crops(rng, *pool[0], TRAIN_TILE, TRAIN_BATCH)
    vs_cpu = {}
    for name, dtype, bars in (("bf16", torch.bfloat16, (1e-3, 5e-2)),
                              ("f32", torch.float32, (1e-5, 1e-4))):
        card, cpu = (create_train_state(cfg, torch.Generator().manual_seed(1), device=d,
                                        dtype=dtype) for d in (device, "cpu"))
        card, loss_card = train_step(card, *batch)
        cpu, loss_cpu = train_step(cpu, *batch)
        r = {"loss_rel": abs(float(loss_card) - float(loss_cpu)) / float(loss_cpu),
             "grad_rel": _grad_rel(card.model, cpu.model), "bars": bars}
        if r["loss_rel"] > bars[0] or r["grad_rel"] > bars[1]:
            raise SmokeError(f"train: the card's {name} step against the CPU's: {r}")
        vs_cpu[name] = r

    # save, reload, the same logits bit for bit
    x = torch.as_tensor(batch[0]).permute(0, 3, 1, 2).to(device)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, state.model, {"tile": 256, "train_tile": TRAIN_TILE,
                                           "steps": TRAIN_STEPS})
        reloaded, tile = load_unet(tmp)
    reloaded.to(device)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad(), no_tf32():
            same = torch.equal(reloaded(x), state.model(x))
    finally:
        torch.backends.cudnn.deterministic = prev
    if not same or tile != 256:
        raise SmokeError(f"train: the reloaded checkpoint's logits differ (tile {tile})")

    # the sharded step on virtual shards of cuda:0 against the single-device step
    single, sharded, update = (create_train_state(cfg, torch.Generator().manual_seed(2),
                                                  device=device, dtype=torch.float32)
                               for _ in range(3))
    single, loss1 = train_step(single, *batch)
    mesh = Mesh((device,) * TRAIN_SHARDS)
    sharded, loss_s = make_sharded_train_step(mesh)(sharded, *batch)
    # the update itself: the same optimizer step from the averaged gradients
    for p, q in zip(update.model.parameters(), sharded.model.parameters()):
        p.grad = q.grad.clone()
    update.optimizer.step()
    skip = zero_gradient_biases(single.model)
    mesh_r = {"loss_rel": abs(float(loss_s) - float(loss1)) / float(loss1),
              "grad_rel": _grad_rel(sharded.model, single.model),
              "update_equal": _params_moved(update.model, sharded.model) == 0.0,
              "step": sharded.step, "skipped_biases": skip, **_params_where_gradients_agree(
                  sharded.model, single.model, skip, cfg.lr)}
    if (mesh_r["loss_rel"] > 1e-6 or mesh_r["grad_rel"] > 1e-4 or not mesh_r["update_equal"]
            or mesh_r["params_over_lr"] > 0.1 or sharded.step != 1):
        raise SmokeError(f"train: sharded step against the single-device step: {mesh_r}")

    times = {f"tile {t}": time_train_steps(t, TRAIN_BATCH, rng, pool, device)
             for t in (TRAIN_TILE, GOLDEN_TRAIN_TILE)}
    launches = {"tilestats_u16": tsk.launches["tilestats_u16"],
                "roistats_f32": rsk.launches["roistats_f32"]}
    if any(launches.values()):
        raise SmokeError(f"train: hand kernels launched on the training path: {launches}")
    return {"steps": TRAIN_STEPS, "pool": TRAIN_POOL, "pool_s": pool_s, "train_s": train_s,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "ema": {k: ema[k] for k in sorted({*range(0, TRAIN_STEPS, 50), TRAIN_STEPS - 1})},
            "vs_cpu": vs_cpu, "mesh": mesh_r, "times": times, "launches": launches,
            "s": time.perf_counter() - t_phase}


def build_kernels() -> None:
    """Build every kernel, one nvcc each, all started together."""
    from imageprocess_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(KERNELS)) as pool:
        futs = {name: pool.submit(build.load_library, name) for name in KERNELS}
        for name, fut in futs.items():
            fut.result()
    print(f"build ok: {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    root = os.path.abspath(argv[argv.index("--root") + 1]) if "--root" in argv else REPO
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(root, "imageprocess_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(imageprocess_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    t_start = time.perf_counter()

    def stamp(phase: str) -> None:
        print(f"[{time.perf_counter() - t_start:6.1f} s] {phase} done")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.cuda.set_device(0)

    build_kernels()
    if "--kernel-times" in argv:
        print(json.dumps({"kernel_times": kernel_times(), "root": root,
                          "card": card}))
        return 0
    worst = check_kernel("cuda")
    print(f"kernel checks ok: max_abs_err={worst['max_abs_err']} "
          f"max_rel_err_moments={worst['max_rel_err_moments']}")
    worst_f = check_roistats("cuda")
    print(f"roistats checks ok: max_abs_err={worst_f['max_abs_err']} "
          f"max_rel_err_moments={worst_f['max_rel_err_moments']}")
    worst_r = check_radix("cuda")
    print(f"radix edge cases ok: {worst_r['cases']} launches (both kernels, "
          f"every variant) equal their plain versions, "
          f"max_abs_err={worst_r['max_abs_err']} "
          f"max_rel_err_moments={worst_r['max_rel_err_moments']}")
    stamp("build and kernel checks")
    if kernels_only:
        print(json.dumps({"kernels_only": True}))
        return 0

    from imageprocess_tpu_torch import native

    data = os.path.join(REPO, "imageprocess_tpu_torch", "_build", "smoke_data")
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.perf_counter()
    compression = make_dataset(data)
    print(f"dataset: {N_STAGES} stages x channels {CHANNELS} x {H}x{W} u16 "
          f"({compression}), {N_ROI} ROIs/stage, written in "
          f"{time.perf_counter() - t0:.1f} s")
    native_ok = native.tiff_info(os.path.join(data, "S01_2.TIF")) is not None
    print(f"native decoder used: {native_ok}")
    if not native_ok:
        raise SmokeError("the native TIFF decoder did not build or load")

    res = run_main_path(data, "cuda")
    print(f"main path ok: {res['rows']} rows, {len(res['chunks'])} chunks "
          f"{sorted(set(res['chunks']))}, kernel launches {res['launches']}, "
          f"chunk max_abs_err={res['max_abs_err']} "
          f"max_rel_err_moments={res['max_rel_err_moments']}, "
          f"numpy reference max rel err {res['numpy_ref_max_rel']:.3e}")
    print(f"e2e on {card}: warm {res['warm_mpix_s']:.2f} Mpix/s "
          f"({res['warm_s']:.3f} s), steady {res['steady_mpix_s']:.2f} Mpix/s "
          f"(best of {[round(x, 4) for x in res['times_s']]} s)")
    fres = run_fret_main_path(data, "cuda")
    print(f"FRET main path ok: {fres['rows']} rows, {len(fres['chunks'])} chunks "
          f"{sorted(set(fres['chunks']))}, roistats launches {fres['launches']}, "
          f"chunk max_abs_err={fres['max_abs_err']} "
          f"max_rel_err_moments={fres['max_rel_err_moments']}, "
          f"numpy reference max rel err {fres['numpy_ref_max_rel']:.3e}")
    print(f"FRET e2e on {card}: warm {fres['warm_mpix_s']:.2f} Mpix/s "
          f"({fres['warm_s']:.3f} s), steady {fres['steady_mpix_s']:.2f} Mpix/s "
          f"(best of {[round(x, 4) for x in fres['times_s']]} s)")
    stamp("batched intensity and FRET")
    n = check_serial_path(os.path.join(data, "serial"))
    print(f"serial-path check ok: {n} rows (one key of another frame shape) "
          "equal on the card and on the CPU")
    n = check_fret_serial_path(os.path.join(data, "serial_fret"))
    print(f"FRET serial-path check ok: {n} rows (one pair of another frame "
          "shape) equal on the card and on the CPU")
    serial = {}
    for runner, batched, entry in (("intensity", res, "run_intensity"),
                                   ("fret", fres, "run_fret")):
        sr = run_serial_main_path(data, "cuda", runner, batched["row_list"])
        serial[entry] = sr
        print(f"serial {runner} path ok: {entry}(device='cuda') {sr['rows']} rows "
              f"equal to the batched runner's, roistats_f32 launches "
              f"{sr['launches']} (one per key), each equal to its plain version "
              f"(max_abs_err={sr['max_abs_err']} "
              f"max_rel_err_moments={sr['max_rel_err_moments']})")
        print(f"serial {runner} e2e on {card}: warm {sr['warm_mpix_s']:.2f} Mpix/s "
              f"({sr['warm_s']:.4f} s), steady {sr['steady_mpix_s']:.2f} Mpix/s "
              f"(best of {[round(x, 4) for x in sr['times_s']]} s)")
        pr = sr["profile"]
        print(f"serial {runner} under torch.profiler on {card}: one run "
              f"{pr['wall_s']:.4f} s, device busy {pr['device_ms']:.3f} ms over "
              f"{pr['events']} kernels and copies ({pr['events'] / N_STAGES:.0f} per "
              f"key, tables only; idle {100 * pr['idle_share']:.1f} % of the run); "
              f"largest: {pr['top']}")
    stamp("serial intensity and FRET")
    vres = check_variant_paths(os.path.join(data, "variants"))
    print(f"variant paths ok: {vres['configs']} bg_mode x bg_scope configs of "
          f"run_intensity (PNG mask, whole-frame ROI 0, a {BIG_ROI}-px ROI, a "
          f"full-frame ROI, 8-bit, float32 with NaN, RGB) and run_fret (both ratio "
          f"modes): card rows == CPU rows; {vres['launches']} roistats_f32 launches "
          f"over mask shapes {vres['tile_shapes']}, each equal to its plain version "
          f"(max_abs_err={vres['max_abs_err']} "
          f"max_rel_err_moments={vres['max_rel_err_moments']})")
    key_in = next(iter(serial["run_intensity"]["key_inputs"].values()))
    serial_times = {"serial key": time_roi_rows(key_in),
                    "whole frame": time_roi_rows(whole_frame_inputs(data), (H, W),
                                                 reps=10, per_graph=4, graph_reps=3)}
    for name, tm in serial_times.items():
        print(f"roistats_f32 at the {name} on {card}: frames {tm['shape'][0]} masks "
              f"{tm['shape'][1]} (use_smem={tm['use_smem']}, "
              f"stage_mask={tm['stage_mask']}), grid {tm['grid']} CTAs; kernel "
              f"{tm['ms']:.4f} ms per call, {tm['device_ms']:.4f} ms on the device "
              f"(graph replay), plain {tm['plain_ms']:.4f} ms (turns "
              f"{[round(x, 4) for x in tm['turns']]}); bound {tm['bound_ms']:.5f} ms "
              f"by {tm['bound_by']} ({tm['bytes']} B: values and mask inside the "
              f"{H}x{W} frame, origin and output of the {tm['valid']} valid of "
              f"{tm['lanes']} lanes, {tm['ops']:.0f} f32 ops) = "
              f"{100 * tm['bound_ms'] / tm['device_ms']:.1f} % of bound on the device")
    stamp("variants and serial kernel shapes")
    n2, n2_times = {}, {}
    for name, (_, per) in N2_CONFIGS.items():
        nr = n2[name] = run_nesprin2_paths(data, "cuda", name)
        sr, br, pr = nr["serial"], nr["batched"], nr["profile"]
        print(f"nesprin2 path ok ({name}, rim {n2_config(name).rim_px} px, tile "
              f"{nr['tile']}): run_nesprin2(device='cuda') {len(sr['rows'])} rows, "
              f"roistats_f32 launches {sr['launches']} ({per} per pair); "
              f"run_nesprin2_batched(batch_size=4) rows equal to the serial rows, "
              f"launches {br['launches']} ({per} per chunk); every launch equal to "
              f"its plain version (max_abs_err={max(sr['max_abs_err'], br['max_abs_err'])} "
              f"max_rel_err_moments="
              f"{max(sr['max_rel_err_moments'], br['max_rel_err_moments'])}); card "
              f"rows == CPU rows for S01 and S{N_STAGES:02d}; numpy/scipy replica of "
              f"S01 max rel err {nr['replica_max_rel']:.3e} ({nr['s01_finite_px']} "
              f"finite of {nr['s01_rim_px']} rim pixels; {nr['nan_rows']} rows of the "
              f"run without a finite ratio)")
        for mode, r in (("serial", sr), ("batched", br)):
            print(f"nesprin2 {mode} e2e ({name}) on {card}: warm "
                  f"{r['warm_mpix_s']:.2f} Mpix/s ({r['warm_s']:.4f} s), steady "
                  f"{r['steady_mpix_s']:.2f} Mpix/s (best of "
                  f"{[round(x, 4) for x in r['times_s']]} s)")
        print(f"nesprin2 serial ({name}) under torch.profiler on {card}: one run "
              f"{pr['wall_s']:.4f} s, device busy {pr['device_ms']:.3f} ms over "
              f"{pr['events']} kernels and copies ({pr['events'] / N_STAGES:.0f} per "
              f"pair; idle {100 * pr['idle_share']:.1f} % of the run); largest: "
              f"{pr['top']}")
        for mode in ("serial", "batched"):
            for (C, mshape), inputs in nr[mode]["inputs"].items():
                what = "pair" if mode == "serial" else "chunk"
                n2_times[f"{name}, one {what}, C={C}, masks {list(mshape)}"] = \
                    time_roi_rows(inputs)
    for label, tm in n2_times.items():
        print(f"roistats_f32 at nesprin2 ({label}) on {card}: frames {tm['shape'][0]} "
              f"(use_smem={tm['use_smem']}, stage_mask={tm['stage_mask']}), grid "
              f"{tm['grid']} CTAs; kernel {tm['ms']:.4f} ms per call, "
              f"{tm['device_ms']:.4f} ms on the device (graph replay), plain "
              f"{tm['plain_ms']:.4f} ms (turns {[round(x, 4) for x in tm['turns']]}); "
              f"bound {tm['bound_ms']:.5f} ms by {tm['bound_by']} ({tm['bytes']} B, "
              f"{tm['valid']} valid of {tm['lanes']} lanes, {tm['ops']:.0f} f32 ops) = "
              f"{100 * tm['bound_ms'] / tm['device_ms']:.1f} % of bound on the device")
    stamp("nesprin2")
    mor = run_morphology_path(data, "cuda")
    mp = mor["profile"]
    print(f"morphology path ok: run_morphology(device='cuda') {mor['rows']} rows; "
          f"card rows == CPU rows (area_px equal to the rasterizer's mask counts, "
          f"moment metrics max rel err {mor['max_rel']:.3e}); warm {mor['warm_s']:.4f} "
          f"s, steady {mor['steady_s']:.4f} s per run on {card} (best of "
          f"{[round(x, 4) for x in mor['times_s']]}); under torch.profiler one run "
          f"{mp['wall_s']:.4f} s, device busy {mp['device_ms']:.3f} ms over "
          f"{mp['events']} kernels and copies (idle {100 * mp['idle_share']:.1f} %)")
    stamp("morphology")
    fa_dir = os.path.join(data, "fa")
    t0 = time.perf_counter()
    make_fa_dataset(fa_dir)
    print(f"FA dataset: {N_STAGES} stages x {H}x{W} u16, {N_ROI} cells/stage with "
          f"{FA_BLOBS} blobs each, written in {time.perf_counter() - t0:.1f} s")
    far = run_fa_paths(fa_dir, "cuda")
    fb, fs_, fpr, fps = far["batched"], far["serial"], far["profile"], far["profile_serial"]
    print(f"FA path ok: run_fa_batched(device='cuda', batch_size=4) and "
          f"run_fa_batch(device='cuda') {far['rows']} rows over {N_STAGES} stages "
          f"and {far['cells']} cells, categories {far['categories']}; batched rows "
          f"== serial rows; card rows == CPU rows for S01 and S{N_STAGES:02d} (areas, "
          f"categories exact, floats max rel err {far['cpu_max_rel']:.3e}); "
          f"numpy/scipy replica of S01 ({far['replica_rows']} rows) max rel err "
          f"{far['replica_max_rel']:.3e}; master workbooks read back")
    for mode, r in (("batched", fb), ("serial", fs_)):
        print(f"FA {mode} e2e on {card}: warm {r['warm_mpix_s']:.2f} Mpix/s "
              f"({r['warm_s']:.4f} s), steady {r['steady_mpix_s']:.2f} Mpix/s (best "
              f"of {[round(x, 4) for x in r['times_s']]} s)")
    for mode, pr in (("batched", fpr), ("serial", fps)):
        print(f"FA {mode} under torch.profiler on {card}: one run {pr['wall_s']:.4f} "
              f"s, device busy {pr['device_ms']:.3f} ms over {pr['events']} kernels "
              f"and copies ({pr['events'] / N_STAGES:.0f} per frame; idle "
              f"{100 * pr['idle_share']:.1f} % of the run); largest: {pr['top']}")
    print(f"FA batched phases on {card} (CUDA events, one run of "
          f"{far['traced_s']:.4f} s, {N_STAGES // 4} chunks): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in far["phases_ms"].items())
          + f"; CCL rounds over the chunks: {far['counts']}")
    print(json.dumps({"fa": {"rows": far["rows"], "categories": far["categories"],
                             "batched": {k: fb[k] for k in ("warm_s", "times_s",
                                                            "steady_mpix_s")},
                             "serial": {k: fs_[k] for k in ("warm_s", "times_s",
                                                            "steady_mpix_s")},
                             "phases_ms": far["phases_ms"], "counts": far["counts"],
                             "profile": fpr, "profile_serial": fps}, "card": card}))
    stamp("focal adhesions")
    tif = run_tiff_outputs(data, "cuda")
    for name, r in tif.items():
        print(f"TIFF outputs ok: {name}(do_tif=True, device='cuda') on the first "
              f"{TIFF_STAGES} stages: {r['files']} files equal to the CPU run's "
              f"(float32 max err {r['max_err32_of_scale']:.3e} of the frame's "
              f"scale, previews within {r['max_err16']} count), rows equal to the "
              f"tables-only rows, roistats_f32 launches {r['launches']}, each equal "
              f"to its plain version (max_abs_err={r['max_abs_err']}); on {card} "
              f"tables-only {r['tables_s']:.4f} s, with TIFFs {r['tif_s']:.4f} s = "
              f"{r['extra_s_per_key']:.4f} s more per key (download, percentiles, "
              f"writes); the CPU run {r['cpu_s']:.2f} s")
    stamp("TIFF outputs")
    img = run_image_outputs(data, "cuda")
    print(f"PNG text: {img['font']}")
    for name in ("run_intensity", "run_fret", "run_nesprin2", "run_morphology"):
        r = img[name]
        print(f"PNG outputs ok: {name} at the PNG defaults (dpi 300, 500-px crops"
              f"{', the inset colorbar' if name in ('run_fret', 'run_nesprin2') else ''}) on "
              f"{IMAGE_STAGES} stages x {IMAGE_ROIS} ROIs: {r['pngs_per_key']:g} PNGs per "
              f"key; stage 1's {r['compared']} PNGs vs the CPU run's: canvases equal, "
              f"pixels within {r['max_px_diff']} (on {100 * r['max_diff_share']:.4f} % "
              f"at most); rows equal to the tables-only rows; roistats_f32 launches "
              f"{r['launches']}, each equal to its plain version (max_abs_err="
              f"{r['max_abs_err']}); on {card} tables-only {r['tables_s']:.4f} s, with "
              f"PNGs {r['png_s']:.4f} s = {r['extra_s_per_key']:.4f} s more per key; the "
              f"CPU run of stage 1 {r['cpu_s']:.2f} s")
    cr, cv = img["run_crop"], img["crop_view_tiled"]
    print(f"cropper ok: run_crop(device='cuda') over {IMAGE_STAGES} stages x {N_ROI} "
          f"ROIs: {cr['files']} PNGs, {cr['s_per_frame']:.4f} s per frame on {card}; "
          f"stage 1's {cr['compared']} PNGs vs the CPU run's within "
          f"{cr['max_px_diff']}; crop_view_tiled ({cv['rois']} ROIs, tile {cv['tile']}) "
          f"{cv['ms']:.4f} ms per call (CUDA events), views within "
          f"{cv['max_abs_err_vs_cpu']:.2e} of the CPU's, masks and flags equal")
    print(json.dumps({"image_outputs": img, "card": card}))
    stamp("PNG outputs and the cropper")
    seg = run_seg_path("cuda")
    print(f"seg path ok: {H}x{W} u16 synthcells fluor frame, golden U-Net "
          f"(tile 256, overlap 32, n_iter 120), {seg['polygons']} polygons; "
          f"card vs CPU label maps at IoU>=0.5: recall {seg['vs_cpu']['recall']:.4f}, "
          f"mean IoU {seg['vs_cpu']['mean_iou']:.4f} ({seg['vs_cpu']['n_pred']} vs "
          f"{seg['vs_cpu']['n_true']} instances); card post-process fed the CPU's "
          f"network output == CPU's label map; generalist vs generator labels "
          f"at IoU>=0.3: recall {seg['vs_truth']['recall']:.4f}, mean IoU "
          f"{seg['vs_truth']['mean_iou']:.4f} ({seg['true_cells']} true cells)")
    print(f"seg e2e on {card}: warm {seg['warm_mpix_s']:.2f} Mpix/s "
          f"({seg['warm_s']:.4f} s), steady {seg['steady_mpix_s']:.2f} Mpix/s "
          f"(best of {[round(x, 4) for x in seg['times_s']]} s), frame to polygons")
    ph, cnt = seg["phases_ms"], seg["counts"]
    print(f"seg phases on {card} (CUDA events, one run of "
          f"{seg['traced_s']:.4f} s): " + ", ".join(
              f"{name} {ph[name]:.3f} ms" for name in SEG_PHASES)
          + f"; forward tiles {cnt.get('forward.tiles')} of {seg['tiles_total']}"
          f"; CCL rounds: remove_small_objects "
          f"{cnt.get('remove_small_objects.rounds')}, flow_label "
          f"{cnt.get('flow_label.ccl.rounds')}")
    print(json.dumps({"seg": {k: seg[k] for k in (
        "polygons", "warm_s", "steady_s", "times_s", "steady_mpix_s",
        "phases_ms", "counts", "vs_cpu", "vs_truth")}, "card": card}))
    stamp("segmentation")
    ref = run_refine_path(os.path.join(data, "refine"))
    sc, rp, fs = ref["scores"], ref["profile"], ref["frame_s"]
    print(f"refine path ok: refine_and_save(device='cuda') over {REFINE_STAGES} "
          f"synthcells fluor frames {H}x{W} u16 (dataset {ref['data_s']:.1f} s), "
          f"rough polygons per frame {list(ref['polygons'].values())}; vs the "
          f"generator's outlines at IoU>=0.5: percentile "
          f"(p{REFINE_MODES['percentile']:g}) recall {sc['percentile']['recall']:.4f}, "
          f"mean IoU {sc['percentile']['mean_iou']:.4f}, bnd (k "
          f"{REFINE_MODES['bnd']:g}) recall {sc['bnd']['recall']:.4f}, mean IoU "
          f"{sc['bnd']['mean_iou']:.4f} over stage 1 ({sc['percentile']['n_true']} / "
          f"{sc['bnd']['n_true']} true outlines; "
          f"unrefined {sc['percentile']['unrefined']} / {sc['bnd']['unrefined']})")
    for mode, vc in ref["vs_cpu"].items():
        print(f"refine card vs CPU ({mode}, stage 1): thresholds max rel diff "
              f"{vc['thr_max_rel']:.3e}, {vc['checked_equal']} of {vc['polygons']} "
              f"polygons without a pixel between the thresholds and equal; bundle "
              f"(JSON, mask, overlay, zip entries) equal: {vc['bundle_equal']}")
    print(f"refine e2e on {card}: percentile seconds per frame (segmentation and "
          f"the bundle) warm {ref['warm_s']:.4f}, steady {ref['steady_s']:.4f} "
          f"(frames {[round(x, 4) for x in fs['percentile']]}; steady parts: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in zip(
              ("segmentation and JSON", "mask", "overlay", "zip"),
              ref["steady_parts_s"]))
          + f"), bnd (stage 1) {[round(x, 4) for x in fs['bnd']]}; segment_inside_polygon "
          f"{ref['ms_per_polygon']:.3f} ms per polygon (stage 1, best of "
          f"{[round(x, 4) for x in ref['loop_s']]} s for {ref['polygons']['S01']})")
    n1 = ref["polygons"]["S01"]
    print(f"refine phases per polygon on {card} (CUDA events over the "
          f"{n1} polygons of stage 1): " + ", ".join(
              f"{k} {v / n1:.3f} ms" for k, v in ref["phases_ms"].items())
          + "; CCL rounds per polygon: " + ", ".join(
              f"{k} {v / n1:.2f}" for k, v in ref["counts"].items()))
    print(f"refine under torch.profiler on {card}: frame {ref['profiled']} of the "
          f"percentile run with its bundle {rp['wall_s']:.4f} s, "
          f"device busy {rp['device_ms']:.3f} ms over {rp['events']} kernels and "
          f"copies ({ref['launches_per_polygon']:.0f} per polygon; idle "
          f"{100 * rp['idle_share']:.1f} % of the frame); largest: {rp['top']}")
    dk = ref["deck"]
    print(f"deck ok: run_fret_ppt over {len(DECK['stages'])} stages x "
          f"{len(DECK['rois'])} ROIs x {DECK['times']} timepoints: {dk['slides']} "
          f"slides, {dk['pictures']} pictures read back, {dk['bytes']} B in "
          f"{dk['s']:.4f} s")
    print(json.dumps({"refine": {k: ref[k] for k in (
        "polygons", "frame_s", "warm_s", "steady_s", "steady_parts_s",
        "ms_per_polygon", "phases_ms",
        "counts",
        "launches_per_polygon", "scores", "vs_cpu", "profile", "deck")},
        "card": card}))
    stamp("refine and deck")
    cres = run_cli_phase(data, kind, {"serial": serial["run_intensity"], "fret": fres})
    st, ln = cres["steps_s"], cres["launches"]
    sub = st["intensity (subprocess)"]
    print(f"CLI ok on {card}: python3 -m imageprocess_tpu_torch.cli intensity (a "
          f"subprocess, no --device: the card) {sub:.4f} s, its report equal to "
          f"run_intensity's; the direct call in this process {cres['direct_s']:.4f} s, so "
          f"the process's own overhead (interpreter, imports, CUDA context, kernel "
          f"libraries) {sub - cres['direct_s']:.4f} s; --help alone {st['--help (subprocess)']:.4f} s; "
          f"in process cli.main {cres['cli_s']:.4f} s against the direct call "
          f"{cres['direct_s']:.4f} s (turns direct/cli/cli/direct "
          f"{[round(x, 4) for x in cres['turns_s']]}): argparse and the config "
          f"{cres['cli_s'] - cres['direct_s']:+.4f} s")
    print("CLI launches counted around each call, equal to the direct runners': "
          + ", ".join(f"{k} {v}" for k, v in ln.items()))
    print("CLI files equal to the direct calls' (bytes; zip entries): "
          + ", ".join(f"{k} {v}" for k, v in cres["files"].items())
          + f" (refine: {cres['refine_polygons']} polygons in a {REFINE_CROP[0]}x"
          f"{REFINE_CROP[1]} quarter of stage 1); --xprof trace names roi_stats_f32 "
          f"{ln['intensity --xprof (trace)']['roistats_f32']} times; doctor: "
          + "; ".join(f"{k}: {v}" for k, v in cres["doctor"].items()))
    print("CLI step wall seconds on " + card + ": "
          + ", ".join(f"{k} {v:.4f}" for k, v in st.items()))
    print(json.dumps({"cli": {k: cres[k] for k in (
        "steps_s", "launches", "files", "direct_s", "cli_s", "turns_s")}, "card": card}))
    stamp("command line")
    figs = run_figures(data)
    print("figures: h5py " + (f"{figs['h5py']} imports on this machine, so the --mat-dir "
                              "overlay runs here" if figs["h5py"] else
                              "does not import on this machine: --mat-dir is left out "
                              "here (the CPU tests run it)"))
    for runner, r in figs["panel"].items():
        print(f"rim-FRET panel ok: {runner} (annulus + QC, do_png, save_panel, "
              f"add_scalebar) on {FIG_STAGES} stages x {IMAGE_ROIS} ROIs: {r['compared']} "
              f"panels equal to the CPU run's pixel for pixel; roistats_f32 launches "
              f"{r['launches']} with the panel, {r['launches_without_panel']} without, each "
              f"equal to its plain version (max_abs_err={r['max_abs_err']}); on {card} "
              f"{r['s']:.4f} s with the panel, {r['s_without_panel']:.4f} s without = "
              f"{r['s_per_panel']:.4f} s per panel")
    fr = figs["fa"]
    print(f"FA figures ok: fa --figs --export-crops{' --mat-dir' if fr['mat_dir'] else ''} "
          f"through cli.main on the card over {FIG_STAGES} stages x {N_ROI} cells: "
          f"{fr['files']} PNGs equal to the direct CPU calls' pixel for pixel "
          f"(launches {fr['launches']}; the FA path has no hand kernel); on {card} "
          f"the CLI run {fr['cli_s']:.4f} s, save_fa_figs {fr['s_per_figure']:.4f} s per "
          f"overview figure, export_fa_crops {fr['s_per_crop']:.4f} s per crop, each "
          f"with its stage's analyze_image rerun ({fr['analyze_s_per_stage']:.4f} s per "
          f"stage alone)")
    print(json.dumps({"figures": figs, "card": card}))
    stamp("figures")
    mesh = run_mesh_paths(data, fa_dir)
    for name, r in mesh["runners"]["runs"].items():
        print(f"mesh path ok: {name}: {r['rows']} rows equal to the run without a "
              f"mesh, launches {r['launches']} (chunks x shards), {r['wall_s']:.4f} s "
              f"on {card}")
    mr, ms, mf = mesh["runners"], mesh["seg"], mesh["frame_ops"]
    print(f"mesh launches checked against the plain versions: {mr['checked_launches']} "
          f"(max_abs_err={mr['max_abs_err']})")
    print(f"mesh seg ok: label_frame_unet with the tile batch on {MESH_SHARDS} virtual "
          f"shards: {ms['labels']} labels equal to the run without a mesh; "
          f"best {ms['s']:.4f} s without, {ms['mesh_s']:.4f} s with the mesh (turns "
          f"without / with / with / without after a warm run) on {card}")
    print(f"mesh frame ops ok: {len(mf['s'])} parallel.spatial functions on "
          f"{MESH_SHARDS} shards of {mf['rows_per_shard']} rows equal the whole-frame "
          f"ops ({mf['components']} components, labels bit-equal); seconds on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in mf["s"].items()))
    print(f"mesh refusal ok: {mesh['refusal']}")
    print(f"mesh phase: {mesh['s']:.1f} s on {card}")
    print(json.dumps({"mesh": {"runs": mr["runs"], "seg": ms, "frame_ops_s": mf["s"],
                               "phase_s": mesh["s"]}, "card": card}))
    stamp("mesh")
    tr = run_train_path("cuda")
    ema = tr["ema"]
    print(f"train path ok: train_step(device='cuda') x {tr['steps']} at features "
          f"{TRAIN_FEATURES}, tile {TRAIN_TILE}, batch {TRAIN_BATCH}, decay_steps "
          f"{tr['steps']} on crops of a pool of {tr['pool']} synthcells frames "
          f"{TRAIN_FRAME_HW}x{TRAIN_FRAME_HW} (the script's 160, cut; pool "
          f"{tr['pool_s']:.2f} s): every loss finite, loss {tr['loss_first']:.4f} -> "
          f"{tr['loss_last']:.4f}, EMA " + ", ".join(
              f"step {k} {v:.4f}" for k, v in ema.items())
          + f"; {tr['train_s']:.2f} s on {card} with the host's crop sampling")
    for name, r in tr["vs_cpu"].items():
        print(f"train step card vs CPU ({name} model, same params and batch): loss "
              f"rel {r['loss_rel']:.3e} (bar {r['bars'][0]:g}), gradients rel norm "
              f"{r['grad_rel']:.3e} (bar {r['bars'][1]:g})")
    m = tr["mesh"]
    print(f"train sharded step ok: make_sharded_train_step on {TRAIN_SHARDS} virtual "
          f"shards of cuda:0 (f32 model) against train_step: loss rel "
          f"{m['loss_rel']:.3e}, gradients rel norm {m['grad_rel']:.3e}, the update "
          f"equal to one AdamW step from the averaged gradients, params within "
          f"{m['params_over_lr']:.3e} lr where the two gradients agree to 10 % "
          f"({m['apart']} elements where they do not: within "
          f"{m['apart_over_lr']:.3e} lr; zero-gradient biases left out: "
          f"{m['skipped_biases']}), step {m['step']}; "
          f"save_checkpoint -> load_unet: logits bit-equal; hand-kernel launches "
          f"{tr['launches']}")
    for name, t in tr["times"].items():
        pr = t["profile"]
        print(f"train step at {name}, batch {t['batch']} on {card}: "
              f"{t['ms_per_step']:.3f} ms per step (median of windows "
              f"{[round(x, 3) for x in t['windows_ms']]} of {TRAIN_WINDOW_STEPS} steps), "
              f"{t['mpix_s']:.2f} Mpix/s; sample_crops {t['sample_crops_ms']:.3f} ms "
              f"per batch on the host; one step under torch.profiler "
              f"{1e3 * pr['wall_s']:.3f} ms, device busy {pr['device_ms']:.3f} ms over "
              f"{pr['events']} kernels and copies (idle {100 * pr['idle_share']:.1f} %); "
              f"largest: {pr['top']}")
    print(f"train phase: {tr['s']:.1f} s on {card}")
    print(json.dumps({"train": tr, "card": card}))
    stamp("training")
    workers = max(8, (os.cpu_count() or 1) * 2)
    dec = time_host_decode(data, workers)
    print(f"host share alone on this machine ({os.cpu_count()} cores, "
          f"{workers} threads): fused decode + histogram + tiles of "
          f"{N_STAGES} keys {dec:.4f} s")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with open(os.path.join(REPO, "imageprocess_tpu_torch", "kernels",
                           "common.cuh"), encoding="utf-8") as f:
        threads = int(re.search(r"kThreads = (\d+);", f.read()).group(1))
    timing = time_chunk(res["sample_inputs"])
    shape = tuple(res["sample_inputs"][0].shape)
    print(f"per chunk {shape} on {card}: kernel {timing['ms']:.4f} ms, "
          f"plain {timing['plain_ms']:.4f} ms (turns plain/kernel/kernel/"
          f"plain {[round(x, 4) for x in timing['turns']]}); whole step "
          f"rasterize + kernel {timing['step_ms']:.4f} ms (rasterize "
          f"{timing['rasterize_ms']:.4f} ms), plain {timing['step_plain_ms']:.4f} ms")
    ftiming = time_fret_chunk(fres["sample_inputs"])
    shape = tuple(fres["sample_inputs"][0].shape)
    print(f"FRET per chunk {shape} on {card}: roistats kernel "
          f"{ftiming['ms']:.4f} ms, plain {ftiming['plain_ms']:.4f} ms (turns "
          f"plain/kernel/kernel/plain {[round(x, 4) for x in ftiming['turns']]}); "
          f"whole step {ftiming['step_ms']:.4f} ms, plain "
          f"{ftiming['step_plain_ms']:.4f} ms (turns "
          f"{[round(x, 4) for x in ftiming['step_turns']]})")
    for name, tm in (("tilestats_u16", timing), ("roistats_f32", ftiming)):
        print(f"{name} at the bench chunk on {card}: grid {tm['grid']} CTAs "
              f"of {threads} threads, {tm['ctas_per_sm']} resident per SM x {sms} "
              f"SMs; bound {tm['bound_ms']:.5f} ms by {tm['bound_by']} "
              f"({tm['bytes']} B at 3.35 TB/s, {tm['ops']:.0f} f32 ops at "
              f"67 TFLOP/s); kernel {tm['ms']:.4f} ms per call through the "
              f"Python wrapper (CUDA events) = {100 * tm['bound_ms'] / tm['ms']:.1f} % "
              f"of bound; {tm['device_ms']:.4f} ms on the device (CUDA graph "
              f"replay) = {100 * tm['bound_ms'] / tm['device_ms']:.1f} % of bound")
    shutil.rmtree(data, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    measured = {
        "tilestats_u16": (res["launches"],
                          max(res["max_abs_err"], worst["max_abs_err"],
                              mesh["runners"]["max_abs_err"]["tilestats_u16"]), timing),
        "roistats_f32": (fres["launches"],
                         max(fres["max_abs_err"], worst_f["max_abs_err"],
                             vres["max_abs_err"],
                             *(sr["max_abs_err"] for sr in serial.values()),
                             *(nr[k]["max_abs_err"] for nr in n2.values()
                               for k in ("serial", "batched")),
                             *(tm["max_abs_err"] for tm in n2_times.values()),
                             *(r["max_abs_err"] for r in tif.values()),
                             *(img[k]["max_abs_err"] for k in ("run_intensity", "run_fret",
                                                               "run_nesprin2")),
                             *(r["max_abs_err"] for r in figs["panel"].values()),
                             *(tm["max_abs_err"] for tm in serial_times.values()),
                             mesh["runners"]["max_abs_err"]["roistats_f32"]),
                         ftiming),
    }
    launches_mesh = {kern: {run: v["launches"][kern]
                            for run, v in mesh["runners"]["runs"].items() if v["launches"][kern]}
                     for kern in KERNELS}
    extra = {"tilestats_u16": {"launches_cli": {
        k: v["tilestats_u16"] for k, v in cres["launches"].items() if v["tilestats_u16"]},
        "launches_mesh": launches_mesh["tilestats_u16"]},
             "roistats_f32": {
        "launches_mesh": launches_mesh["roistats_f32"],
        "launches_serial": {**{k: sr["launches"] for k, sr in serial.items()},
                            "variant_runs": vres["launches"]},
        "serial_shapes": {name: {k: tm[k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes",
            "valid", "grid", "use_smem")} for name, tm in serial_times.items()},
        "launches_nesprin2": {f"{mode} ({name})": nr[mode]["launches"]
                              for name, nr in n2.items()
                              for mode in ("serial", "batched")},
        "launches_tiff_outputs": {name: r["launches"] for name, r in tif.items()},
        "launches_image_outputs": {name: img[name]["launches"] for name in (
            "run_intensity", "run_fret", "run_nesprin2", "run_morphology")},
        "launches_cli": {k: v["roistats_f32"] for k, v in cres["launches"].items()
                         if v["roistats_f32"]},
        "launches_figures": {f"{name} save_panel": r["launches"]
                             for name, r in figs["panel"].items()},
        "nesprin2_shapes": {label: {k: tm[k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes",
            "valid", "grid", "use_smem", "stage_mask")}
            for label, tm in n2_times.items()}}}
    for name in KERNELS:  # the training path launches neither (0)
        extra[name]["launches_train"] = tr["launches"][name]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches,
        "launches_per_run": launches, "max_abs_err": err, "ms": tm["ms"],
        "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None,
        "share_of_bound": tm["bound_ms"] / tm["ms"], "device_ms": tm["device_ms"],
        "grid": tm["grid"],
        "ctas_per_sm": tm["ctas_per_sm"], **extra.get(name, {})}
        for name, (launches, err, tm) in measured.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
