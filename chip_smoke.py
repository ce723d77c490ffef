#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It drives the port's main path, the batched tables-only intensity runner
(``imageprocess_tpu_torch.pipelines.intensity.run_intensity_batched``), on
the card, at the shapes of the repo's benchmark: 16 stages x channels
(2, 3) of 1536 x 2048 u16 frames with 18 circular ROIs of radius 60 each
(288 rows).  Phases, each of which exits non-zero on failure:

1. the card's name and power limit;
2. build ``kernels/tilestats_u16.cu`` with nvcc into
   ``imageprocess_tpu_torch/_build/``;
3. hold the kernel to its plain PyTorch version on the card: random,
   tie-heavy, empty-ROI and padded-lane cases, the bench tile (t = 128,
   above 48 KB of shared memory) and a tile above the shared-memory limit.
   Masks, npx, area, vmin, vmax and the quantiles must be exact; mean, std
   and vsum within 1e-5 relative;
4. write the dataset (under ``imageprocess_tpu_torch/_build/``);
5. run the runner on the card: the first run checks every chunk's kernel
   output against the plain version on the same device tensors and counts
   kernel launches; later runs are timed.  Rows are checked against a
   numpy reference for a few ROIs;
6. kernel and plain times per chunk, with CUDA events.

The last two lines of standard output are one JSON object per line: the
kernel table, then ``{"ok": true, "device": {...}}``.  Without a card, or
outside a checkout, it prints no result and exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
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
KERNEL_SOURCE = "imageprocess_tpu_torch/kernels/tilestats_u16.cu"
KERNEL_REPLACES = "imageprocess_tpu/ops/pallas_tilestats.py:47"


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

def compare_packed(got, want, what: str) -> dict:
    """Kernel vs plain (B, 10, C, N) float32 on one device: exact rows
    must be bit-equal (NaN where NaN), moment rows within REL_TOL."""
    import torch

    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    if g.shape != w.shape:
        raise SmokeError(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    nan_g, nan_w = torch.isnan(g), torch.isnan(w)
    if not torch.equal(nan_g, nan_w):
        raise SmokeError(f"{what}: NaN positions differ")
    ok = ~nan_w
    exact = list(EXACT_ROWS)
    d_exact = (g[:, exact] - w[:, exact]).abs()[ok[:, exact]]
    if d_exact.numel() and d_exact.max().item() != 0.0:
        raise SmokeError(f"{what}: exact rows differ by {d_exact.max().item()}")
    mom = list(MOMENT_ROWS)
    gm, wm = g[:, mom][ok[:, mom]], w[:, mom][ok[:, mom]]
    rel = ((gm - wm).abs() / wm.abs().clamp(min=1e-9))
    max_rel = rel.max().item() if rel.numel() else 0.0
    if max_rel > REL_TOL:
        raise SmokeError(f"{what}: moments differ by {max_rel:.3e} rel > {REL_TOL}")
    diff = (g - w).abs()[ok]
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

    from imageprocess_tpu_torch._host import polygon

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
    add("t=272 above the shared-memory limit", tiles, polys,
        np.ones((B, N), bool), rng.uniform(0, 1000, (B, C)), False)
    return cases


def check_kernel(device) -> dict:
    import torch

    from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk

    worst = {"max_abs_err": 0.0, "max_rel_err_moments": 0.0}
    for name, tiles, lp, valid, bgs, clip, use_smem in kernel_cases(device):
        t = tiles.shape[-1]
        smem = tsk.kernel_uses_smem(tiles.shape[2], t, tiles.device) \
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


# ------------------------------------------------------------------ dataset

def write_tiff16_deflate(path: str, img, rows_per_strip: int = 64) -> None:
    """Baseline little-endian u16 TIFF with Adobe-Deflate strips (zlib),
    numpy and stdlib only."""
    h, w = img.shape
    raw = img.astype("<u2").tobytes()
    stride = w * 2
    strips = [zlib.compress(raw[r * stride:(r + rows_per_strip) * stride], 6)
              for r in range(0, h, rows_per_strip)]
    n = len(strips)
    offs, pos = [], 8
    for s in strips:
        offs.append(pos)
        pos += len(s)
    arrays = pos
    ifd = arrays + 8 * n
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 16),
               (259, 3, 1, 8), (262, 3, 1, 1), (273, 4, n, arrays),
               (277, 3, 1, 1), (278, 3, 1, rows_per_strip),
               (279, 4, n, arrays + 4 * n)]
    buf = bytearray(b"II" + struct.pack("<HI", 42, ifd))
    for s in strips:
        buf += s
    buf += struct.pack(f"<{n}I", *offs)
    buf += struct.pack(f"<{n}I", *[len(s) for s in strips])
    buf += struct.pack("<H", len(entries))
    for tag, typ, cnt, val in entries:
        fmt = "<HHIHH" if typ == 3 else "<HHII"
        buf += struct.pack(fmt, tag, typ, cnt, val, *((0,) if typ == 3 else ()))
    buf += struct.pack("<I", 0)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)


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

    from imageprocess_tpu_torch._host import native
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
        "sample_inputs": shapes[0],
    }


def time_host_decode(folder: str, workers: int) -> float:
    """Wall seconds of the host's share alone: the fused native decode +
    histogram + tile cut of every key, on the runner's thread count (best
    of two)."""
    import concurrent.futures as cf

    import numpy as np

    from imageprocess_tpu_torch._host import native
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
    import numpy as np

    from imageprocess_tpu_torch.pipelines.intensity import (
        IntensityConfig, run_intensity_batched,
    )

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
    cfg = IntensityConfig(channels=CHANNELS, do_xls=False)
    rows = {}
    for dev in ("cuda", "cpu"):
        rows[dev] = run_intensity_batched(folder, cfg, log=lambda *_: None,
                                          batch_size=2, device=dev)
    if len(rows["cuda"]) != 8 or len(rows["cpu"]) != 8:
        raise SmokeError(f"serial-path check: {len(rows['cuda'])} rows on the "
                         f"card, {len(rows['cpu'])} on the CPU, want 8")
    for a, b in zip(rows["cuda"], rows["cpu"]):
        for k, v in b.items():
            if isinstance(v, float) and k.endswith(("_mean", "_std", "_vsum")):
                if abs(a[k] - v) > REL_TOL * max(abs(v), 1e-9):
                    raise SmokeError(f"serial-path check: {k} {a[k]} vs {v}")
            elif a[k] != v:
                raise SmokeError(f"serial-path check: {k} {a[k]!r} vs {v!r}")
    return len(rows["cuda"])


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
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "turns": [p1, k1, k2, p2],
            "rasterize_ms": cuda_ms(lambda: tsk.tile_masks(lp, valid,
                                                           tiles.shape[-1])),
            "step_ms": cuda_ms(step), "step_plain_ms": cuda_ms(step_plain)}


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "imageprocess_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(imageprocess_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.cuda.set_device(0)

    from imageprocess_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library("tilestats_u16")
    print(f"build ok: tilestats_u16 in {time.perf_counter() - t0:.1f} s")
    for line in build.build_logs.get("tilestats_u16", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    worst = check_kernel("cuda")
    print(f"kernel checks ok: max_abs_err={worst['max_abs_err']} "
          f"max_rel_err_moments={worst['max_rel_err_moments']}")
    if kernels_only:
        print(json.dumps({"kernels_only": True}))
        return 0

    from imageprocess_tpu_torch._host import native

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
    n = check_serial_path(os.path.join(data, "serial"))
    print(f"serial-path check ok: {n} rows (one key of another frame shape) "
          "equal on the card and on the CPU")
    workers = max(8, (os.cpu_count() or 1) * 2)
    dec = time_host_decode(data, workers)
    print(f"host share alone on this machine ({os.cpu_count()} cores, "
          f"{workers} threads): fused decode + histogram + tiles of "
          f"{N_STAGES} keys {dec:.4f} s")
    timing = time_chunk(res["sample_inputs"])
    shape = tuple(res["sample_inputs"][0].shape)
    print(f"per chunk {shape} on {card}: kernel {timing['ms']:.4f} ms, "
          f"plain {timing['plain_ms']:.4f} ms (turns plain/kernel/kernel/"
          f"plain {[round(x, 4) for x in timing['turns']]}); whole step "
          f"rasterize + kernel {timing['step_ms']:.4f} ms (rasterize "
          f"{timing['rasterize_ms']:.4f} ms), plain {timing['step_plain_ms']:.4f} ms")
    shutil.rmtree(data, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "tilestats_u16", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": res["launches"],
        "max_abs_err": max(res["max_abs_err"], worst["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
