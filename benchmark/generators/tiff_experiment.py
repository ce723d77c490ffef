"""An experiment folder as microscopes and ROI drawers leave it, from a seed.

One general generator for every tables traffic mix: the traffic file's
``params`` say everything, this code nothing of one mix.

- ``frame``: ``shape`` [H, W], ``channels``, ``stages``, ``compression``
  (``"none"`` or ``"lzw"``), a Gaussian ``background`` {mean, sd}, optional
  ``blobs`` (``count`` Gaussian spots of ``amplitude`` and ``radius``
  [lo, hi] per frame, cut at ``extent`` radii, centres ``margin`` px from
  the border) and optional ``bodies`` (one Gaussian body per ROI, centred
  on it, sigma = ``sigma`` x its radius, peak ``amplitude`` [lo, hi] drawn
  per ROI and channel).
- ``rois``: a lattice of ``count`` ROIs, ``cols`` per row, at ``origin`` +
  ``pitch`` x (col, row), centres moved by up to ``jitter`` px; each ROI an
  outline r(t) = radius x (1 + sum of ``harmonics`` of amplitude up to
  ``wobble``), ``vertices`` [lo, hi] points on it, rounded to 1/16 px
  (``LATTICE``: the reference's float64 raster is then exact) and clamped
  into the frame.  The multiset of (radius, vertices,
  amplitudes) comes from ``shapes_seed`` and is the same for every seed:
  the seed only deals the shapes to the lattice places (per stage when
  ``per_stage``), and draws the jitter, phases and pixels.  So every seed
  gives the same work in another order.

Files: ``S01_2.TIF`` ... (u16, one page, PIL's TIFF writer) and
``roi/S01.json`` (the ROI bundle format), plus ``manifest.json`` with the
polygons.  :func:`ensure` writes the experiment anew in every run, into
one fixed folder per parameter digest, so that every run's set-up does
the same work whatever ran before it.  The stages are written by worker
processes: PIL's LZW encoder holds the GIL, so threads would not overlap.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import hashlib
import json
import multiprocessing
import os
import shutil

import numpy as np

MANIFEST = "manifest.json"
LATTICE = 16.0    # vertices on a 1/16 px grid


def digest(params: dict) -> str:
    return hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:10]


def seed_sequence(seed: int, *words) -> np.random.SeedSequence:
    """A SeedSequence from any whole number (negative and > 64 bits too)."""
    return np.random.SeedSequence([int(seed) % (1 << 128), *words])


def stage_name(s: int) -> str:
    return f"S{s:02d}"


def shape_pool(rois: dict) -> list:
    """The seed-independent multiset of outlines: (radius, n_vertices,
    harmonic amplitudes) per lattice place."""
    rng = np.random.default_rng(int(rois.get("shapes_seed", 0)))
    lo, hi = rois["radius"]
    vlo, vhi = rois["vertices"]
    harm = rois.get("harmonics", [])
    out = []
    for _ in range(int(rois["count"])):
        r = float(rng.uniform(lo, hi)) if hi > lo else float(lo)
        nv = int(rng.integers(vlo, vhi + 1)) if vhi > vlo else int(vlo)
        amps = [float(a) for a in rng.uniform(0.0, rois.get("wobble", 0.0), len(harm))]
        out.append((r, nv, amps))
    return out


def outline(cx, cy, r, nv, harm, amps, phases, H, W) -> np.ndarray:
    th = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    rr = np.full(nv, r)
    for k, a, ph in zip(harm, amps, phases):
        rr = rr + r * a * np.cos(k * th + ph)
    x = np.clip(np.round((cx + rr * np.cos(th)) * LATTICE) / LATTICE, 0.0, W - 1.0)
    y = np.clip(np.round((cy + rr * np.sin(th)) * LATTICE) / LATTICE, 0.0, H - 1.0)
    return np.stack([x, y], -1)


def stage_rois(rois: dict, pool: list, rng, H: int, W: int):
    """(polygons, centres, radii) of one stage."""
    n = int(rois["count"])
    cols = int(rois["cols"])
    ox, oy = rois["origin"]
    px, py = rois["pitch"]
    jit = float(rois.get("jitter", 0.0))
    harm = rois.get("harmonics", [])
    order = rng.permutation(n) if rois.get("shuffle", True) else np.arange(n)
    polys, centres, radii = [], [], []
    for i in range(n):
        r, nv, amps = pool[order[i]]
        cx = ox + px * (i % cols) + (rng.uniform(-jit, jit) if jit else 0.0)
        cy = oy + py * (i // cols) + (rng.uniform(-jit, jit) if jit else 0.0)
        phases = rng.uniform(0.0, 2.0 * np.pi, len(harm))
        polys.append(outline(cx, cy, r, nv, harm, amps, phases, H, W))
        centres.append((cx, cy))
        radii.append(r)
    return polys, centres, radii


def _add_gaussian(img, cx, cy, sigma, amp, reach):
    H, W = img.shape
    y0, y1 = max(0, int(cy - reach)), min(H, int(cy + reach) + 1)
    x0, x1 = max(0, int(cx - reach)), min(W, int(cx + reach) + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy = (np.arange(y0, y1, dtype=np.float32) - np.float32(cy))[:, None]
    xx = (np.arange(x0, x1, dtype=np.float32) - np.float32(cx))[None, :]
    img[y0:y1, x0:x1] += np.float32(amp) * np.exp(
        (yy * yy + xx * xx) * np.float32(-0.5 / (sigma * sigma)))


def frame(params: dict, rng, centres, radii) -> np.ndarray:
    fr = params["frame"]
    H, W = fr["shape"]
    bg = fr["background"]
    img = rng.standard_normal((H, W), dtype=np.float32)
    img *= np.float32(bg["sd"])
    img += np.float32(bg["mean"])
    blobs = fr.get("blobs")
    if blobs:
        m = int(blobs.get("margin", 0))
        for _ in range(int(blobs["count"])):
            cy, cx = rng.integers(m, H - m), rng.integers(m, W - m)
            r = int(rng.integers(blobs["radius"][0], blobs["radius"][1]))
            _add_gaussian(img, cx, cy, r, blobs["amplitude"], blobs["extent"] * r)
    bodies = fr.get("bodies")
    if bodies:
        lo, hi = bodies["amplitude"]
        for (cx, cy), r in zip(centres, radii):
            s = bodies["sigma"] * r
            _add_gaussian(img, cx, cy, s, rng.uniform(lo, hi), 4.0 * s)
    return np.clip(img, 0, 65535).astype(np.uint16)


def write_tiff(path: str, img: np.ndarray, compression: str) -> None:
    """The frame as PIL writes a TIFF, flushed to storage before it returns
    (so no write-back of set-up's files runs inside the measured window)."""
    from PIL import Image

    kw = {"compression": "tiff_lzw"} if compression == "lzw" else {}
    with open(path, "wb") as f:
        Image.fromarray(img).save(f, format="TIFF", **kw)
        f.flush()
        os.fsync(f.fileno())


def _write_stage(params, seed, s, pool, dest):
    """Stage *s*: its channels' TIFFs and its ROI file; (name, polygons)."""
    fr = params["frame"]
    H, W = fr["shape"]
    rois = params["rois"]
    # the ROI layout: per stage, or one for every stage
    rng_roi = np.random.default_rng(seed_sequence(seed, 1, s if rois.get("per_stage") else 0))
    polys, centres, radii = stage_rois(rois, pool, rng_roi, H, W)
    name = stage_name(s)
    for ch in fr["channels"]:
        rng = np.random.default_rng(seed_sequence(seed, 2, s, ch))
        write_tiff(os.path.join(dest, f"{name}_{ch}.TIF"), frame(params, rng, centres, radii),
                   fr["compression"])
    with open(os.path.join(dest, "roi", f"{name}.json"), "w", encoding="utf-8") as f:
        json.dump({"name": name, "image_shape": {"height": H, "width": W},
                   "rois": [p.tolist() for p in polys]}, f)
    return name, [p.tolist() for p in polys]


def generate(params: dict, seed: int, dest: str, workers: int = 8) -> dict:
    """Write the experiment into *dest* (created); returns its manifest.
    Each stage is written in one of up to *workers* fresh processes, all
    ended before this returns."""
    fr = params["frame"]
    os.makedirs(os.path.join(dest, "roi"), exist_ok=True)
    pool = shape_pool(params["rois"])
    stages = range(1, int(fr["stages"]) + 1)
    write = functools.partial(_write_stage, params, int(seed), pool=pool, dest=dest)
    n = max(1, min(workers, len(stages), os.cpu_count() or 1))
    with cf.ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) as ex:
        done = list(ex.map(write, stages))
    manifest = {"seed": int(seed), "shape": list(fr["shape"]), "channels": list(fr["channels"]),
                "stages": [name for name, _ in done], "rois": dict(done)}
    with open(os.path.join(dest, MANIFEST), "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    return manifest


def ensure(params: dict, seed: int, root: str) -> dict:
    """The experiment of (*params*, *seed*), written anew into
    ``<root>/<digest>`` over whatever an earlier run left there.  Returns
    the manifest with its ``folder``."""
    dest = os.path.join(root, digest(params))
    shutil.rmtree(dest, ignore_errors=True)
    manifest = generate(params, seed, dest)
    manifest["folder"] = dest
    return manifest
