"""Per-ROI intensity tables, the plain way (``src/INT/Fluor_INT.py``'s
arithmetic): per stage and channel the background is ``np.percentile`` of
every ``bg_stride``-th pixel of the raw frame at ``percentile``; the
corrected frame is x - bg, clipped at 0; each ROI's statistics are over
its pixels by matplotlib's rule.

``precision="f64"`` is the judge.  ``"bf16"`` is the control: corrected
pixels rounded to bfloat16, sums in float32, the step below the
configuration's float32 that would tempt a faster program.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from . import common


def rows(exp: dict, settings: dict, precision: str = "f64"):
    """({(stage, roi): {field: value}}, [area of each ROI])."""
    if settings.get("bg_mode", "percentile") != "percentile" or \
            settings.get("bg_scope", "full") != "full":
        raise ValueError("the reference covers bg_mode percentile, bg_scope full")
    folder = exp["folder"]
    H, W = exp["shape"]
    p = float(settings.get("percentile", 1.0))
    stride = max(1, int(settings.get("bg_stride", 4)))
    clip = bool(settings.get("clip_neg", True))

    def stage_rows(stage):
        geo = common.masks(common.read_rois(folder, stage), H, W)
        out = [{"area_px": int(m.sum())} for *_, m in geo]
        for ch in settings["channels"]:
            img = common.read_frame(os.path.join(folder, f"{stage}_{ch}.TIF"))
            bg = np.float32(np.percentile(img.ravel()[::stride].astype(np.float64), p))
            if precision == "f64":
                x = img.astype(np.float64) - np.float64(bg)
                acc = np.float64
            else:
                x = img.astype(np.float32) - bg
                acc = np.float32
            if clip:
                x = np.maximum(x, 0)
            if precision == "bf16":
                x = common.bf16(x)
            for r, (y0, y1, x0, x1, m) in zip(out, geo):
                st = common.stats(x[y0:y1, x0:x1][m], acc)
                for k, v in st.items():
                    r[f"ch{ch}_{k}"] = v
                r[f"ch{ch}_bg"] = float(bg)
        return stage, out

    table, areas = {}, []
    with cf.ThreadPoolExecutor(common.WORKERS) as ex:
        for stage, out in ex.map(stage_rows, exp["stages"]):
            for i, r in enumerate(out):
                table[(stage, i + 1)] = r
                areas.append(r["area_px"])
    return table, areas
