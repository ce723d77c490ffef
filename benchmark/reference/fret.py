"""Per-ROI FRET ratio tables, the plain way
(``src/FRET/fret_ratio_builder.py``'s arithmetic): each channel's
background is ``np.percentile`` of the whole raw frame at ``percentile``;
corrected frames x - bg, clipped at 0; eps = max(``eps_abs``, the
``eps_percentile`` of the whole corrected donor); ratio = (acceptor + eps)
/ (donor + eps) (``FRET/Donor``); per ROI the ratio's mean, median, std,
p5, p95 and the donor's and acceptor's mean and median.

``precision="f64"`` is the judge; ``"bf16"`` the control (corrected frames
and the ratio rounded to bfloat16, sums in float32).
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from . import common


def rows(exp: dict, settings: dict, precision: str = "f64"):
    """({(stage, roi): {field: value}}, [area of each ROI])."""
    if settings.get("bg_mode", "percentile") != "percentile" or \
            settings.get("bg_scope", "full") != "full" or \
            settings.get("ratio_mode", "FRET/Donor") != "FRET/Donor" or \
            settings.get("per_channel_p", False):
        raise ValueError("the reference covers percentile backgrounds over the "
                         "full frame and FRET/Donor")
    folder = exp["folder"]
    H, W = exp["shape"]
    p = float(settings.get("percentile", 1.0))
    clip = bool(settings.get("clip_neg", True))
    eps_p = float(settings.get("eps_percentile", 1.0))
    eps_abs = float(settings.get("eps_abs", 5.0))
    dt = np.float64 if precision == "f64" else np.float32

    def stage_rows(stage):
        corr = []
        for ch in (settings["donor_ch"], settings["acceptor_ch"]):
            img = common.read_frame(os.path.join(folder, f"{stage}_{ch}.TIF"))
            bg = np.percentile(img.ravel().astype(np.float64), p)
            x = img.astype(dt) - dt(bg)
            corr.append(np.maximum(x, 0) if clip else x)
        d, a = corr
        eps = max(eps_abs, float(np.percentile(d.ravel().astype(np.float64), eps_p)))
        if precision == "bf16":
            d, a = common.bf16(d), common.bf16(a)
        ratio = (a + dt(eps)) / (d + dt(eps))
        if precision == "bf16":
            ratio = common.bf16(ratio)
        out = []
        for y0, y1, x0, x1, m in common.masks(common.read_rois(folder, stage), H, W):
            r = common.stats(ratio[y0:y1, x0:x1][m], dt)
            dv = common.stats(d[y0:y1, x0:x1][m], dt)
            av = common.stats(a[y0:y1, x0:x1][m], dt)
            out.append({
                "area_px": int(m.sum()),
                "ratio_mean": r["mean"], "ratio_median": r["median"],
                "ratio_std": r["std"], "ratio_p5": r["p5"], "ratio_p95": r["p95"],
                "donor_mean": dv["mean"], "donor_median": dv["median"],
                "yfret_mean": av["mean"], "yfret_median": av["median"],
                "eps": eps})
        return stage, out

    table, areas = {}, []
    with cf.ThreadPoolExecutor(common.WORKERS) as ex:
        for stage, out in ex.map(stage_rows, exp["stages"]):
            for i, r in enumerate(out):
                table[(stage, i + 1)] = r
                areas.append(r["area_px"])
    return table, areas
