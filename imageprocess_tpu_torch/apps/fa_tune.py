"""Interactive FA tuner — the FAAnalyzerApp GUI equivalent (port of
``imageprocess_tpu/apps/fa_tune.py``).

Reference behavior (src/INT/FA_Analyzer.py:269-938 ``FAAnalyzerApp``): load
(image, ROI JSON) pairs for a channel, click a cell to select it, tune
alpha / min area / max area / close radius with sliders, watch the FA
segmentation update live, keep per-cell parameter overrides, and save
results as ``individual_results/{s_tag}_results.csv`` — which doubles as
the settings checkpoint restored on reopen (:572-608).

The analysis core is the batch pipeline's device code
(``pipelines.fa.analyze_image_with_overrides`` on ``device``, default
``"cuda"``); the CSV is written without pandas, cell for cell as
``DataFrame.to_csv`` writes it.  Core actions need no display; only the
display method imports matplotlib.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..core import tiffio
from ..core.i18n import t
from ..device import resolve_device
from ..geom.polygon import contains_point
from ..pipelines.fa import (
    FA_CSV_COLS,
    FaConfig,
    _load_rois,
    analyze_image_with_overrides,
    list_fa_pairs,
    restore_cell_settings,
)
from ..report.excel import _write_csv


class FATuner:
    """One image's interactive session (UI-independent core)."""

    def __init__(self, img_path: str, json_path: str, s_tag: str,
                 out_root: str, cfg: Optional[FaConfig] = None,
                 mat_dir: Optional[str] = None, log=print, device="cuda"):
        self.device = resolve_device(device)
        self.s_tag = s_tag
        self.out_root = out_root
        self.cfg = cfg or FaConfig()
        self.img = tiffio.read_2d(img_path, squeeze="smallest_axis")
        self.rois = _load_rois(json_path)
        self.cell_settings: Dict[int, dict] = restore_cell_settings(
            out_root, s_tag)
        self.selected: Optional[int] = None
        self.log = log
        self._rows: List[dict] = []
        self._thresholds: Dict[int, float] = {}
        self._bg = 0.0
        # legacy MATLAB boundary overlay (FA_Analyzer.py:650-655): match the
        # stage tag in mat_dir once at load, toggle display with 'm'
        self.mat_polys: List[np.ndarray] = []
        self.show_mat = True
        if mat_dir:
            from ..core.roiio import find_matching_mat, load_matlab_boundaries

            mat_path = find_matching_mat(mat_dir, s_tag)
            if mat_path:
                self.mat_polys = load_matlab_boundaries(mat_path)
                self.log(t("tune_mat").format(path=mat_path,
                                              count=len(self.mat_polys)))
        # display "boost" (FA_Analyzer.py:722-744): integer in [-15, 15];
        # positive shrinks the display range (brighten), negative expands
        self.visual_boost = 0
        self.auto_zoom = False
        self._fig = None
        self._ax = None
        self._sliders = {}
        self.reanalyze()

    # --- core actions -------------------------------------------------------

    def reanalyze(self):
        self._rows, self._thresholds, self._bg = analyze_image_with_overrides(
            self.img, self.rois, self.cfg, self.cell_settings,
            device=self.device)
        return self._rows

    def select_cell_at(self, x: float, y: float) -> Optional[int]:
        """Click selection: first polygon containing the point
        (FA_Analyzer.py:668-684)."""
        for i, poly in enumerate(self.rois):
            if contains_point(poly, x, y):
                self.selected = i
                return i
        self.selected = None
        return None

    def _globals(self) -> dict:
        return {"alpha": self.cfg.alpha, "min_area_um": self.cfg.min_area_um,
                "max_area_um": self.cfg.max_area_um,
                "close_radius": self.cfg.close_radius,
                "subtract_bg": self.cfg.subtract_bg}

    def params_for_selected(self) -> dict:
        base = self._globals()
        if self.selected is not None and self.selected in self.cell_settings:
            base.update(self.cell_settings[self.selected])
        return base

    def set_params(self, **kwargs):
        """Update the selected cell's overrides (or the globals when no cell
        is selected) and reanalyze."""
        if self.selected is None:
            for k, v in kwargs.items():
                setattr(self.cfg, k, v)
        else:
            cur = self.cell_settings.setdefault(
                self.selected, self.params_for_selected())
            cur.update(kwargs)
        return self.reanalyze()

    def display_range(self) -> tuple:
        """(vmin, vmax) for the current ``visual_boost``
        (FA_Analyzer.py:722-744): boost b >= 0 divides the dynamic range by
        (1 + b) — brighten; b < 0 multiplies it by (1 + |b|) — darken."""
        flat = self.img.ravel()
        vmin = float(flat.min())
        rng = float(flat.max()) - vmin
        b = self.visual_boost
        new_range = rng / (1.0 + b) if b >= 0 else rng * (1.0 + abs(b))
        return vmin, vmin + new_range

    def zoom_bounds(self) -> Optional[tuple]:
        """(xlim, ylim) framing the selected cell with 20% + 20 px padding,
        y inverted for image coordinates (FA_Analyzer.py:751-760); None when
        no cell is selected."""
        if self.selected is None:
            return None
        roi = np.asarray(self.rois[self.selected], float)
        xs, ys = roi[:, 0], roi[:, 1]
        pad_x = (xs.max() - xs.min()) * 0.2 + 20
        pad_y = (ys.max() - ys.min()) * 0.2 + 20
        return ((xs.min() - pad_x, xs.max() + pad_x),
                (ys.max() + pad_y, ys.min() - pad_y))

    def fa_count(self, cell_idx: Optional[int] = None) -> int:
        if cell_idx is None:
            return len(self._rows)
        return sum(1 for r in self._rows if r["cell"] == cell_idx + 1)

    def save(self) -> str:
        """Write the individual_results CSV with each cell's effective
        settings (the resume checkpoint, FA_Analyzer.py:1039-1049); with
        zero FAs it holds the header alone."""
        indiv = os.path.join(self.out_root, "individual_results")
        os.makedirs(indiv, exist_ok=True)
        out_rows = []
        for r in self._rows:
            cell0 = r["cell"] - 1
            eff = self._globals()
            eff.update(self.cell_settings.get(cell0, {}))
            out_rows.append([
                self.s_tag, r["cell"], r["category"], r["area"],
                r["area"] * self.cfg.px_size ** 2,
                r["mean_int_raw"], r["mean_int_corr"],
                r["int_den_raw"], r["int_den_corr"], r["bg_level"],
                eff["alpha"], self._thresholds.get(cell0, np.nan),
                eff["min_area_um"], eff["max_area_um"], eff["close_radius"],
                eff["subtract_bg"],
            ])
        path = os.path.join(indiv, f"{self.s_tag}_results.csv")
        _write_csv(path, FA_CSV_COLS, out_rows)
        self.log(t("tune_saved").format(path=path))
        return path

    # --- matplotlib UI (needs matplotlib and a display) --------------------

    def show(self):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        fig = self._fig = plt.figure(figsize=(11, 8))
        ax = self._ax = fig.add_axes([0.05, 0.25, 0.9, 0.7])
        sliders = self._sliders = {}
        for row, (name, lo, hi, val) in enumerate([
            ("alpha", 0.5, 12.0, self.cfg.alpha),
            ("min_area_um", 0.1, 10.0, self.cfg.min_area_um),
            ("max_area_um", 1.0, 100.0, self.cfg.max_area_um),
            ("close_radius", 0, 5, self.cfg.close_radius),
        ]):
            sax = fig.add_axes([0.15, 0.16 - row * 0.04, 0.6, 0.03])
            sliders[name] = Slider(sax, name, lo, hi, valinit=val)

        def redraw():
            ax.clear()
            vlo, vhi = self.display_range()
            ax.imshow(self.img, cmap="gray", vmin=vlo, vmax=vhi,
                      interpolation="nearest")
            if self.show_mat:
                for P in self.mat_polys:  # (N, 2) [x, y]
                    ax.plot(P[:, 0], P[:, 1], linewidth=1.0,
                            color="magenta", linestyle="--")
            for i, poly in enumerate(self.rois):
                color = "cyan" if i == self.selected else "yellow"
                P = np.asarray(poly)
                ax.plot(np.r_[P[:, 0], P[0, 0]], np.r_[P[:, 1], P[0, 1]],
                        color=color, lw=1.2, linestyle="--")
                ax.text(P[:, 0].mean(), P[:, 1].mean(),
                        f"{i + 1}: {self.fa_count(i)} FA", color=color)
            for r in self._rows:
                cy, cx = r["centroid"]
                ax.plot(cx, cy, "r+", ms=4)
            if self.auto_zoom:
                zb = self.zoom_bounds()
                if zb is not None:
                    ax.set_xlim(*zb[0])
                    ax.set_ylim(*zb[1])
            ax.set_title(f"{self.s_tag} — click a cell; s: save, q: quit, "
                         f"+/-: boost {self.visual_boost:+d}, z: zoom, m: mat")
            ax.set_axis_off()
            fig.canvas.draw_idle()

        syncing = [False]  # guard: programmatic set_val fires on_changed

        def on_slider(_):
            if syncing[0]:
                return
            vals = {n: (int(s.val) if n == "close_radius" else float(s.val))
                    for n, s in sliders.items()}
            self.set_params(**vals)
            redraw()

        for s in sliders.values():
            s.on_changed(on_slider)

        def on_click(event):
            if event.inaxes is ax and event.xdata is not None:
                self.select_cell_at(event.xdata, event.ydata)
                # reflect the selected cell's effective params in the
                # sliders WITHOUT running set_params: the set_val cascade
                # would create a spurious per-cell override (freezing the
                # cell against later global slider moves) and reanalyze
                # four times per click
                p = self.params_for_selected()
                syncing[0] = True
                try:
                    for n, s in sliders.items():
                        s.set_val(p[n])
                finally:
                    syncing[0] = False
                redraw()

        def on_key(event):
            if event.key == "s":
                self.save()
            elif event.key == "q":
                plt.close(fig)
            elif event.key in ("+", "="):
                self.visual_boost = min(15, self.visual_boost + 1)
                redraw()
            elif event.key == "-":
                self.visual_boost = max(-15, self.visual_boost - 1)
                redraw()
            elif event.key == "z":
                self.auto_zoom = not self.auto_zoom
                redraw()
            elif event.key == "m":
                self.show_mat = not self.show_mat
                redraw()

        fig.canvas.mpl_connect("button_press_event", on_click)
        fig.canvas.mpl_connect("key_press_event", on_key)
        redraw()
        plt.show()


def main(img_dir: str, roi_dir: str, out_root: str,
         cfg: Optional[FaConfig] = None, mat_dir: Optional[str] = None,
         log=print, device="cuda"):
    """One tuner per (image, ROI JSON) pair of ``cfg.channel``, each shown
    until closed."""
    cfg = cfg or FaConfig()
    for img_path, json_path, s_tag in list_fa_pairs(img_dir, roi_dir,
                                                    cfg.channel):
        log(t("tune_tag").format(tag=s_tag))
        FATuner(img_path, json_path, s_tag, out_root, cfg,
                mat_dir=mat_dir, log=log, device=device).show()
