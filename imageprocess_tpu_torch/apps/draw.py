"""Interactive ROI annotator — the roi_manual_drawer GUI (port of
``imageprocess_tpu/apps/draw.py``).

Reference behavior (src/roi_manual_drawer.py:667-1276 ``ROIAnnotator`` /
``ROIAnnotatorCH``): draw a rough polygon ('p' + PolygonSelector), the core
auto-segments the brightest object inside it (threshold percentile / BND
mode), accept or retry with a new threshold, manage ROIs (undo 'u', clear
'c'), cycle channels (Tab/Shift+Tab), adjust the display (percentile
window 'a'/'d'/'s'/'f', gamma 'g'/'G', invert 'i', pseudocolor '0'-'5',
reset 'v') and the filter pipeline (CLAHE 'e', bandpass 'b', unsharp 'n',
Sobel edge overlay 'o'), and save the full bundle on close (JSON + mask +
overlay + ImageJ zip).  The full key map lives in :meth:`handle_key`.

Device work (the view filters, the in-polygon segmentation) runs on
``device`` (default ``"cuda"``, no fallback); the core actions need no
display.  matplotlib only displays, and only the display methods import it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import naming, roiio, tiffio
from ..core.i18n import t
from ..device import resolve_device
from ..geom.polygon import contains_point
from ..ops.view import clahe, dog_bandpass, sobel_magnitude, unsharp
from ..segment.autoseg import segment_inside_polygon
from ..segment.drawer import DEFAULT_VIEW_PARAMS, apply_view_and_color, save_drawer_bundle


class ROIAnnotator:
    """One (stage, time) task with channel cycling."""

    def __init__(self, channel_map: Dict[int, str], base_S_t: str,
                 roi_dir: str, thr_param: float = 90.0, min_area: float = 40.0,
                 tolerance: float = 1.0, mode: str = "percentile",
                 view_params: Optional[dict] = None, log=print,
                 device="cuda"):
        self.device = resolve_device(device)
        self.channel_map = dict(sorted(channel_map.items()))
        self.channels = list(self.channel_map)
        self.ch_idx = 0
        self.base = base_S_t
        self.roi_dir = roi_dir
        self.thr_param = thr_param
        self.min_area = min_area
        self.tolerance = tolerance
        self.mode = mode
        self.view = dict(view_params or DEFAULT_VIEW_PARAMS)
        self.rois: List[np.ndarray] = []
        self.log = log
        # resume an existing bundle (the reference loads init_rois and the
        # saved view state, roi_manual_drawer.py:1423-1433, 1499-1516) —
        # without this, opening and closing a task would overwrite prior
        # manual annotations with an empty bundle
        self._had_bundle = False
        bundle_json = os.path.join(roi_dir, f"{base_S_t}.json")
        if os.path.exists(bundle_json):
            data = roiio.load_roi_bundle(bundle_json)
            self.rois = [np.asarray(p, float) for p in data.get("rois", [])
                         if len(p) >= 3]
            self._had_bundle = True
            if view_params is None and isinstance(
                    data.get("view_params"), dict):
                self.view.update(data["view_params"])
                last = self.view.get("last_channel")
                if last in self.channels:
                    self.ch_idx = self.channels.index(last)
            if self.rois:
                log(t("draw_resumed").format(
                    count=len(self.rois), path=bundle_json))
        self._images: Dict[int, np.ndarray] = {}
        self._fig = None
        self._ax = None
        self._im = None
        self._selector = None
        self._roi_artists = []   # outline/label artists _redraw owns

    # --- data ---------------------------------------------------------------

    @property
    def channel(self) -> int:
        return self.channels[self.ch_idx]

    @property
    def image(self) -> np.ndarray:
        ch = self.channel
        if ch not in self._images:
            self._images[ch] = tiffio.read_2d(self.channel_map[ch])
        return self._images[ch]

    # --- core actions (UI-independent, unit-testable) ----------------------

    def _segment(self, verts, thr_param: float):
        return segment_inside_polygon(
            self.image, np.asarray(verts, float), thr_param=thr_param,
            min_area=self.min_area, tolerance=self.tolerance, mode=self.mode,
            device=self.device)

    def add_rough_polygon(self, verts) -> Optional[np.ndarray]:
        """PolygonSelector callback: refine the rough polygon and stage it."""
        poly = np.asarray(verts, float)
        if poly.shape[0] < 3:
            return None
        thr, _, best = self._segment(poly, self.thr_param)
        chosen = best if best is not None else poly
        self.rois.append(chosen)
        kind = t("draw_kind_auto" if best is not None else "draw_kind_rough")
        self.log(t("draw_roi_added").format(
            n=len(self.rois), thr=thr, kind=kind, nv=len(chosen)))
        return chosen

    def propose_polygon(self, verts, thr_param: Optional[float] = None):
        """Accept/retry loop support (roi_manual_drawer.py:1052-1077):
        segment WITHOUT committing — returns (thr, candidate polygon or
        None).  Call again with a new *thr_param* to retry; pass the
        accepted candidate to :meth:`accept`."""
        poly = np.asarray(verts, float)
        if poly.shape[0] < 3:
            return None, None
        thr, _, best = self._segment(
            poly, self.thr_param if thr_param is None else thr_param)
        return thr, (best if best is not None else poly)

    def accept(self, poly: np.ndarray, index: Optional[int] = None) -> int:
        """Commit a proposed polygon: append, or replace ROI *index*
        (per-index redraw, roi_manual_drawer.py:1206-1276)."""
        if index is None:
            self.rois.append(np.asarray(poly, float))
            return len(self.rois) - 1
        self.rois[index] = np.asarray(poly, float)
        return index

    def roi_index_at(self, x: float, y: float) -> Optional[int]:
        """ROI under a click: topmost polygon containing (x, y), else the
        nearest centroid within 50 px (the reference ROI manager's
        pick-by-click selection)."""
        for i in reversed(range(len(self.rois))):
            if contains_point(self.rois[i], x, y):
                return i
        best, best_d = None, 50.0
        for i, p in enumerate(self.rois):
            d = float(np.hypot(*(np.asarray(p).mean(axis=0) - [x, y])))
            if d < best_d:
                best, best_d = i, d
        return best

    def delete_index(self, i: int) -> None:
        """Delete one ROI by index (remaining ROIs renumber)."""
        if 0 <= i < len(self.rois):
            self.rois.pop(i)

    def replace_index(self, i: int, verts) -> Optional[np.ndarray]:
        """Re-draw ROI *i*: re-run the in-polygon segmentation on the new
        rough polygon and swap it in place, keeping the ROI's number."""
        if not (0 <= i < len(self.rois)):
            return None
        _, chosen = self.propose_polygon(verts)
        if chosen is None:
            return None
        self.rois[i] = chosen
        self.log(t("draw_roi_redrawn").format(i=i + 1, nv=len(chosen)))
        return chosen

    def delete_last(self) -> None:
        if self.rois:
            self.rois.pop()

    def clear(self) -> None:
        self.rois.clear()

    def cycle_channel(self, step: int = 1) -> int:
        self.ch_idx = (self.ch_idx + step) % len(self.channels)
        return self.channel

    # keyboard map, cursor-independent part (reference on_key,
    # roi_manual_drawer.py:1095-1141 + channel Tab :1273-1275).  Key ->
    # reference behavior; where the reference letter was already taken by a
    # repo-only extra, the binding is remapped and listed in docs/CLI.md:
    #   u        undo last ROI            (reference 'u')
    #   c        clear ROIs               (reference 'c')
    #   a / d    display floor -/+ 1%     (reference 'a'/'d')
    #   s / f    display ceil  -/+ 1%     (reference 's'/'f')
    #   g / G    gamma -/+ 0.1            (reference 'g'/'G')
    #   i        invert                   (reference 'i')
    #   0-5      pseudocolor gray/cyan/blue/green/red/yellow ('0'-'5')
    #   v        reset view               (reference 'r'; repo 'r' =
    #                                      redraw-at-cursor)
    #   tab / shift+tab  cycle channel    (reference Tab/Shift+Tab)
    #   e / b / n / o    CLAHE / bandpass / unsharp / Sobel-edge toggles
    #                    (reference view_params, :703-711 — no reference
    #                     key exists; bound here so every render-pipeline
    #                     stage is reachable without editing JSON)
    _COLOR_KEYS = {"0": "grayscale", "1": "cyan", "2": "blue",
                   "3": "green", "4": "red", "5": "yellow"}
    _TOGGLE_KEYS = {"i": "invert", "e": "use_clahe", "b": "use_bandpass",
                    "n": "use_unsharp", "o": "edge_overlay"}

    def handle_key(self, key: str) -> bool:
        """Apply a cursor-independent key binding; returns True when the
        view changed (the UI then redraws).  UI-free so tests can drive
        every binding headlessly."""
        v = self.view
        if key == "u":
            self.delete_last()
        elif key == "c":
            self.clear()
        elif key == "a":
            v["p_low"] = max(0.0, v.get("p_low", 1.0) - 1.0)
        elif key == "d":
            v["p_low"] = min(v.get("p_high", 99.0) - 0.1,
                             v.get("p_low", 1.0) + 1.0)
        elif key == "s":
            v["p_high"] = max(v.get("p_low", 1.0) + 0.1,
                              v.get("p_high", 99.0) - 1.0)
        elif key == "f":
            v["p_high"] = min(100.0, v.get("p_high", 99.0) + 1.0)
        elif key == "g":
            v["gamma"] = max(0.2, v.get("gamma", 1.0) - 0.1)
        elif key == "G":
            v["gamma"] = min(5.0, v.get("gamma", 1.0) + 0.1)
        elif key == "v":
            v.update(p_low=1.0, p_high=99.0, gamma=1.0, invert=False)
        elif key in self._COLOR_KEYS:
            v["color_mode"] = self._COLOR_KEYS[key]
        elif key in self._TOGGLE_KEYS:
            name = self._TOGGLE_KEYS[key]
            v[name] = not v.get(name, False)
        elif key == "tab":
            self.cycle_channel(+1)
        elif key == "shift+tab":
            self.cycle_channel(-1)
        else:
            return False
        return True

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def rendered(self) -> np.ndarray:
        """View-rendered RGB frame, with the drawer's optional device-side
        filter pipeline (roi_manual_drawer.py:870-946): bandpass DoG,
        unsharp, CLAHE, Sobel edge overlay."""
        im = self.image.astype(np.float32)
        v = self.view
        if v.get("use_bandpass") or v.get("use_unsharp"):
            x = self._on_device(im)
            if v.get("use_bandpass"):
                x = dog_bandpass(x, float(v.get("sigma_small", 1.0)),
                                 float(v.get("sigma_large", 6.0)))
            if v.get("use_unsharp"):
                x = unsharp(x, float(v.get("unsharp_radius", 2.0)),
                            np.float32(v.get("unsharp_amount", 0.7)))
            im = x.cpu().numpy()
        rgb = apply_view_and_color(im, v)
        # CLAHE applies in the grayscale pipeline only (the reference
        # equalizes before colorizing); no device work in color modes
        if v.get("use_clahe") and v.get("color_mode",
                                        "grayscale") == "grayscale":
            x01 = clahe(self._on_device(rgb[..., 0]),
                        np.float32(v.get("clahe_clip", 0.01))).cpu().numpy()
            rgb = np.dstack([x01, x01, x01])
        if v.get("edge_overlay"):
            ed = sobel_magnitude(self._on_device(rgb[..., 1])).cpu().numpy()
            rgb = rgb.copy()
            rgb[..., 1] = np.clip(rgb[..., 1] + ed * 0.8, 0, 1)
        return rgb

    def save(self) -> None:
        if not self.rois and not self._had_bundle:
            return  # nothing drawn, nothing existed: don't litter roi/
        vp = dict(self.view)
        vp["last_channel"] = self.channel
        save_drawer_bundle(self.roi_dir, self.base, self.rois, self.image,
                           view_params=vp, log=self.log)

    # --- matplotlib UI (needs matplotlib and a display) --------------------

    def show(self) -> None:
        import matplotlib.pyplot as plt
        from matplotlib.widgets import PolygonSelector

        self._fig, self._ax = plt.subplots(figsize=(10, 8))
        self._im = self._ax.imshow(self.rendered())
        self._ax.set_title(self._title())
        self._fig.canvas.mpl_connect("key_press_event", self._on_key)

        def on_select(verts):
            self.add_rough_polygon(verts)
            self._teardown_selector()
            self._redraw()

        def start_polygon():
            if self._selector is not None:
                return  # a live selector would stack: both callbacks fire
            self._selector = PolygonSelector(self._ax, on_select)

        self._start_polygon = start_polygon
        plt.show()
        self.save()

    def _teardown_selector(self):
        """Disconnect AND remove the finished selector's own artists —
        _redraw does not sweep ax.lines, so without this the completed
        selector's polygon/vertex markers would stay overlaid forever."""
        sel, self._selector = self._selector, None
        if sel is None:
            return
        sel.disconnect_events()
        try:
            sel.set_visible(False)
            for art in getattr(sel, "artists", ()):
                art.remove()
        except Exception:
            pass  # matplotlib-version-dependent internals; hidden is enough

    def _title(self):
        return (f"{self.base} ch{self.channel} — p: draw, u: undo, "
                f"x: delete @cursor, r: redraw @cursor, c: clear, "
                f"Tab: channel, a/d/s/f/g/G/v: range, 0-5: color, "
                f"i/e/b/n/o: filters, q: save & close")

    def _on_key(self, event):
        if event.key == "p":
            self._start_polygon()
        elif event.key == "x" and event.xdata is not None:
            i = self.roi_index_at(event.xdata, event.ydata)
            if i is not None:
                self.delete_index(i)
                self._redraw()
        elif event.key == "r" and event.xdata is not None:
            if self._selector is not None:
                return  # don't stack a second live selector
            i = self.roi_index_at(event.xdata, event.ydata)
            if i is not None:
                from matplotlib.widgets import PolygonSelector

                def on_select(verts, i=i):
                    self.replace_index(i, verts)
                    self._teardown_selector()
                    self._redraw()

                self._selector = PolygonSelector(self._ax, on_select)
        elif event.key == "q":
            import matplotlib.pyplot as plt

            plt.close(self._fig)
        elif event.key and self.handle_key(event.key):
            self._redraw()

    def _redraw(self):
        self._im.set_data(self.rendered())
        # remove only OUR outline/label artists: a blanket ax.lines sweep
        # would also delete an active PolygonSelector's in-progress polygon
        for art in self._roi_artists:
            art.remove()
        self._roi_artists = []
        for i, poly in enumerate(self.rois, 1):
            P = np.asarray(poly)
            (ln,) = self._ax.plot(
                np.r_[P[:, 0], P[0, 0]], np.r_[P[:, 1], P[0, 1]],
                color="lime", lw=1.5)
            txt = self._ax.text(P[:, 0].mean(), P[:, 1].mean(), str(i),
                                color="yellow")
            self._roi_artists += [ln, txt]
        self._ax.set_title(self._title())
        self._fig.canvas.draw_idle()


def main(img_dir: str, timelapse: bool = False, log=print,
         device="cuda") -> None:
    """Startup flow (roi_manual_drawer.py:1375-1433): group TIFFs by
    (stage, time), one annotator per task, each shown until closed."""
    files = naming.list_tifs(img_dir)
    keymap = naming.build_keymap(files, timelapse,
                                 naming.ChannelGrammar.KEYWORD)
    roi_dir = os.path.join(img_dir, "roi")
    for (s, t_code), chmap in keymap.items():
        base = s if t_code is None else f"{s}_{t_code}"
        log(t("draw_task").format(base=base, channels=sorted(chmap)))
        ROIAnnotator(chmap, base, roi_dir, log=log, device=device).show()
