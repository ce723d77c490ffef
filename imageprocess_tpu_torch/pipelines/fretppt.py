"""FRET timelapse -> PowerPoint deck (the reference's
Make_FRET_timelapsePPT; the port's copy of
``imageprocess_tpu/pipelines/fretppt.py``, host only).

Reference semantics: src/FRET/Make_FRET_timelapsePPT.py — filename pattern
``S##_t##_roi#_<suffix>.{png,tif}`` (:36-39), keyword channel classifier
(:47-56, fret: dov/ratio/fret; bf: bf/phase/dic/ch*), pairing requires BOTH
channels per timepoint (:59-97), per-(stage, roi) 16:9 slides with a
time-row of FRET over BF thumbnails that auto-shrink to fit (:100-188),
output ``FRET_timelapse_auto.pptx`` in the image folder.

Structure (project idiom, like ``report.render``): the slide geometry is a
PURE spec — :func:`fit_row_width` / :func:`slide_layout` return plain
numbers/dataclasses with no I/O, unit-tested in isolation — and
:func:`build_ppt` is a thin painter that feeds specs to
``report.pptxlite``.  The layout constants (slide 33.867x19.05 cm, margins
1.0/1.5 cm, gaps 0.3/0.1 cm) are the reference's output contract and are
kept verbatim in :class:`DeckGeometry`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..report.pptxlite import Presentation, cm

# --- filename spec (the reference's input contract) -------------------------

FNAME_PATTERN = re.compile(
    r"^(S\d+)_t(\d+)_roi(\d+)_(.+)\.(png|tif|tiff)$", re.IGNORECASE
)

#: suffix keyword -> channel kind; first hit wins, FRET checked before BF.
#: NOTE the reference quirk: "FoverD_*" names match NEITHER list and are
#: dropped (Make_FRET_timelapsePPT.py:47-56) — preserved.
_FRET_KEYWORDS = ("dov", "ratio", "fret")
_BF_KEYWORDS = ("bf", "phase", "dic")


def classify_channel(suffix: str) -> Optional[str]:
    suf = suffix.lower()
    if any(k in suf for k in _FRET_KEYWORDS):
        return "fret"
    if any(k in suf for k in _BF_KEYWORDS) or suf.startswith("ch"):
        return "bf"
    return None


def collect_pairs(img_dir: str) -> Dict[Tuple[str, str], List[Tuple[int, str, str]]]:
    """{(stage, roi): [(time, fret_path, bf_path), ...]} time-sorted.

    Only timepoints with BOTH a FRET-classified and a BF-classified image
    survive (the reference drops incomplete pairs silently).
    """
    # (stage, roi) -> time -> kind -> path
    series: Dict[Tuple[str, str], Dict[int, Dict[str, str]]] = {}
    for fname in sorted(os.listdir(img_dir)):
        m = FNAME_PATTERN.match(fname)
        if m is None:
            continue
        path = os.path.join(img_dir, fname)
        if not os.path.isfile(path):
            continue
        stage, t_str, roi, suffix, _ext = m.groups()
        kind = classify_channel(suffix)
        if kind is None:
            continue
        series.setdefault((stage, roi), {}).setdefault(
            int(t_str), {})[kind] = path
    return {
        key: [(t, by_kind["fret"], by_kind["bf"])
              for t, by_kind in sorted(times.items())
              if "fret" in by_kind and "bf" in by_kind]
        for key, times in series.items()
    }


# --- pure layout spec -------------------------------------------------------

@dataclass(frozen=True)
class DeckGeometry:
    """Reference layout constants (EMU), Make_FRET_timelapsePPT.py:100-115."""

    slide_w: int = cm(33.867)   # 16:9
    slide_h: int = cm(19.05)
    margin_x: int = cm(1.0)     # left AND right
    margin_top: int = cm(1.5)
    row_gap: int = cm(0.3)      # FRET row -> BF row
    col_gap: int = cm(0.1)      # between timepoints
    caption_box: Tuple[int, int, int, int] = (
        cm(1.0), cm(0.5), cm(15), cm(1.0))  # left, top, w, h


def fit_row_width(n: int, desired_w: int, geo: DeckGeometry) -> Optional[int]:
    """Per-thumbnail width (EMU) for an *n*-column row: the desired width
    if it fits inside the side margins, else shrunk so the whole row does;
    ``None`` when even zero-width thumbnails cannot fit (gap overflow)."""
    if n <= 0:
        return None
    gaps = geo.col_gap * (n - 1)
    avail = geo.slide_w - 2 * geo.margin_x - gaps
    if desired_w * n <= avail:
        return desired_w
    if avail <= 0:
        return None
    return int(desired_w * (avail / (desired_w * n)))


@dataclass(frozen=True)
class SlideSpec:
    """Everything one slide paints: square thumbnail geometry + caption."""

    img_w: int                 # thumbnail width == height (square crops)
    lefts: Tuple[int, ...]     # one x per timepoint
    fret_top: int
    bf_top: int
    caption: str


def slide_layout(
    stage: str, roi: str, times: Tuple[int, ...], desired_w: int,
    geo: DeckGeometry = DeckGeometry(),
) -> Optional[SlideSpec]:
    """Pure geometry for one (stage, roi) timeline slide (or None if the
    row cannot fit).  Rows: FRET on top, BF below, one column per time."""
    img_w = fit_row_width(len(times), desired_w, geo)
    if img_w is None:
        return None
    lefts = tuple(geo.margin_x + i * (img_w + geo.col_gap)
                  for i in range(len(times)))
    return SlideSpec(
        img_w=img_w,
        lefts=lefts,
        fret_top=geo.margin_top,
        bf_top=geo.margin_top + img_w + geo.row_gap,
        caption=(f"{stage}  ROI{roi}  (top: FRET / bottom: BF, "
                 f"t00 -> t{times[-1]:02d})"),
    )


def _slide_order(key: Tuple[str, str]) -> Tuple[int, int]:
    stage, roi = key
    return int(stage[1:]), int(roi)


# --- painter ----------------------------------------------------------------

def build_ppt(timeline, img_dir: str, img_width_cm: float = 2.0):
    """(success, message); writes ``FRET_timelapse_auto.pptx``."""
    if not timeline:
        return False, "no valid FRET/BF pairs found"

    geo = DeckGeometry()
    prs = Presentation(slide_width=geo.slide_w, slide_height=geo.slide_h)
    for key in sorted(timeline, key=_slide_order):
        seq = timeline[key]
        if not seq:
            continue
        spec = slide_layout(key[0], key[1],
                            tuple(t for t, _, _ in seq),
                            cm(img_width_cm), geo)
        if spec is None:
            return False, (f"{key[0]} ROI{key[1]}: too many images to fit; "
                           "reduce image width or timepoints")
        slide = prs.add_slide()
        for left, (_, fret_path, bf_path) in zip(spec.lefts, seq):
            slide.add_picture(fret_path, left, spec.fret_top, width=spec.img_w)
            slide.add_picture(bf_path, left, spec.bf_top, width=spec.img_w)
        slide.add_textbox(spec.caption, *geo.caption_box)

    out_path = os.path.join(img_dir, "FRET_timelapse_auto.pptx")
    prs.save(out_path)
    return True, out_path


def run_fret_ppt(img_dir: str, img_width_cm: float = 2.0, log=print):
    timeline = collect_pairs(img_dir)
    ok, msg = build_ppt(timeline, img_dir, img_width_cm)
    log(("[saved] " if ok else "[failed] ") + str(msg))
    return ok, msg
