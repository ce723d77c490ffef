"""Filename grammar and dataset discovery (the port's copy).

TIFF basenames like ``S01_t03_2.TIF`` encode (stage, time, channel); one
parser with a ``ChannelGrammar`` mode keeps each workload's legacy rules:

- ``TOKEN_OR_LAST``: a bounded ``_chN``/``_cN`` token anywhere, else the
  last all-digit ``[_-]``-separated token (not the time token's digits);
  the intensity runner's grammar.
- ``END_ANCHORED``: an end-anchored ``[_-]N`` or ``[_-](ch|c)N``, stage
  and time regexes unanchored; the FRET runner's grammar.
- ``KEYWORD``: ``[-_]N`` at the end, then ``(ch|c)N`` anywhere, then
  fluorophore keywords (ecfp/cfp/donor -> 1, yfret/fret/acceptor/yfp -> 2);
  the auto drawer's grammar.

Host-side pure Python; it feeds the device pipelines.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple


class ChannelGrammar(str, Enum):
    TOKEN_OR_LAST = "token_or_last"
    END_ANCHORED = "end_anchored"
    KEYWORD = "keyword"


@dataclass(frozen=True)
class FrameKey:
    """Parsed identity of one TIFF frame."""

    stage: Optional[int]
    time: Optional[int]
    channel: Optional[int]


# --- sorting & discovery ----------------------------------------------------

_NAT_SPLIT = re.compile(r"(\d+)")


def natural_key(s: str):
    """Sort key treating digit runs numerically (``S2`` < ``S10``)."""
    return [int(tok) if tok.isdigit() else tok.lower() for tok in _NAT_SPLIT.split(s)]


def list_tifs(folder: str) -> List[str]:
    """All TIFFs in *folder* (4 extension casings), de-duplicated by
    case-normalized absolute path, natural-sorted.
    Reference behavior: src/INT/Fluor_INT.py:265-275."""
    found = []
    for ext in ("*.tif", "*.tiff", "*.TIF", "*.TIFF"):
        found.extend(glob.glob(os.path.join(folder, ext)))
    unique: Dict[str, str] = {}
    for p in found:
        unique.setdefault(os.path.normcase(os.path.abspath(p)), p)
    return sorted(unique.values(), key=natural_key)


# --- token parsing ----------------------------------------------------------

_STAGE_BOUNDED = re.compile(r"(?i)(?:^|[_-])S(\d+)(?=$|[_-])")
_TIME_BOUNDED = re.compile(r"(?i)(?:^|[_-])t(\d+)(?=$|[_-])")
_STAGE_LOOSE = re.compile(r"(?i)S(\d+)")
_TIME_LOOSE = re.compile(r"(?i)t(\d+)")
_CH_BOUNDED = re.compile(r"(?i)(?:^|[_-])(?:ch|c)(\d{1,3})(?=$|[_-])")
_CH_END = re.compile(r"(?i)(?:[_-](\d+)$)|(?:[_-](?:ch|c)(\d+)$)")
_CH_TRAIL_NUM = re.compile(r"(?i)[-_](\d+)$")
_CH_PREFIXED = re.compile(r"(?i)(?:ch|c)(\d+)(?=[._-]|$)")
_TOKEN_SPLIT = re.compile(r"[_-]")

_DONOR_KEYWORDS = ("ecfp", "cfp", "donor")
_ACCEPTOR_KEYWORDS = ("yfret", "fret", "acceptor", "yfp")


def _strip_ext(basename: str) -> str:
    return os.path.splitext(basename)[0]


def parse_tokens(
    basename: str,
    timelapse: bool,
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST,
) -> FrameKey:
    """Extract (stage, time, channel) ints from a TIFF basename."""
    name = _strip_ext(basename)

    if grammar is ChannelGrammar.TOKEN_OR_LAST:
        ms = _STAGE_BOUNDED.search(name)
        stage = int(ms.group(1)) if ms else None
        time = None
        time_digits = None
        if timelapse:
            mt = _TIME_BOUNDED.search(name)
            if mt:
                time_digits = mt.group(1)
                time = int(time_digits)
        mc = _CH_BOUNDED.search(name)
        if mc:
            channel: Optional[int] = int(mc.group(1))
        else:
            digit_tokens = [tok for tok in _TOKEN_SPLIT.split(name) if tok.isdigit()]
            if timelapse and time_digits is not None:
                digit_tokens = [tok for tok in digit_tokens if tok != time_digits]
            channel = int(digit_tokens[-1]) if digit_tokens else None
        return FrameKey(stage, time, channel)

    # END_ANCHORED and KEYWORD share loose stage/time regexes.
    ms = _STAGE_LOOSE.search(name)
    stage = int(ms.group(1)) if ms else None
    time = None
    if timelapse:
        mt = _TIME_LOOSE.search(name)
        time = int(mt.group(1)) if mt else None

    if grammar is ChannelGrammar.END_ANCHORED:
        mc = _CH_END.search(name)
        channel = None
        if mc:
            g = next((g for g in mc.groups() if g is not None), None)
            channel = int(g) if g is not None else None
        return FrameKey(stage, time, channel)

    # KEYWORD grammar: trailing number, then (ch|c)N, then fluorophore names.
    mc = _CH_TRAIL_NUM.search(name)
    if mc:
        return FrameKey(stage, time, int(mc.group(1)))
    mc = _CH_PREFIXED.search(name)
    if mc:
        return FrameKey(stage, time, int(mc.group(1)))
    low = name.lower()
    if any(k in low for k in _DONOR_KEYWORDS):
        return FrameKey(stage, time, 1)
    if any(k in low for k in _ACCEPTOR_KEYWORDS):
        return FrameKey(stage, time, 2)
    return FrameKey(stage, time, None)


def fmt_stage(n: int) -> str:
    return f"S{int(n):02d}"


def fmt_time(n: int) -> str:
    return f"t{int(n):02d}"


def clean_base_for_save(
    basename: str,
    timelapse: bool,
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST,
    strip_trailing_number_fallback: bool = True,
) -> str:
    """Canonical 2-digit save name ``S01[_t00]``.

    When no stage token is found, Fluor_INT/drawer strip a trailing
    ``[_-]N`` (Fluor_INT.py:324-331); MOR/FRET return the name unchanged
    (MOR_by_ROI.py:85-91) — controlled by *strip_trailing_number_fallback*.
    """
    key = parse_tokens(basename, timelapse, grammar)
    if key.stage is None:
        name = _strip_ext(basename)
        if strip_trailing_number_fallback:
            return re.sub(r"([_-])\d+$", "", name)
        return name
    if timelapse and key.time is not None:
        return f"{fmt_stage(key.stage)}_{fmt_time(key.time)}"
    return fmt_stage(key.stage)


def roi_base_candidates(
    roi_dir: str,
    basename: str,
    timelapse: bool,
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST,
) -> List[str]:
    """Standard (``S01[_t00]``) then legacy (``S1[_t0]``) ROI base paths.
    Reference: Fluor_INT.py:333-346."""
    key = parse_tokens(basename, timelapse, grammar)
    cands = [os.path.join(roi_dir, clean_base_for_save(basename, timelapse, grammar))]
    if key.stage is not None:
        legacy = f"S{int(key.stage)}"
        if timelapse and key.time is not None:
            legacy = f"{legacy}_t{int(key.time)}"
        cands.append(os.path.join(roi_dir, legacy))
    return cands


def find_roi_basepath(
    roi_dir: str,
    basename: str,
    timelapse: bool,
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST,
    exts: Sequence[str] = (".json", ".png"),
) -> str:
    """First ROI base path for which any of *exts* exists, else the standard
    candidate (so the caller's error message names the expected file)."""
    cands = roi_base_candidates(roi_dir, basename, timelapse, grammar)
    for base in cands:
        if any(os.path.exists(base + e) for e in exts):
            return base
    return cands[0]


# --- keymaps & pairing ------------------------------------------------------

Key = Tuple[str, Optional[str]]


def build_keymap(
    files: Sequence[str],
    timelapse: bool,
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST,
) -> Dict[Key, Dict[int, str]]:
    """Group files as {(``Sxx``, ``txx``|None): {channel: path}}, sorted by
    (stage index, time index).  Reference: Fluor_INT.py:372-394."""
    keymap: Dict[Key, Dict[int, str]] = {}
    for p in files:
        k = parse_tokens(os.path.basename(p), timelapse, grammar)
        if k.stage is None or k.channel is None:
            continue
        t = fmt_time(k.time) if (timelapse and k.time is not None) else None
        keymap.setdefault((fmt_stage(k.stage), t), {})[k.channel] = p

    def order(item):
        s, t = item[0]
        s_idx = int(re.search(r"\d+", s).group()) if s else -1
        t_idx = int(re.search(r"\d+", t).group()) if t else -1
        return (s_idx, t_idx)

    return dict(sorted(keymap.items(), key=order))


def build_pairs_by_channel(
    files: Sequence[str],
    timelapse: bool,
    donor_ch: int,
    acceptor_ch: int,
    grammar: ChannelGrammar = ChannelGrammar.END_ANCHORED,
) -> Tuple[List[Tuple[Key, str, str]], Dict[Key, Dict[int, str]]]:
    """(key, donor_path, acceptor_path) for every key holding both channels.
    Reference: the Nesprin2 FRET script, :1264-1285."""
    keymap = build_keymap(files, timelapse, grammar)
    pairs = []
    for key, chmap in keymap.items():
        if donor_ch in chmap and acceptor_ch in chmap:
            pairs.append((key, chmap[donor_ch], chmap[acceptor_ch]))
    return pairs, keymap


def swap_channel_in_name(path: str, new_channel: int) -> str:
    """Rewrite the trailing channel token of *path* to *new_channel* —
    used to locate the intensity / acceptor-only frames next to a FRET pair.
    Reference: the Nesprin2 FRET script, :370-384."""
    d, base = os.path.split(path)
    name, ext = os.path.splitext(base)
    new_name, n = re.subn(
        r"(?i)([_-])(?:ch|c)?\d+$", rf"\g<1>{int(new_channel)}", name
    )
    if n == 0:
        new_name = f"{name}_{int(new_channel)}"
    return os.path.join(d, new_name + ext)
