"""The automatic ticks of a colorbar's long axis, without matplotlib.

A copy of the two pieces of matplotlib 3.10.8 that place and label the
ticks of the JAX package's colorbars, on plain floats:

- ``tick_values`` / ``visible_ticks``: ``AutoLocator``, which is
  ``MaxNLocator(nbins="auto", steps=[1, 2, 2.5, 5, 10])``.  ``nbins`` is the
  axis's tick space (``tick_space``: its length in points over twice the
  tick label size, clipped to 1..9); the colorbar keeps the ticks within the
  view interval (``Axis._update_ticks``, a 1e-10 relative slack).
- ``ScalarFormatter``: the labels and the offset text at the default
  rcParams (``axes.formatter.useoffset`` True, ``offset_threshold`` 4,
  ``limits`` [-5, 6], no locale, no mathtext, unicode minus).

``colorbar_view`` gives the view interval a colorbar of ``Normalize(vmin,
vmax)`` sets on its long axis.  Every float operation is the one matplotlib
does, in the same order, so the values and strings are equal to its.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence, Tuple

import numpy as np

# AutoLocator's steps after MaxNLocator._validate_steps, and its staircase
_STEPS = np.array([1, 2, 2.5, 5, 10])
_EXTENDED_STEPS = np.concatenate([0.1 * _STEPS[:-1], _STEPS, [10 * _STEPS[1]]])
_MIN_N_TICKS = 2
_OFFSET_THRESHOLD = 4
_POWERLIMITS = (-5, 6)
_MINUS = "\N{MINUS SIGN}"


def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15, increasing=True):
    """``matplotlib.transforms.nonsingular``: widen an empty or tiny range."""
    if (not np.isfinite(vmin)) or (not np.isfinite(vmax)):
        return -expander, expander
    swapped = False
    if vmax < vmin:
        vmin, vmax = vmax, vmin
        swapped = True
    vmin, vmax = map(float, [vmin, vmax])
    maxabsvalue = max(abs(vmin), abs(vmax))
    if maxabsvalue < (1e6 / tiny) * np.finfo(float).tiny:
        vmin = -expander
        vmax = expander
    elif vmax - vmin <= maxabsvalue * tiny:
        if vmax == 0 and vmin == 0:
            vmin = -expander
            vmax = expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    if swapped and not increasing:
        vmin, vmax = vmax, vmin
    return vmin, vmax


def colorbar_view(vmin, vmax) -> Tuple[float, float]:
    """The long axis's view interval of a colorbar of ``Normalize(vmin,
    vmax)``: the norm's limits through ``nonsingular(expander=0.1)``
    (``Colorbar._process_values``), its first and last boundary
    ``vmin + b * (vmax - vmin)`` for b = 0 and 1, and ``set_ylim``'s
    ``nonsingular(expander=0.05)``."""
    vmin, vmax = nonsingular(vmin, vmax, expander=0.1)
    lo, hi = vmin + 0.0 * (vmax - vmin), vmin + 1.0 * (vmax - vmin)
    return nonsingular(lo, hi, expander=0.05)


def tick_space(axis_len_pt: float, label_pt: float) -> int:
    """``YAxis.get_tick_space``: how many labels of *label_pt* fit, two label
    sizes apart, along *axis_len_pt* points."""
    size = label_pt * 2
    if size > 0:
        return int(np.floor(axis_len_pt / size))
    return 2 ** 31 - 1


def scale_range(vmin, vmax, n=1, threshold=100):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < threshold:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / n) // 1)
    return scale, offset


class _EdgeInteger:
    """``ticker._Edge_integer``: tick multiples with float slop."""

    def __init__(self, step, offset):
        self.step = step
        self._offset = abs(offset)

    def closeto(self, ms, edge):
        if self._offset > 0:
            digits = np.log10(self._offset / self.step)
            tol = max(1e-10, 10 ** (digits - 12))
            tol = min(0.4999, tol)
        else:
            tol = 1e-10
        return abs(ms - edge) < tol

    def le(self, x):
        d, m = divmod(x, self.step)
        if self.closeto(m / self.step, 1):
            return d + 1
        return d

    def ge(self, x):
        d, m = divmod(x, self.step)
        if self.closeto(m / self.step, 0):
            return d
        return d + 1


def tick_values(vmin, vmax, nbins: int) -> np.ndarray:
    """``MaxNLocator.tick_values`` with AutoLocator's steps and *nbins*
    already resolved: the ticks spanning [vmin, vmax], one beyond each end
    where the step needs it."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    scale, offset = scale_range(vmin, vmax, nbins)
    _vmin = vmin - offset
    _vmax = vmax - offset
    steps = _EXTENDED_STEPS * scale
    raw_step = ((_vmax - _vmin) / nbins)
    large_steps = steps >= raw_step
    if any(large_steps):
        istep = np.nonzero(large_steps)[0][0]
    else:
        istep = len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        edge = _EdgeInteger(step, offset)
        low = edge.le(_vmin - best_vmin)
        high = edge.ge(_vmax - best_vmin)
        ticks = np.arange(low, high + 1) * step + best_vmin
        nticks = ((ticks <= _vmax) & (ticks >= _vmin)).sum()
        if nticks >= _MIN_N_TICKS:
            break
    return ticks + offset


def auto_nbins(axis_len_pt: float, label_pt: float) -> int:
    """AutoLocator's ``nbins="auto"``: the tick space clipped to 1..9."""
    return int(np.clip(tick_space(axis_len_pt, label_pt),
                       max(1, _MIN_N_TICKS - 1), 9))


def visible_ticks(locs: Sequence[float], view: Tuple[float, float]) -> np.ndarray:
    """The ticks an axis draws: those within the view interval, with
    ``_interval_contains_close``'s slack of 1e-10 of its length."""
    a, b = sorted(view)
    slack = (b - a) * 1e-10
    locs = np.asarray(locs, float)
    return locs[(a - slack <= locs) & (locs <= b + slack)]


def colorbar_ticks(vmin, vmax, axis_len_pt: float, label_pt: float):
    """(all locator ticks, the visible ones, the view interval) of a
    colorbar of ``Normalize(vmin, vmax)`` whose long axis is *axis_len_pt*
    points long with *label_pt* tick labels."""
    view = colorbar_view(vmin, vmax)
    locs = tick_values(view[0], view[1], auto_nbins(axis_len_pt, label_pt))
    return locs, visible_ticks(locs, view), view


class ScalarFormatter:
    """``matplotlib.ticker.ScalarFormatter`` at the default rcParams.
    ``format_ticks(locs, view)`` labels every tick of the locator (the
    labels of the visible ones are what an axis draws) and sets the offset
    text that ``get_offset`` returns."""

    def __init__(self):
        self.offset = 0
        self.orderOfMagnitude = 0
        self.format = ""
        self.locs: List[float] = []
        self.view = (0.0, 1.0)

    @staticmethod
    def fix_minus(s: str) -> str:
        return s.replace("-", _MINUS)

    def __call__(self, x) -> str:
        if len(self.locs) == 0:
            return ""
        xp = (x - self.offset) / (10. ** self.orderOfMagnitude)
        if abs(xp) < 1e-8:
            xp = 0
        return self.fix_minus(self.format % xp)

    def format_ticks(self, locs, view: Tuple[float, float]) -> List[str]:
        self.view = (float(view[0]), float(view[1]))
        self.set_locs(locs)
        return [self(v) for v in locs]

    def set_locs(self, locs) -> None:
        self.locs = locs
        if len(self.locs) > 0:
            self._compute_offset()
            self._set_order_of_magnitude()
            self._set_format()

    def format_data(self, value) -> str:
        e = math.floor(math.log10(abs(value)))
        s = round(value / 10 ** e, 10)
        significand = self.fix_minus(("%d" if s % 1 == 0 else "%1.10g") % s)
        if e == 0:
            return significand
        exponent = self.fix_minus("%d" % e)
        return f"{significand}e{exponent}"

    def get_offset(self) -> str:
        if len(self.locs) == 0:
            return ""
        if self.orderOfMagnitude or self.offset:
            offset_str = ""
            sci_str = ""
            if self.offset:
                offset_str = self.format_data(self.offset)
                if self.offset > 0:
                    offset_str = "+" + offset_str
            if self.orderOfMagnitude:
                sci_str = "1e%d" % self.orderOfMagnitude
            return self.fix_minus("".join((sci_str, offset_str)))
        return ""

    def _compute_offset(self) -> None:
        vmin, vmax = sorted(self.view)
        locs = np.asarray(self.locs)
        locs = locs[(vmin <= locs) & (locs <= vmax)]
        if not len(locs):
            self.offset = 0
            return
        lmin, lmax = locs.min(), locs.max()
        if lmin == lmax or lmin <= 0 <= lmax:
            self.offset = 0
            return
        abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
        sign = math.copysign(1, lmin)
        oom_max = np.ceil(math.log10(abs_max))
        oom = 1 + next(oom for oom in itertools.count(oom_max, -1)
                       if abs_min // 10 ** oom != abs_max // 10 ** oom)
        if (abs_max - abs_min) / 10 ** oom <= 1e-2:
            oom = 1 + next(oom for oom in itertools.count(oom_max, -1)
                           if abs_max // 10 ** oom - abs_min // 10 ** oom > 1)
        n = _OFFSET_THRESHOLD - 1
        self.offset = (sign * (abs_max // 10 ** oom) * 10 ** oom
                       if abs_max // 10 ** oom >= 10 ** n
                       else 0)

    def _set_order_of_magnitude(self) -> None:
        vmin, vmax = sorted(self.view)
        locs = np.asarray(self.locs)
        locs = locs[(vmin <= locs) & (locs <= vmax)]
        locs = np.abs(locs)
        if not len(locs):
            self.orderOfMagnitude = 0
            return
        if self.offset:
            oom = math.floor(math.log10(vmax - vmin))
        else:
            val = locs.max()
            if val == 0:
                oom = 0
            else:
                oom = math.floor(math.log10(val))
        if oom <= _POWERLIMITS[0] or oom >= _POWERLIMITS[1]:
            self.orderOfMagnitude = oom
        else:
            self.orderOfMagnitude = 0

    def _set_format(self) -> None:
        if len(self.locs) < 2:
            _locs = [*self.locs, *self.view]
        else:
            _locs = self.locs
        locs = (np.asarray(_locs) - self.offset) / 10. ** self.orderOfMagnitude
        loc_range = np.ptp(locs)
        if loc_range == 0:
            loc_range = np.max(np.abs(locs))
        if loc_range == 0:
            loc_range = 1
        if len(self.locs) < 2:
            locs = locs[:-2]
        loc_range_oom = int(math.floor(math.log10(loc_range)))
        sigfigs = max(0, 3 - loc_range_oom)
        thresh = 1e-3 * 10 ** loc_range_oom
        while sigfigs >= 0:
            if np.abs(locs - np.round(locs, decimals=sigfigs)).max() < thresh:
                sigfigs -= 1
            else:
                break
        sigfigs += 1
        self.format = f"%1.{sigfigs}f"
