"""Port parity of ``report.ticks``, the colorbars' automatic ticks, against
matplotlib 3.10.8 on the CPU.

Over a seeded sweep of (vmin, vmax, axis length, label size) -- ranges
around zero, negative, tiny (1e-6), large (1e6), offset-heavy (1e6 + a
few), spans from 1e-7 to 1e7 and degenerate ones -- the port's tick values
equal ``MaxNLocator(nbins="auto", steps=[1, 2, 2.5, 5, 10])``'s within 1e-12
rel, and its labels and offset text equal ``ScalarFormatter``'s: once on
the locator and formatter alone, once through a drawn colorbar (the view
interval, the tick space and the visible ticks included).
"""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib as mpl  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import ticker  # noqa: E402

from imageprocess_tpu_torch.report import ticks as tk  # noqa: E402

KINDS = ["unit", "around_zero", "offset", "degenerate", "large_1e6", "tiny_1e-6",
         "negative", "any"]


def _sweep(kind, n=30):
    """Seeded (vmin, vmax, axis length in points, label size) cases."""
    rng = np.random.default_rng(KINDS.index(kind))
    out = []
    for _ in range(n):
        c = rng.uniform(-1, 1) * 10 ** rng.uniform(-8, 8)
        span = 10 ** rng.uniform(-7, 7)
        lo, hi = {
            "unit": (0.0, rng.uniform(0.1, 2)),
            "around_zero": (-span, span * rng.uniform(0.1, 3)),
            "offset": (c, c + abs(c) * 10 ** rng.uniform(-7, -1)),
            "degenerate": (c, c) if rng.uniform() < 0.8 else (0.0, 0.0),
            "large_1e6": (1e6, 1e6 + rng.uniform(1, 1e5)),
            "tiny_1e-6": (1e-6 * rng.uniform(0, 1), 1e-6 * rng.uniform(1, 5)),
            "negative": (-1e6 * rng.uniform(1, 3), -1e6 * rng.uniform(0, 1)),
            "any": (c, c + span),
        }[kind]
        out.append((lo, hi, float(rng.uniform(10, 400)), float(rng.choice([6, 8, 10, 12]))))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_locator_and_formatter_equal_matplotlib(kind):
    """``tick_values`` at a given nbins and ``ScalarFormatter`` on a given
    view, against matplotlib's classes on a dummy axis."""
    for lo, hi, length, label in _sweep(kind):
        view = tk.nonsingular(lo, hi, expander=0.05)
        nbins = tk.auto_nbins(length, label)
        want = ticker.MaxNLocator(nbins=nbins, steps=[1, 2, 2.5, 5, 10]).tick_values(*view)
        got = tk.tick_values(*view, nbins)
        assert got.shape == want.shape and np.allclose(got, want, rtol=1e-12, atol=0), \
            (lo, hi, nbins, got, want)
        f = ticker.ScalarFormatter()
        f.create_dummy_axis()
        f.axis.set_view_interval(*view)
        mine = tk.ScalarFormatter()
        assert mine.format_ticks(got, view) == f.format_ticks(want), (lo, hi)
        assert mine.get_offset() == f.get_offset(), (lo, hi)


@pytest.mark.parametrize("kind", KINDS)
def test_colorbar_ticks_equal_matplotlib(kind):
    """The visible ticks, their labels and the offset text of a drawn
    colorbar of ``Normalize(vmin, vmax)`` whose axis is *length* points long
    with *label*-point tick labels."""
    for lo, hi, length, label in _sweep(kind, 12):
        fig = plt.figure(figsize=(2, length / 72.0), dpi=72)
        cax = fig.add_axes([0.4, 0.0, 0.1, 1.0])
        cb = fig.colorbar(mpl.cm.ScalarMappable(norm=mpl.colors.Normalize(lo, hi),
                                                cmap="jet"), cax=cax)
        cb.ax.yaxis.set_tick_params(labelsize=label)
        fig.canvas.draw()
        drawn = cb.ax.yaxis._update_ticks()
        want = [t.get_loc() for t in drawn]
        want_labels = [t.label2.get_text() for t in drawn]
        want_offset = cb.ax.yaxis.offsetText.get_text()
        plt.close(fig)
        locs, vis, view = tk.colorbar_ticks(lo, hi, length, label)
        f = tk.ScalarFormatter()
        labels = dict(zip(locs.tolist(), f.format_ticks(locs, view)))
        assert len(vis) == len(want) and np.allclose(vis, want, rtol=1e-12, atol=0), \
            (lo, hi, vis, want)
        assert [labels[v] for v in vis.tolist()] == want_labels, (lo, hi)
        assert f.get_offset() == want_offset, (lo, hi)


def test_sweep_reaches_offsets_sci_notation_and_minus():
    """The sweep is not vacuous: it produces offset texts, scientific
    notation and unicode minus signs."""
    offsets, labels = set(), set()
    for kind in KINDS:
        for lo, hi, length, label in _sweep(kind, 12):
            locs, _, view = tk.colorbar_ticks(lo, hi, length, label)
            f = tk.ScalarFormatter()
            labels.update(f.format_ticks(locs, view))
            offsets.add(f.get_offset())
    assert any(o.startswith("+") for o in offsets)
    assert any("1e" in o for o in offsets)
    assert any(lab.startswith("\N{MINUS SIGN}") for lab in labels)
