"""The port's ROI annotator (``imageprocess_tpu_torch.apps.draw``) against
the JAX package's on the CPU, on the same TIFFs, and the cases of
``tests/test_annotator.py`` (and ``test_i18n.py::test_annotator_korean_logs``)
run on the port, headless: the matplotlib UI under Agg with ``plt.show``
patched and synthetic events.  Also ``geom.polygon.contains_point`` against
matplotlib's ``Path.contains_point``.

Bars: refined polygons (``add_rough_polygon``, ``propose_polygon``,
``replace_index``) equal JAX's vertex for vertex; ``roi_index_at`` equal on
a point grid that covers every ROI; ``rendered()`` with each filter alone
within 1e-5 absolute of JAX's, with all four on within 1e-5 on >= 99.9 % of
the pixels (a CLAHE bin flip after the band-pass is the known source of the
rest); the saved bundle's JSON, mask, overlay pixels and zip entries equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from imageprocess_tpu_torch.apps.draw import ROIAnnotator
from imageprocess_tpu_torch.core import i18n as ti18n
from imageprocess_tpu_torch.core import roiio, tiffio
from imageprocess_tpu_torch.geom.polygon import contains_point
from imageprocess_tpu_torch.segment.drawer import DEFAULT_VIEW_PARAMS
from test_torch_refine import _assert_bundles_equal, _bundle_files

QUIET = dict(log=lambda *_: None)
RENDER_BAR = 1e-5            # absolute, RGB in [0, 1]
ALL_FILTERS_SHARE = 0.999    # of the pixels within RENDER_BAR with all four filters on
ROUGH = [[(40, 30), (130, 35), (125, 100), (35, 95)],
         [(60, 40), (105, 40), (105, 85), (60, 85)],
         [(5, 5), (30, 5), (30, 30), (5, 30)],
         [(112.5, 8.5), (150.5, 10.5), (148.5, 40.5), (110.5, 38.5)]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU runs: with the suite's other
    workers busy, torch's full thread pool stalls them many times over their
    time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_task(folder, seed=0, shape=(120, 160)):
    """tests/test_annotator.py's frame (a Gaussian blob on noise) with a
    second, smaller blob, as u16 TIFFs of channels 1 and 2."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = rng.normal(100, 5, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    img += 900 * np.exp(-((yy - 60) ** 2 + (xx - 80) ** 2) / (2 * 15 ** 2))
    img += 600 * np.exp(-((yy - 24) ** 2 + (xx - 130) ** 2) / (2 * 7 ** 2))
    os.makedirs(folder, exist_ok=True)
    for ch in (1, 2):
        tiffio.write_tiff16(os.path.join(folder, f"S01_{ch}.TIF"),
                            np.clip(img * ch, 0, 65535).astype(np.uint16))
    return {ch: os.path.join(folder, f"S01_{ch}.TIF") for ch in (1, 2)}


@pytest.fixture(scope="module")
def chmap(tmp_path_factory):
    return _write_task(str(tmp_path_factory.mktemp("draw")))


def _pair(chmap, tmp_path, **kw):
    """(port annotator on the CPU, JAX annotator), each with its roi dir."""
    from imageprocess_tpu.apps.draw import ROIAnnotator as JAnnotator

    t = ROIAnnotator(chmap, "S01", str(tmp_path / "t" / "roi"), device="cpu",
                     **QUIET, **kw)
    j = JAnnotator(chmap, "S01", str(tmp_path / "j" / "roi"), **QUIET, **kw)
    return t, j


def _setup(tmp_path):
    return ROIAnnotator(_write_task(str(tmp_path)), "S01", str(tmp_path / "roi"),
                        device="cpu", **QUIET)


def _assert_polys_equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------------------ against JAX

def _assert_proposals_equal(t, j, rough, retry, mode):
    """Percentile mode: thresholds (order statistics) and polygons equal.
    BND mode (mean + k * std, float32 sums in each package's order, as
    ``tests/test_torch_refine.py`` holds it): thresholds within 1e-5
    relative, polygons equal unless a pixel lies between the two."""
    tt, tp = t.propose_polygon(rough, thr_param=retry)
    jt, jp = j.propose_polygon(rough, thr_param=retry)
    if mode == "percentile":
        assert tt == jt
    else:
        assert abs(tt - jt) <= 1e-5 * abs(jt)
        lo, hi = sorted((tt, jt))
        if ((t.image >= lo) & (t.image < hi)).any():
            return 0
    _assert_polys_equal(tp, jp)
    return 1


@pytest.mark.parametrize("mode,thr,retry", [("percentile", 90.0, 70.0),
                                            ("percentile", 60.0, 95.0),
                                            ("bnd", 0.25, 0.5)])
def test_add_and_propose_polygons_equal_jax(chmap, tmp_path, mode, thr, retry):
    t, j = _pair(chmap, tmp_path, mode=mode, thr_param=thr)
    checked = 0
    for rough in ROUGH:
        for r in (None, retry):
            checked += _assert_proposals_equal(t, j, rough, r, mode)
        if mode == "percentile":
            _assert_polys_equal(t.add_rough_polygon(rough), j.add_rough_polygon(rough))
    assert checked >= 2 * len(ROUGH) - 2
    if mode == "percentile":
        assert len(t.rois) == len(j.rois) == len(ROUGH)
        for a, b in zip(t.rois, j.rois):
            _assert_polys_equal(a, b)
    # a rough polygon whose tile finds nothing: the rough polygon itself
    flat = [(150.5, 100.5), (158.5, 100.5), (158.5, 118.5)]
    _assert_polys_equal(t.add_rough_polygon(flat), j.add_rough_polygon(flat))


def test_replace_index_equals_jax(chmap, tmp_path):
    t, j = _pair(chmap, tmp_path)
    for ann in (t, j):
        for rough in ROUGH[1:3]:
            ann.add_rough_polygon(rough)
    new = [(55, 35), (110, 35), (110, 90), (55, 90)]
    _assert_polys_equal(t.replace_index(0, new), j.replace_index(0, new))
    assert t.replace_index(5, new) is None and j.replace_index(5, new) is None
    for a, b in zip(t.rois, j.rois):
        _assert_polys_equal(a, b)


def test_roi_index_at_equals_jax_on_a_grid(chmap, tmp_path):
    """Every ROI (overlapping ones included) covered by a 1.5-px grid, the
    vertices and the edge midpoints, with the 50-px centroid fallback."""
    t, j = _pair(chmap, tmp_path)
    for ann in (t, j):
        for rough in ROUGH:
            ann.add_rough_polygon(rough)
    pts = [(x, y) for y in np.arange(-10.0, 131.0, 1.5) for x in np.arange(-10.0, 171.0, 1.5)]
    for P in t.rois:
        pts += [tuple(v) for v in P] + [tuple(v) for v in (P + np.roll(P, -1, 0)) / 2]
    got = [t.roi_index_at(x, y) for x, y in pts]
    assert got == [j.roi_index_at(x, y) for x, y in pts]
    assert set(got) == {None, 0, 1, 2, 3}


FILTERS = {
    "none": {},
    "bandpass": {"use_bandpass": True, "sigma_small": 1.0, "sigma_large": 4.0},
    "unsharp": {"use_unsharp": True, "unsharp_radius": 2.0, "unsharp_amount": 0.7},
    "clahe": {"use_clahe": True, "clahe_clip": 0.01},
    "edges": {"edge_overlay": True},
    "clahe_in_color": {"use_clahe": True, "color_mode": "cyan"},
    "view": {"p_low": 5.0, "p_high": 95.0, "gamma": 0.7, "invert": True,
             "use_unsharp": True, "edge_overlay": True},
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_rendered_each_filter_equals_jax(chmap, tmp_path, name):
    t, j = _pair(chmap, tmp_path)
    for ann in (t, j):
        ann.view.update(FILTERS[name])
    got, want = t.rendered(), j.rendered()
    assert got.shape == want.shape == (120, 160, 3) and got.dtype == want.dtype
    assert np.abs(got - want).max() <= RENDER_BAR


ALL_FOUR = {"use_bandpass": True, "sigma_small": 1.0, "sigma_large": 4.0,
            "use_unsharp": True, "use_clahe": True, "edge_overlay": True}


def _clahe_input(ann, view_mod, ops, to_dev, to_np):
    """The grayscale frame that ``rendered()`` hands CLAHE with ALL_FOUR on:
    band-pass, unsharp, the view stretch."""
    v = ann.view
    x = ops.dog_bandpass(to_dev(ann.image), 1.0, 4.0)
    x = ops.unsharp(x, 2.0, np.float32(0.7))
    return view_mod.apply_view_and_color(to_np(x), v)[..., 0]


@pytest.mark.parametrize("shape", [(120, 160), (220, 280)])
def test_rendered_all_four_filters_against_jax(tmp_path, shape):
    """All four filters on.  Every filter holds its bar, but the band-pass
    and unsharp chain (within 1e-5 of max|input| of JAX's) moves a few
    pixels of CLAHE's input across a bin edge, and each such flip moves its
    tile's clipped-histogram excess, so every pixel of the 2 x 2 tiles
    around it shifts by ~1e-4: the share of output pixels within 1e-5 is
    not a bar (it is printed).  Held instead: CLAHE's input bins equal on
    >= 99.9 % of the pixels, and the port's CLAHE and Sobel overlay fed
    JAX's CLAHE input give JAX's render within 1e-5 everywhere -- the bin
    flips are the whole difference."""
    import jax.numpy as jnp

    from imageprocess_tpu.ops import view as jview
    from imageprocess_tpu.segment import drawer as jdrawer
    from imageprocess_tpu_torch.ops import view as tview
    from imageprocess_tpu_torch.segment import drawer as tdrawer

    t, j = _pair(_write_task(str(tmp_path / "img"), shape=shape), tmp_path)
    for ann in (t, j):
        ann.view.update(ALL_FOUR)
    got, want = t.rendered(), j.rendered()
    assert got.shape == want.shape == shape + (3,)
    assert np.isfinite(got).all() and 0.0 <= got.min() and got.max() <= 1.0

    x_t = _clahe_input(t, tdrawer, tview, lambda a: torch.from_numpy(a.copy()),
                       lambda x: x.numpy())
    x_j = _clahe_input(j, jdrawer, jview, jnp.asarray, np.asarray)
    bins = (x_t * 255).astype(np.int32) == (x_j * 255).astype(np.int32)
    assert bins.mean() >= ALL_FILTERS_SHARE, int((~bins).sum())
    # the port's CLAHE and edge overlay on JAX's CLAHE input: JAX's render
    c = tview.clahe(torch.from_numpy(x_j.copy()), np.float32(0.01)).numpy()
    ed = tview.sobel_magnitude(torch.from_numpy(c)).numpy()
    rgb = np.dstack([c, np.clip(c + ed * 0.8, 0, 1), c])
    assert np.abs(rgb - want).max() <= RENDER_BAR
    within = (np.abs(got - want) <= RENDER_BAR).all(axis=-1)
    print(f"{shape}: {int((~bins).sum())} CLAHE bin flips, {within.mean():.6f} of the "
          f"render within {RENDER_BAR:g}, max abs {np.abs(got - want).max():.3e}")


def test_save_bundle_equals_jax(chmap, tmp_path):
    t, j = _pair(chmap, tmp_path)
    for ann in (t, j):
        for rough in ROUGH:
            ann.add_rough_polygon(rough)
        ann.handle_key("tab")
        ann.handle_key("i")
        ann.save()
    _assert_bundles_equal(_bundle_files(t.roi_dir), _bundle_files(j.roi_dir))
    # reopened, both resume the same ROIs on the saved channel
    t2, j2 = _pair(chmap, tmp_path)
    assert t2.channel == j2.channel == 2 and t2.view == j2.view
    for a, b in zip(t2.rois, j2.rois):
        _assert_polys_equal(a, b)


def test_entry_points_default_to_the_card(chmap, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ROIAnnotator(chmap, "S01", str(tmp_path / "roi"), **QUIET)


# ---------------------------------------------- contains_point vs matplotlib

def test_contains_point_equals_matplotlib():
    """Every vertex, every edge midpoint, points 1e-9 either side of each
    midpoint, random points and an integer grid, on random polygons
    (self-intersecting, lattice and float vertices, repeated vertices)."""
    from matplotlib.path import Path

    rng = np.random.default_rng(0)
    n = 0
    for trial in range(120):
        k = int(rng.integers(3, 12))
        P = (rng.integers(0, 20, (k, 2)).astype(float) if trial % 3 == 0
             else rng.random((k, 2)) * 100)
        if trial % 7 == 0:
            P = np.vstack([P, P[:1]])          # explicitly closed
        mids = (P + np.roll(P, -1, 0)) / 2
        pts = [tuple(v) for v in P] + [tuple(v) for v in mids]
        for e in (1e-9, -1e-9):
            pts += [(a + e, b) for a, b in mids] + [(a, b + e) for a, b in mids]
        pts += [tuple(v) for v in rng.random((40, 2)) * 110 - 5]
        if trial % 3 == 0:
            pts += [(float(a), float(b)) for a in range(21) for b in range(21)]
        path = Path(P)
        for x, y in pts:
            assert contains_point(P, x, y) == path.contains_point((x, y)), (P, x, y)
            n += 1
    assert n > 20000


@pytest.mark.parametrize("poly,pt", [
    ([[0, 0], [10, 0]], (5, 0)),                       # fewer than 3 vertices
    ([[0, 0], [10, 0], [0, 10]], (float("nan"), 1.0)),  # a non-finite point
    ([[0, 0], [10, 0], [0, 10]], (1.0, float("inf"))),
])
def test_contains_point_degenerate_cases_equal_matplotlib(poly, pt):
    from matplotlib.path import Path

    assert contains_point(np.array(poly, float), *pt) is False
    assert Path(np.array(poly, float)).contains_point(pt) is False


# ------------------------------------------- tests/test_annotator.py on the port

def test_annotator_flow(tmp_path):
    ann = _setup(tmp_path)
    assert ann.channel == 1
    assert ann.cycle_channel() == 2
    assert ann.cycle_channel() == 1
    rough = ROUGH[0]
    refined = ann.add_rough_polygon(rough)
    assert refined is not None and len(ann.rois) == 1
    rgb = ann.rendered()
    assert rgb.shape == (120, 160, 3) and rgb.max() <= 1.0
    ann.add_rough_polygon(rough)
    ann.delete_last()
    assert len(ann.rois) == 1
    ann.save()
    polys = roiio.load_roi_polygons(str(tmp_path / "roi" / "S01.json"))
    assert len(polys) == 1
    bundle = roiio.load_roi_bundle(str(tmp_path / "roi" / "S01.json"))
    assert bundle["view_params"]["last_channel"] == 1
    assert (tmp_path / "roi" / "mask" / "S01_mask.tif").exists()
    assert (tmp_path / "roi" / "zip" / "S01.zip").exists()


def test_annotator_degenerate_polygon(tmp_path):
    ann = _setup(tmp_path)
    assert ann.add_rough_polygon([(1, 1), (2, 2)]) is None
    assert ann.propose_polygon([(1, 1), (2, 2)]) == (None, None)
    assert ann.rois == []


def test_annotator_view_filters(tmp_path):
    ann = _setup(tmp_path)
    ann.view.update({"use_bandpass": True, "sigma_small": 1.0,
                     "sigma_large": 4.0, "use_unsharp": True,
                     "use_clahe": True, "edge_overlay": True})
    rgb = ann.rendered()
    assert rgb.shape == (120, 160, 3)
    assert np.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1.0


def test_annotator_per_index_edit(tmp_path):
    ann = _setup(tmp_path)
    ann.add_rough_polygon(ROUGH[1])
    ann.add_rough_polygon(ROUGH[2])
    assert len(ann.rois) == 2
    assert ann.roi_index_at(80, 60) == 0
    assert ann.roi_index_at(15, 15) == 1
    assert ann.roi_index_at(150, 110) is None
    before_1 = ann.rois[1].copy()
    out = ann.replace_index(0, [(55, 35), (110, 35), (110, 90), (55, 90)])
    assert out is not None and len(ann.rois) == 2
    np.testing.assert_array_equal(ann.rois[1], before_1)
    ann.delete_index(0)
    ann.delete_index(7)                 # out of range: nothing happens
    assert len(ann.rois) == 1
    np.testing.assert_array_equal(ann.rois[0], before_1)


def test_annotator_accept_retry_loop(tmp_path):
    ann = _setup(tmp_path)
    thr1, cand1 = ann.propose_polygon(ROUGH[1])
    assert cand1 is not None and ann.rois == []
    thr2, cand2 = ann.propose_polygon(ROUGH[1], thr_param=70.0)
    assert cand2 is not None and ann.rois == []
    assert thr2 != thr1
    idx = ann.accept(cand2)
    assert idx == 0 and len(ann.rois) == 1
    assert ann.accept(cand1, index=0) == 0
    np.testing.assert_array_equal(ann.rois[0], cand1)


def test_annotator_resumes_existing_bundle(tmp_path):
    ann = _setup(tmp_path)
    poly = np.array([[60, 40], [105, 42], [100, 85], [58, 80]], float)
    roiio.save_roi_bundle(
        str(tmp_path / "roi" / "S01.json"), "S01", ann.image.shape, [poly],
        view_params={"gamma": 0.7, "last_channel": 2})
    ann2 = ROIAnnotator(ann.channel_map, "S01", str(tmp_path / "roi"),
                        device="cpu", **QUIET)
    assert len(ann2.rois) == 1
    np.testing.assert_allclose(ann2.rois[0], poly)
    assert ann2.view["gamma"] == 0.7
    assert ann2.channel == 2
    ann2.save()
    back = roiio.load_roi_polygons(str(tmp_path / "roi" / "S01.json"))
    assert len(back) == 1
    np.testing.assert_allclose(back[0], poly)


def test_annotator_no_empty_bundle_litter(tmp_path):
    ann = _setup(tmp_path)
    ann.save()
    assert not os.path.exists(str(tmp_path / "roi" / "S01.json"))


class _Ev:
    def __init__(self, key, xdata=None, ydata=None):
        self.key, self.xdata, self.ydata = key, xdata, ydata


def _agg(monkeypatch):
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    return plt


def test_annotator_ui_selector_lifecycle(tmp_path, monkeypatch):
    """Repeated 'p' does not stack selectors, a finished polygon takes the
    selector's artists off the axes, and a redraw keeps one outline and one
    label per ROI."""
    plt = _agg(monkeypatch)
    ann = _setup(tmp_path)
    ann.show()
    assert ann._fig is not None and ann._ax is not None
    ann._on_key(_Ev("p"))
    sel = ann._selector
    assert sel is not None
    ann._on_key(_Ev("p"))
    assert ann._selector is sel
    sel.onselect(ROUGH[0])
    assert ann._selector is None and len(ann.rois) == 1
    stale = [ln for ln in ann._ax.lines
             if ln not in ann._roi_artists and ln.get_visible()]
    assert not stale, f"stale selector artists: {stale}"
    assert len(ann._roi_artists) == 2
    ann._on_key(_Ev("i"))
    assert len([a for a in ann._roi_artists if a in ann._ax.lines]) == 1
    plt.close(ann._fig)


def test_annotator_ui_cursor_keys(tmp_path, monkeypatch):
    """'r' at a ROI opens a selector that redraws that ROI in place, 'x'
    deletes the ROI under the cursor, a key without a cursor or binding
    changes nothing, 'q' closes the figure, and closing saves the bundle."""
    plt = _agg(monkeypatch)
    ann = _setup(tmp_path)
    ann.add_rough_polygon(ROUGH[1])
    ann.add_rough_polygon(ROUGH[2])
    ann.show()                                  # nothing saved yet: no ROI changed
    ann._on_key(_Ev("r", 80.0, 60.0))
    sel = ann._selector
    assert sel is not None
    ann._on_key(_Ev("r", 15.0, 15.0))          # a live selector is not stacked
    assert ann._selector is sel
    sel.onselect([(55, 35), (110, 35), (110, 90), (55, 90)])
    assert ann._selector is None and len(ann.rois) == 2
    ann._on_key(_Ev("x"))                       # no cursor: nothing
    ann._on_key(_Ev("w"))                       # no binding: nothing
    assert len(ann.rois) == 2
    ann._on_key(_Ev("x", 15.0, 15.0))
    assert len(ann.rois) == 1
    assert len(ann._roi_artists) == 2
    fig = ann._fig
    ann._on_key(_Ev("q"))
    assert not plt.fignum_exists(fig.number)
    assert "p: draw" in ann._title() and "ch1" in ann._title()


def test_draw_main_shows_every_task_and_saves(tmp_path, monkeypatch):
    """``main`` opens one annotator per (stage, time) task; a task whose
    window drew nothing leaves no bundle, one with a bundle rewrites it."""
    from imageprocess_tpu_torch.apps import draw

    _agg(monkeypatch)
    _write_task(str(tmp_path))
    _write_task(str(tmp_path / "t2"))
    for ch in (1, 2):
        os.replace(tmp_path / "t2" / f"S01_{ch}.TIF", tmp_path / f"S02_{ch}.TIF")
    roiio.save_roi_bundle(str(tmp_path / "roi" / "S02.json"), "S02", (120, 160),
                          [np.array([[60, 40], [105, 42], [100, 85]], float)])
    logs = []
    draw.main(str(tmp_path), log=logs.append, device="cpu")
    assert sorted(os.listdir(tmp_path / "roi")) == ["S02.json", "mask", "overlay", "zip"]
    assert sum("S0" in str(line) for line in logs) >= 2


def test_show_without_matplotlib_raises_naming_it(tmp_path, monkeypatch):
    ann = _setup(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        ann.show()
    assert ann._fig is None


def test_annotator_key_map(tmp_path):
    ann = _setup(tmp_path)
    v = ann.view
    assert ann.handle_key("a") and v["p_low"] == 0.0
    assert ann.handle_key("a") and v["p_low"] == 0.0
    assert ann.handle_key("d") and v["p_low"] == 1.0
    assert ann.handle_key("s") and v["p_high"] == 98.0
    assert ann.handle_key("f") and v["p_high"] == 99.0
    assert ann.handle_key("f") and v["p_high"] == 100.0
    assert ann.handle_key("f") and v["p_high"] == 100.0
    v["p_high"] = 1.5
    ann.handle_key("d")
    assert np.isclose(v["p_low"], 1.4)
    v.update(p_low=1.0, p_high=99.0, gamma=1.0)
    assert ann.handle_key("g") and np.isclose(v["gamma"], 0.9)
    assert ann.handle_key("G") and np.isclose(v["gamma"], 1.0)
    assert ann.handle_key("i") and v["invert"] is True
    v.update(p_low=5.0, p_high=80.0, gamma=2.0)
    assert ann.handle_key("v")
    assert (v["p_low"], v["p_high"], v["gamma"], v["invert"]) == (1.0, 99.0, 1.0, False)
    for key, mode in [("1", "cyan"), ("2", "blue"), ("3", "green"),
                      ("4", "red"), ("5", "yellow"), ("0", "grayscale")]:
        assert ann.handle_key(key) and v["color_mode"] == mode
    for key, name in [("e", "use_clahe"), ("b", "use_bandpass"),
                      ("n", "use_unsharp"), ("o", "edge_overlay")]:
        assert ann.handle_key(key) and v[name] is True
    rgb = ann.rendered()
    assert rgb.shape == (120, 160, 3) and np.isfinite(rgb).all()
    for key in "ebno":
        ann.handle_key(key)
    ann.add_rough_polygon(ROUGH[0])
    ann.add_rough_polygon(ROUGH[0])
    assert ann.handle_key("u") and len(ann.rois) == 1
    assert ann.handle_key("c") and len(ann.rois) == 0
    assert ann.handle_key("tab") and ann.channel == 2
    assert ann.handle_key("shift+tab") and ann.channel == 1
    assert not ann.handle_key("w") and not ann.handle_key("")


def test_annotator_korean_logs(tmp_path):
    """ROI-add events come from the catalog under lang=ko, as JAX's."""
    from imageprocess_tpu.apps.draw import ROIAnnotator as JAnnotator
    from imageprocess_tpu.core import i18n as ji18n

    rng = np.random.default_rng(7)
    img = rng.normal(100, 10, (96, 128)).clip(0, 65535)
    img[20:60, 20:80] += 4000.0
    tif = str(tmp_path / "S01_1.TIF")
    tiffio.write_tiff16(tif, img.astype(np.uint16))
    logs = {}
    prev = ti18n.LANG_CURRENT, ji18n.LANG_CURRENT
    ti18n.set_lang("ko")
    ji18n.set_lang("ko")
    try:
        for tag, cls, kw in (("t", ROIAnnotator, {"device": "cpu"}), ("j", JAnnotator, {})):
            logs[tag] = []
            ann = cls({1: tif}, "S01", str(tmp_path / tag), log=logs[tag].append, **kw)
            ann.add_rough_polygon([(15, 15), (90, 15), (90, 70), (15, 70)])
            ann.replace_index(0, [(12, 12), (92, 12), (92, 72), (12, 72)])
    finally:
        ti18n.set_lang(prev[0])
        ji18n.set_lang(prev[1])
    assert any(any("가" <= ch <= "힣" for ch in line) for line in logs["t"])
    assert logs["t"] == logs["j"]


# ------------------------------------------------------------------ on a card

@pytest.mark.cuda
def test_cuda_annotator_matches_cpu(tmp_path):
    """On a card: the refined polygons and every filter's render equal the
    CPU's within the bars above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chmap = _write_task(str(tmp_path / "img"))
    card = ROIAnnotator(chmap, "S01", str(tmp_path / "c"), device="cuda", **QUIET)
    cpu = ROIAnnotator(chmap, "S01", str(tmp_path / "h"), device="cpu", **QUIET)
    for rough in ROUGH:
        _assert_polys_equal(card.add_rough_polygon(rough), cpu.add_rough_polygon(rough))
    for name, view in FILTERS.items():
        card.view = {**DEFAULT_VIEW_PARAMS, **view}
        cpu.view = {**DEFAULT_VIEW_PARAMS, **view}
        assert np.abs(card.rendered() - cpu.rendered()).max() <= RENDER_BAR, name
