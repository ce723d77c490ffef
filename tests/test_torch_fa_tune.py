"""The port's FA tuner (``imageprocess_tpu_torch.apps.fa_tune``) against the
JAX package's on the CPU, on the same u16 TIFF and ROI JSON, and the cases
of ``tests/test_fa_tuner.py`` run on the port, headless (the UI under Agg
with ``plt.show`` patched and synthetic events).

Bars, as ``tests/test_torch_fa.py`` holds ``analyze_image_with_overrides``:
rows, cells, categories and areas equal; thresholds and backgrounds within
1e-6 relative; means within 1e-5 relative.  The saved CSV: header and cells
equal JAX's (numbers within 1e-5 relative); the zero-FA file equal byte for
byte; ``select_cell_at`` equal on a point grid over every cell.
"""

import os
import sys

import numpy as np
import pytest
import torch

from imageprocess_tpu_torch.apps.fa_tune import FATuner
from imageprocess_tpu_torch.core import roiio, tiffio
from imageprocess_tpu_torch.pipelines.fa import FA_CSV_COLS, FaConfig, restore_cell_settings

try:  # the JAX tuner needs pandas, which a machine with a card may lack:
    from imageprocess_tpu.apps.fa_tune import FATuner as JTuner  # there only
    from imageprocess_tpu.pipelines.fa import FaConfig as JFaConfig  # the cuda test runs
except ImportError:
    JTuner = JFaConfig = None
from test_torch_fa import _assert_csv_match, _read_csv

QUIET = dict(log=lambda *_: None)
CFG = dict(channel=0, alpha=2.0, min_area_um=0.3, max_area_um=10.0)
POLYS = [np.array([[20, 20], [130, 25], [125, 120], [15, 115]], float),
         np.array([[150, 20], [270, 25], [265, 120], [145, 115]], float),
         np.array([[80.5, 110.5], [170.5, 112.5], [165.5, 205.5], [85.5, 200.5]])]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU runs: with the suite's other
    workers busy, torch's full thread pool stalls them many times over their
    time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(folder, polys=POLYS):
    """tests/test_fa_tuner.py's 220 x 280 frame (three bright blobs on
    noise) as a u16 TIFF with its ROI JSON."""
    rng = np.random.default_rng(0)
    H, W = 220, 280
    img = rng.normal(500, 30, (H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for cy, cx in [(60, 70), (70, 200), (160, 120)]:
        img += 4000 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 50.0)
    for cy, cx, s in [(45, 100, 8.0), (90, 230, 12.0), (150, 140, 6.0), (185, 110, 20.0)]:
        img += 2500 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / s)
    os.makedirs(os.path.join(folder, "roi"), exist_ok=True)
    tiffio.write_tiff16(os.path.join(folder, "S01_0.tif"),
                        img.clip(0, 65535).astype(np.uint16))
    roiio.save_roi_bundle(os.path.join(folder, "roi", "S01.json"), "S01", (H, W), polys)
    return os.path.join(folder, "S01_0.tif"), os.path.join(folder, "roi", "S01.json")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _dataset(str(tmp_path_factory.mktemp("tune")))


def _pair(data, out, cfg=CFG, **kw):
    t = FATuner(*data, "S01", str(out / "t"), FaConfig(**cfg), device="cpu", **QUIET, **kw)
    j = JTuner(*data, "S01", str(out / "j"), JFaConfig(**cfg), **QUIET, **kw)
    return t, j


def _assert_state_equal(t, j):
    assert [(r["cell"], r["category"], r["area"]) for r in t._rows] == \
        [(r["cell"], r["category"], r["area"]) for r in j._rows]
    assert sorted(t._thresholds) == sorted(j._thresholds)
    for i, thr in j._thresholds.items():
        assert abs(t._thresholds[i] - thr) <= 1e-6 * abs(thr)
    assert abs(t._bg - j._bg) <= 1e-6 * abs(j._bg)
    for a, b in zip(t._rows, j._rows):
        for k in ("mean_int_raw", "mean_int_corr", "int_den_raw", "int_den_corr"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1e-9), k
        for x, y in zip(a["centroid"], b["centroid"]):
            assert abs(x - y) <= 1e-5 * max(abs(y), 1.0)


# ------------------------------------------------------------------ against JAX

def test_reanalyze_and_set_params_equal_jax(data, tmp_path):
    t, j = _pair(data, tmp_path)
    _assert_state_equal(t, j)
    assert t.fa_count() >= 4
    for ann in (t, j):                      # one cell's override, then the globals
        ann.select_cell_at(60, 60)
        ann.set_params(alpha=3.5, close_radius=2, subtract_bg=False)
        ann.select_cell_at(5, 200)
        ann.set_params(alpha=1.5, min_area_um=0.5, max_area_um=3.0)
    _assert_state_equal(t, j)
    assert len({r["category"] for r in t._rows}) >= 2
    assert t.cell_settings == j.cell_settings
    assert t.params_for_selected() == j.params_for_selected()
    assert [t.fa_count(i) for i in range(3)] == [j.fa_count(i) for i in range(3)]


def test_select_cell_at_equals_jax_on_a_grid(data, tmp_path):
    t, j = _pair(data, tmp_path)
    pts = [(x, y) for y in np.arange(0.0, 220.0, 2.5) for x in np.arange(0.0, 280.0, 2.5)]
    for P in t.rois:
        pts += [tuple(v) for v in P] + [tuple(v) for v in (P + np.roll(P, -1, 0)) / 2]
    got = [t.select_cell_at(x, y) for x, y in pts]
    assert got == [j.select_cell_at(x, y) for x, y in pts]
    assert set(got) == {None, 0, 1, 2}


def test_saved_csv_equals_jax(data, tmp_path):
    t, j = _pair(data, tmp_path)
    for ann in (t, j):
        ann.select_cell_at(60, 60)
        ann.set_params(alpha=3.0, subtract_bg=False)
        ann.select_cell_at(200, 60)
        ann.set_params(close_radius=0)
    tp, jp = t.save(), j.save()
    assert os.path.basename(tp) == os.path.basename(jp) == "S01_results.csv"
    _assert_csv_match(tp, jp)
    rows = _read_csv(tp)
    assert len(rows) == 1 + t.fa_count()
    col = {c: i for i, c in enumerate(rows[0])}
    assert {r[col["Subtract_BG_Setting"]] for r in rows[1:]} == {"True", "False"}
    # the settings checkpoint reads back as JAX's does
    assert restore_cell_settings(str(tmp_path / "t"), "S01") == \
        restore_cell_settings(str(tmp_path / "j"), "S01") == \
        {0: {"alpha": 3.0, "min_area_um": 0.3, "max_area_um": 10.0, "close_radius": 1,
             "subtract_bg": False},
         1: {"alpha": 2.0, "min_area_um": 0.3, "max_area_um": 10.0, "close_radius": 0,
             "subtract_bg": True}} | ({} if t.fa_count(2) == 0 else {2: {
                 "alpha": 2.0, "min_area_um": 0.3, "max_area_um": 10.0, "close_radius": 1,
                 "subtract_bg": True}})


def test_zero_fa_csv_equals_jax_byte_for_byte(tmp_path):
    """A featureless frame at alpha 8: no FA, and the file is the header
    alone, JAX's bytes."""
    rng = np.random.default_rng(3)
    img = rng.normal(500, 5, (120, 140))
    tiffio.write_tiff16(str(tmp_path / "S01_0.tif"), img.clip(0, 65535).astype(np.uint16))
    polys = [np.array([[20, 20], [120, 25], [115, 100], [15, 95]], float)]
    roiio.save_roi_bundle(str(tmp_path / "roi" / "S01.json"), "S01", (120, 140), polys)
    data = (str(tmp_path / "S01_0.tif"), str(tmp_path / "roi" / "S01.json"))
    t, j = _pair(data, tmp_path, cfg=dict(CFG, alpha=8.0))
    assert t.fa_count() == j.fa_count() == 0
    with open(t.save(), "rb") as f, open(j.save(), "rb") as g:
        got, want = f.read(), g.read()
    assert got == want == (",".join(FA_CSV_COLS) + "\n").encode()


def test_mat_overlay_and_display_helpers_equal_jax(data, tmp_path):
    h5py = pytest.importorskip("h5py")
    mat_dir = tmp_path / "mat"
    mat_dir.mkdir()
    poly = np.array([[30.0, 30.0], [100.0, 35.0], [95.0, 100.0]])
    with h5py.File(str(mat_dir / "BNDb_S01.mat"), "w") as f:
        refs = f.create_group("#refs#")
        d = refs.create_dataset("c0", data=poly[:, [1, 0]].T)
        cell = refs.create_dataset("cell0", data=np.array([d.ref], dtype=h5py.ref_dtype)[:, None])
        f.create_dataset("bdokcc", data=np.array([cell.ref], dtype=h5py.ref_dtype)[:, None])
    t, j = _pair(data, tmp_path, mat_dir=str(mat_dir))
    assert len(t.mat_polys) == len(j.mat_polys) == 1
    np.testing.assert_array_equal(t.mat_polys[0], j.mat_polys[0])
    for boost in (0, 3, 15, -1, -15):
        t.visual_boost = j.visual_boost = boost
        assert t.display_range() == j.display_range()
    for sel in (None, 0, 2):
        t.selected = j.selected = sel
        assert t.zoom_bounds() == j.zoom_bounds()


def test_entry_points_default_to_the_card(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        FATuner(*data, "S01", str(tmp_path), FaConfig(**CFG), **QUIET)


# ------------------------------------------- tests/test_fa_tuner.py on the port

def _legacy(tmp_path):
    return _dataset(str(tmp_path), POLYS[:2])


def test_fa_tuner_flow(tmp_path):
    data = _legacy(tmp_path)
    out = tmp_path / "out"
    cfg = FaConfig(**CFG)
    t = FATuner(*data, "S01", str(out), cfg, device="cpu", **QUIET)
    assert t.fa_count() >= 2
    assert t.select_cell_at(60, 60) == 0
    before, other_before = t.fa_count(0), t.fa_count(1)
    t.set_params(alpha=8.0)
    assert t.fa_count(0) <= before
    assert t.fa_count(1) == other_before
    assert t.select_cell_at(5, 200) is None
    path = t.save()
    rows = _read_csv(path)
    col = {c: i for i, c in enumerate(rows[0])}
    alphas = {r[col["Cell_ID"]]: float(r[col["Used_Alpha"]]) for r in rows[1:]}
    if "1" in alphas:
        assert alphas["1"] == 8.0
    if "2" in alphas:
        assert alphas["2"] == 2.0
    restored = restore_cell_settings(str(out), "S01")
    assert restored.get(0, {}).get("alpha") == 8.0
    t2 = FATuner(*data, "S01", str(out), cfg, device="cpu", **QUIET)
    assert t2.cell_settings.get(0, {}).get("alpha") == 8.0


def test_fa_tuner_boost_zoom(tmp_path):
    data = _legacy(tmp_path)
    t = FATuner(*data, "S01", str(tmp_path / "out"), FaConfig(channel=0), device="cpu",
                **QUIET)
    full = float(t.img.max()) - float(t.img.min())
    vmin, vmax = t.display_range()
    assert vmin == float(t.img.min()) and np.isclose(vmax - vmin, full)
    t.visual_boost = 15
    assert np.isclose(t.display_range()[1] - vmin, full / 16.0)
    t.visual_boost = -15
    assert np.isclose(t.display_range()[1] - vmin, full * 16.0)
    assert t.zoom_bounds() is None
    t.selected = 0
    (x0, x1), (y0, y1) = t.zoom_bounds()
    roi = t.rois[0]
    pad_x = (roi[:, 0].max() - roi[:, 0].min()) * 0.2 + 20
    pad_y = (roi[:, 1].max() - roi[:, 1].min()) * 0.2 + 20
    assert np.isclose(x0, roi[:, 0].min() - pad_x) and np.isclose(x1, roi[:, 0].max() + pad_x)
    assert np.isclose(y0, roi[:, 1].max() + pad_y) and np.isclose(y1, roi[:, 1].min() - pad_y)


# ------------------------------------------------------------------ the UI

def _click(fig, ax, x, y):
    """A left click at data (x, y) of *ax* (or at the figure's corner when
    *ax* is None), dispatched as the canvas would."""
    from matplotlib.backend_bases import MouseEvent

    px, py = ax.transData.transform((x, y)) if ax is not None else (1.0, 1.0)
    fig.canvas.callbacks.process("button_press_event", MouseEvent(
        "button_press_event", fig.canvas, px, py, button=1))


def _key(fig, key):
    from matplotlib.backend_bases import KeyEvent

    fig.canvas.callbacks.process("key_press_event",
                                 KeyEvent("key_press_event", fig.canvas, key))


def test_fa_tuner_ui_sliders_clicks_and_keys(data, tmp_path, monkeypatch):
    """Under Agg: a click selects a cell and shows its parameters on the
    sliders without creating an override; a slider move sets the selected
    cell's override and reanalyzes; + = - z m change the view; s saves; q
    closes."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    t = FATuner(*data, "S01", str(tmp_path / "out"), FaConfig(**CFG), device="cpu", **QUIET)
    t.show()
    fig, ax, sliders = t._fig, t._ax, t._sliders
    assert sorted(sliders) == ["alpha", "close_radius", "max_area_um", "min_area_um"]
    _click(fig, ax, 60.0, 60.0)
    assert t.selected == 0 and t.cell_settings == {}
    assert sliders["alpha"].val == 2.0
    sliders["alpha"].set_val(4.0)
    assert t.cell_settings[0]["alpha"] == 4.0 and t.cfg.alpha == 2.0
    _click(fig, None, 0.0, 0.0)   # outside the axes
    assert t.selected == 0
    for key, boost in (("+", 1), ("=", 2), ("-", 1)):
        _key(fig, key)
        assert t.visual_boost == boost
    _key(fig, "z")
    assert t.auto_zoom and ax.get_xlim() == t.zoom_bounds()[0]
    _key(fig, "m")
    assert t.show_mat is False
    _key(fig, "s")
    assert os.path.exists(tmp_path / "out" / "individual_results" / "S01_results.csv")
    assert restore_cell_settings(str(tmp_path / "out"), "S01")[0]["alpha"] == 4.0
    _key(fig, "q")
    assert not plt.fignum_exists(fig.number)


def test_fa_tune_main_opens_each_pair(data, tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    from imageprocess_tpu_torch.apps import fa_tune

    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(plt.gcf()))
    logs = []
    fa_tune.main(os.path.dirname(data[0]), os.path.dirname(data[1]), str(tmp_path),
                 FaConfig(**CFG), log=logs.append, device="cpu")
    assert len(shown) == 1 and any("S01" in str(line) for line in logs)
    plt.close("all")


def test_show_without_matplotlib_raises_naming_it(data, tmp_path, monkeypatch):
    t = FATuner(*data, "S01", str(tmp_path), FaConfig(**CFG), device="cpu", **QUIET)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        t.show()


# ------------------------------------------------------------------ on a card

@pytest.mark.cuda
def test_cuda_tuner_matches_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = _dataset(str(tmp_path / "img"))
    card = FATuner(*data, "S01", str(tmp_path / "c"), FaConfig(**CFG), device="cuda", **QUIET)
    cpu = FATuner(*data, "S01", str(tmp_path / "h"), FaConfig(**CFG), device="cpu", **QUIET)
    _assert_state_equal(card, cpu)
    for ann in (card, cpu):
        ann.select_cell_at(60, 60)
        ann.set_params(alpha=3.5)
    _assert_state_equal(card, cpu)
    _assert_csv_match(card.save(), cpu.save())
