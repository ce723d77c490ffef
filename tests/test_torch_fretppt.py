"""Port parity: the FRET timelapse deck (``pipelines.fretppt``,
``report.pptxlite``) against the JAX package.  Both are host code, copied:
pairs, layouts and summaries equal, and the decks' entry names and bytes
equal (never whole files, whose zip entries carry timestamps)."""

import dataclasses
import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from imageprocess_tpu.pipelines import fretppt as jppt
from imageprocess_tpu.report import pptxlite as jlite
from imageprocess_tpu_torch.pipelines import fretppt as tppt
from imageprocess_tpu_torch.report import pptxlite as tlite

QUIET = dict(log=lambda *_: None)


@pytest.fixture(scope="module")
def thumbs(tmp_path_factory):
    """Two stages x two ROIs of 3-4 timepoints, FRET ("DoverF_rim",
    "ratio") over BF ("BF", "ch1"), plus names the deck must skip: the
    reference's dropped "FoverD_*" suffix, a FRET image without its BF, an
    unknown suffix, a name outside the pattern and a directory."""
    d = tmp_path_factory.mktemp("ppt")
    rng = np.random.default_rng(0)

    def put(name, shape=(40, 40, 3)):
        arr = (rng.random(shape) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / name)

    for s in ("S01", "S02", "S10"):
        for t in range(3):
            put(f"{s}_t{t:02d}_roi1_DoverF_rim.png")
            put(f"{s}_t{t:02d}_roi1_BF.png", (40, 60, 3))
    for t in range(4):
        put(f"S02_t{t:02d}_roi2_ratio.tif", (30, 30))
        put(f"S02_t{t:02d}_roi2_ch1.PNG")
    put("S01_t05_roi1_DoverF_rim.png")          # no BF at t05
    put("S03_t00_roi1_FoverD_rim.png")          # reference quirk: dropped
    put("S03_t00_roi1_BF.png")
    put("S01_t00_roi1_notes.png")               # unknown suffix
    put("summary.png")
    os.mkdir(d / "S04_t00_roi1_BF.png")
    return d


@pytest.mark.parametrize("suffix", ["DoverF_rim", "FoverD_rim", "ratio", "FRET",
                                    "BF", "phase", "DIC", "ch2", "notes", "Ch"])
def test_classify_channel_equals_jax(suffix):
    assert tppt.classify_channel(suffix) == jppt.classify_channel(suffix)


def test_collect_pairs_equals_jax(thumbs):
    got = tppt.collect_pairs(str(thumbs))
    assert got == jppt.collect_pairs(str(thumbs))
    assert [t for t, _, _ in got[("S01", "1")]] == [0, 1, 2]
    assert got[("S03", "1")] == [] and ("S02", "2") in got


@pytest.mark.parametrize("n", [0, 1, 3, 16, 20, 100, 400])
@pytest.mark.parametrize("width_cm", [0.5, 2.0, 5.0])
def test_layout_spec_equals_jax(n, width_cm):
    tgeo, jgeo = tppt.DeckGeometry(), jppt.DeckGeometry()
    assert dataclasses.asdict(tgeo) == dataclasses.asdict(jgeo)
    w = tlite.cm(width_cm)
    assert w == jlite.cm(width_cm) and tlite.inches(width_cm) == jlite.inches(width_cm)
    assert tppt.fit_row_width(n, w, tgeo) == jppt.fit_row_width(n, w, jgeo)
    times = tuple(range(n))
    if n:
        t, j = (tppt.slide_layout("S03", "2", times, w, tgeo),
                jppt.slide_layout("S03", "2", times, w, jgeo))
        assert (t is None) == (j is None)
        if t is not None:
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return [(i.filename, zf.read(i)) for i in zf.infolist()]


@pytest.mark.parametrize("width_cm", [2.0, 12.0])
def test_deck_equals_jax(thumbs, tmp_path, width_cm):
    """run_fret_ppt writes FRET_timelapse_auto.pptx into the image folder;
    the deck's parts and its summary equal JAX's.  At 12 cm the
    four-timepoint row is shrunk to fit."""
    out, logs = {}, {}
    for tag, mod in (("t", tppt), ("j", jppt)):
        lines = []
        ok, path = mod.run_fret_ppt(str(thumbs), img_width_cm=width_cm,
                                    log=lines.append)
        assert ok and path == str(thumbs / "FRET_timelapse_auto.pptx")
        out[tag] = (_entries(path), tlite.read_pptx_summary(path),
                    jlite.read_pptx_summary(path))
        logs[tag] = lines
        os.replace(path, tmp_path / f"{tag}.pptx")
    assert out["t"][0] == out["j"][0]
    assert out["t"][1] == out["t"][2] == out["j"][1]
    assert logs["t"] == logs["j"]
    summary = out["t"][1]
    assert [s["pictures"] for s in summary["slides"]] == [6, 6, 8, 6]
    assert len(summary["media"]) == 26
    assert "S10" in summary["slides"][-1]["texts"][0]


def test_deck_failures_equal_jax(tmp_path):
    assert tppt.run_fret_ppt(str(tmp_path), **QUIET) == \
        jppt.run_fret_ppt(str(tmp_path), **QUIET) == (False, "no valid FRET/BF pairs found")
    timeline = {("S01", "1"): [(t, "a.png", "b.png") for t in range(400)]}
    assert tppt.build_ppt(timeline, str(tmp_path)) == jppt.build_ppt(timeline, str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_pptx_summary_order_and_picture_checks_equal_jax(tmp_path):
    """Twelve slides read back in numeric order; a picture of an extension
    the deck declares no content type for is refused."""
    bad = tmp_path / "x.bmp"
    Image.new("RGB", (4, 4)).save(bad)
    parts = {}
    for tag, lite in (("t", tlite), ("j", jlite)):
        prs = lite.Presentation()
        for k in range(12):
            prs.add_slide().add_textbox(f"slide-{k}", lite.cm(1), lite.cm(1),
                                        lite.cm(5), lite.cm(1))
        with pytest.raises(ValueError, match="unsupported picture extension"):
            prs.slides[0].add_picture(str(bad), 0, 0)
        p = str(tmp_path / f"{tag}.pptx")
        prs.save(p)
        parts[tag] = (_entries(p), lite.read_pptx_summary(p))
    assert parts["t"] == parts["j"]
    assert [s["texts"] for s in parts["t"][1]["slides"]] == [[f"slide-{k}"]
                                                            for k in range(12)]
