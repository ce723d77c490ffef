"""Port parity: the port's own host tier against the JAX package's modules.

The port keeps its own copies of the host modules it calls (the native
TIFF decoder binding, the filename grammar, the message catalog, polygon
padding, the XLSX writer, label map -> polygons, synthetic cell fields).
Each copy must give what the reference module gives on the same inputs:
parsed keys, catalogs, arrays and polygons equal, workbook members equal
byte for byte, decoded frames, histograms and tiles equal."""

import os
import threading
import zipfile

import numpy as np
import pytest
from PIL import Image

from imageprocess_tpu import native as jnative
from imageprocess_tpu.core import i18n as ji18n
from imageprocess_tpu.core import naming as jnaming
from imageprocess_tpu.geom import polygon as jpolygon
from imageprocess_tpu.morphology import contours as jcontours
from imageprocess_tpu.report import xlsxlite as jxlsx
from imageprocess_tpu_torch import native as tnative
from imageprocess_tpu_torch.core import i18n as ti18n
from imageprocess_tpu_torch.core import naming as tnaming
from imageprocess_tpu_torch.geom import polygon as tpolygon
from imageprocess_tpu_torch.models import synthcells as tsynth
from imageprocess_tpu_torch.morphology import contours as tcontours
from imageprocess_tpu_torch.report import xlsxlite as txlsx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------------ naming

NAMES = [
    "S01_2.TIF", "S01_t03_2.TIF", "S5_ch12.tif", "S5_c7.tif",
    "exp_S2-t10_3.tiff", "S01_t03.TIF", "noStage_4.TIF", "XS01_2.TIF",
    "S01_ch4.TIF", "S01_2_final.TIF", "es7_1.tif", "S01_CFP.TIF",
    "S01_donor.TIF", "S01_FRET.TIF", "S01_YFP.TIF", "S01_acceptor.TIF",
    "S01_whatever.TIF", "S1_2.TIF", "S1_t3_2.TIF", "plain_7.TIF",
    "S10_1.TIF", "S03_t02_2.TIF", "cells.TIF", "S02_t07_ch3.tif",
    "Donor_S04_t01-1.TIFF", "S12-t003-c2.tif", "s3_T4_2.tif", "S01_t03_03.TIF",
]
GRAMMARS = list(jnaming.ChannelGrammar)


@pytest.mark.parametrize("name", NAMES)
def test_naming_parse_and_save_names_match_jax(name):
    assert [g.value for g in tnaming.ChannelGrammar] == [g.value for g in GRAMMARS]
    for g in GRAMMARS:
        tg = tnaming.ChannelGrammar(g.value)
        for timelapse in (False, True):
            want = jnaming.parse_tokens(name, timelapse, g)
            got = tnaming.parse_tokens(name, timelapse, tg)
            assert (got.stage, got.time, got.channel) == \
                (want.stage, want.time, want.channel), (name, g, timelapse)
            for strip in (True, False):
                assert tnaming.clean_base_for_save(name, timelapse, tg, strip) == \
                    jnaming.clean_base_for_save(name, timelapse, g, strip)
    assert tnaming.natural_key(name) == jnaming.natural_key(name)


def test_naming_formatting_and_sort_match_jax():
    for n in (0, 1, 7, 10, 99, 123):
        assert tnaming.fmt_stage(n) == jnaming.fmt_stage(n)
        assert tnaming.fmt_time(n) == jnaming.fmt_time(n)
    assert sorted(NAMES, key=tnaming.natural_key) == sorted(NAMES, key=jnaming.natural_key)


def test_naming_discovery_matches_jax(tmp_path):
    for n in NAMES + ["S2_1.tif", "S1_1.tiff", "notes.txt"]:
        (tmp_path / n).write_bytes(b"")
    got, want = tnaming.list_tifs(str(tmp_path)), jnaming.list_tifs(str(tmp_path))
    assert got == want and len(got) == len(NAMES) + 2
    for g in GRAMMARS:
        tg = tnaming.ChannelGrammar(g.value)
        for timelapse in (False, True):
            assert tnaming.build_keymap(got, timelapse, tg) == \
                jnaming.build_keymap(want, timelapse, g)


@pytest.mark.parametrize("timelapse", [False, True])
def test_naming_pairs_by_channel_match_jax(tmp_path, timelapse):
    names = ["S01_1.TIF", "S01_2.TIF", "S02_1.TIF", "S03_2.TIF", "S10_t02_1.TIF",
             "S10_t02_2.TIF", "S10_t01_1.TIF", "S10_t01-c2.TIF", "S2_ch1.tif",
             "S2_ch2.tif", "plain.TIF"]
    files = [str(tmp_path / n) for n in names]
    for g in GRAMMARS:
        tg = tnaming.ChannelGrammar(g.value)
        for d, a in ((1, 2), (2, 1), (1, 3)):
            got = tnaming.build_pairs_by_channel(files, timelapse, d, a, tg)
            want = jnaming.build_pairs_by_channel(files, timelapse, d, a, g)
            assert got == want
    assert len(tnaming.build_pairs_by_channel(files, timelapse, 1, 2)[0]) >= 2


@pytest.mark.parametrize("name", NAMES + ["S01-c2.TIF", "a/b/S01_ch3.tif", "plain.TIF",
                                          "S01_t02_C12.tiff", "cells"])
def test_naming_swap_channel_matches_jax(name):
    for ch in (1, 4, 12):
        assert tnaming.swap_channel_in_name(name, ch) == \
            jnaming.swap_channel_in_name(name, ch)
    assert tnaming.swap_channel_in_name("x/S01-c2.TIF", 4) == os.path.join("x", "S01-4.TIF")
    assert tnaming.swap_channel_in_name("plain.TIF", 3) == "plain_3.TIF"


@pytest.mark.parametrize("present", ["none", "standard", "legacy", "png"])
def test_naming_find_roi_basepath_matches_jax(tmp_path, present):
    roi = tmp_path / "roi"
    roi.mkdir()
    files = {"standard": ["S01.json", "S01_t03.json"], "legacy": ["S1.json", "S1_t3.json"],
             "png": ["S1_t3.png"], "none": []}[present]
    for f in files:
        (roi / f).write_text("{}")
    for name in ("S01_2.TIF", "S1_t3_2.TIF", "plain_7.TIF"):
        for timelapse in (False, True):
            assert tnaming.find_roi_basepath(str(roi), name, timelapse) == \
                jnaming.find_roi_basepath(str(roi), name, timelapse)

# ------------------------------------------------------------------ i18n


def test_i18n_catalogs_equal():
    assert ti18n.STRINGS == ji18n.STRINGS
    assert ti18n.DEFAULT_LANG == ji18n.DEFAULT_LANG


@pytest.mark.parametrize("lang", ["ko", "en", "EN", "fr", None])
def test_i18n_lookup_matches_jax(lang):
    keys = sorted(ji18n.STRINGS["en"]) + ["no_such_key"]
    for k in keys:
        assert ti18n.t(k, lang=lang) == ji18n.t(k, lang=lang)
        assert ti18n.t(k, "fallback", lang) == ji18n.t(k, "fallback", lang)

# ------------------------------------------------------------------ polygon


@pytest.mark.parametrize("max_vertices", [None, 3, 8, 40])
def test_pad_polygons_matches_jax(max_vertices):
    rng = np.random.default_rng(3)
    polys = [rng.uniform(0, 100, (k, 2)) for k in (3, 5, 12, 7)]
    polys.append(np.array([[1, 2], [3, 4], [5, 1]], np.int64))
    got = tpolygon.pad_polygons(polys, max_vertices)
    want = jpolygon.pad_polygons(polys, max_vertices)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _vertex_polys():
    rng = np.random.default_rng(8)
    th = np.linspace(0, 2 * np.pi, 17, endpoint=False)
    return {
        "unit_square": np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float),
        "ccw_triangle": np.array([[0, 0], [4, 0], [0, 3]], float),
        "cw_triangle": np.array([[0, 3], [4, 0], [0, 0]], float),
        "concave": np.array([[0, 0], [6, 0], [6, 6], [3, 2], [0, 6]], float),
        "collinear": np.array([[0, 0], [2, 0], [4, 0], [4, 4], [2, 4], [0, 4]], float),
        "degenerate": np.array([[5.0, 5.0]] * 3),
        "segment": np.array([[1.0, 1.0], [4.0, 5.0]]),
        "star": np.stack([(3 + 2 * (np.arange(17) % 2)) * np.cos(th) + 10,
                          (3 + 2 * (np.arange(17) % 2)) * np.sin(th) + 7], 1),
        "random": rng.uniform(-20, 80, (23, 2)),
        "float32": rng.uniform(0, 50, (9, 2)).astype(np.float32),
        "ints": np.array([[1, 2], [9, 2], [9, 7], [1, 7]], np.int64),
    }


@pytest.mark.parametrize("name", sorted(_vertex_polys()))
def test_polygon_vertex_math_matches_jax(name):
    """perimeter, shoelace area, centroid, convex hull and bbox: the port's
    copies equal the JAX package's on closed forms, degenerate rings and
    random vertices."""
    poly = _vertex_polys()[name]
    assert tpolygon.polygon_perimeter(poly) == jpolygon.polygon_perimeter(poly)
    assert tpolygon.shoelace_area(poly) == jpolygon.shoelace_area(poly)
    assert tpolygon.polygon_centroid(poly) == jpolygon.polygon_centroid(poly)
    assert tpolygon.polygon_bbox(poly) == jpolygon.polygon_bbox(poly)
    got, want = tpolygon.convex_hull(poly), jpolygon.convex_hull(poly)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if name == "unit_square":
        assert tpolygon.polygon_perimeter(poly) == 4.0
        assert tpolygon.shoelace_area(poly) == 1.0
        assert tpolygon.polygon_centroid(poly) == (0.5, 0.5)
        assert tpolygon.polygon_bbox(poly) == (0, 0, 2, 2)
    if name == "collinear":
        assert len(got) == 4
    if name == "degenerate":
        assert tpolygon.polygon_centroid(poly) == (5.0, 5.0) and len(got) == 1

# ------------------------------------------------------------------ xlsxlite


def _rows():
    return [["stage", "roi", "mean", "n", "flag", "note"],
            ["S01", 1, 12.5, 3, True, " padded "],
            ["S01", 2, float("nan"), np.int64(4), False, "a<b&\"c\"\x08"],
            ["S02", 1, float("inf"), 0, None, "한국어"],
            ["S02", 2, -float("inf"), np.float64(2.25), np.bool_(True), ""]]


@pytest.mark.parametrize("sheets", [1, 3])
def test_xlsx_members_equal_jax(tmp_path, sheets):
    book = {f"per_ROI{i}" if i else "per_ROI": _rows() for i in range(sheets)}
    book["bad/name?"] = [["x"], [1.0]]
    a, b = str(tmp_path / "port.xlsx"), str(tmp_path / "jax.xlsx")
    txlsx.write_xlsx(a, book)
    jxlsx.write_xlsx(b, book)
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for n in za.namelist():
            assert za.read(n) == zb.read(n), n
    assert txlsx.read_xlsx(a) == jxlsx.read_xlsx(b) == jxlsx.read_xlsx(a)


def test_xlsx_reader_matches_jax_on_jax_output(tmp_path):
    p = str(tmp_path / "j.xlsx")
    jxlsx.write_xlsx(p, {"s": _rows()})
    assert txlsx.read_xlsx(p) == jxlsx.read_xlsx(p)

# ------------------------------------------------------------------ contours


def _label_maps():
    rng = np.random.default_rng(4)
    lab = np.zeros((60, 80), np.int32)
    lab[5:20, 5:25] = 1
    lab[30:55, 10:30] = 2
    lab[33:40, 15:20] = 0          # a hole
    lab[8:12, 50:78] = 3
    lab[40:42, 60:62] = 4          # below min_area
    lab[45:58, 40:52] = 5
    lab[50:58, 70:79] = 5          # one label, two blobs
    blobs = np.zeros((64, 64), np.int32)
    yy, xx = np.mgrid[0:64, 0:64]
    for i, (cy, cx, r) in enumerate(rng.uniform([8, 8, 3], [56, 56, 9], (6, 3)), 1):
        blobs[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = i
    return {"shapes": lab, "discs": blobs, "empty": np.zeros((16, 16), np.int32),
            "edge": np.pad(np.ones((10, 10), np.int32), ((0, 5), (0, 5)))}


@pytest.mark.parametrize("case", ["shapes", "discs", "empty", "edge"])
def test_masks_to_polygons_matches_jax(case):
    pytest.importorskip("cv2")
    lab = _label_maps()[case]
    for min_area in (0.0, 20.0):
        got = tcontours.masks_to_polygons(lab, min_area)
        want = jcontours.masks_to_polygons(lab, min_area)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

# ------------------------------------------------------------------ synthcells


def _jsynth():
    """The JAX package's synthcells (its models/__init__ imports flax, which
    the card's machine lacks, so only tests that need it import it)."""
    from imageprocess_tpu.models import synthcells

    return synthcells


@pytest.mark.parametrize("domain", list(tsynth.DOMAINS))
def test_synth_frame_bit_equal_jax(domain):
    jsynth = _jsynth()
    assert tsynth.DOMAINS == jsynth.DOMAINS
    for seed in (0, 5):
        a_img, a_lab = tsynth.synth_frame(np.random.default_rng(seed), 72, 96, domain)
        b_img, b_lab = jsynth.synth_frame(np.random.default_rng(seed), 72, 96, domain)
        assert a_img.dtype == b_img.dtype and a_lab.dtype == b_lab.dtype
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_lab, b_lab)


def test_eval_frame_bit_equal_jax():
    pytest.importorskip("cv2")
    jsynth = _jsynth()
    a = tsynth.eval_frame(3, "fluor", 96, 128)
    b = jsynth.eval_frame(3, "fluor", 96, 128)
    np.testing.assert_array_equal(a["img"], b["img"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert len(a["polys"]) == len(b["polys"]) > 0
    for p, q in zip(a["polys"], b["polys"]):
        np.testing.assert_array_equal(p, q)
    with pytest.raises(ValueError, match="unknown domain"):
        tsynth.synth_frame(np.random.default_rng(0), 8, 8, "nope")

# ------------------------------------------------------------------ native


def _deflate_strips(path, img, rows_per_strip):
    import chip_smoke

    chip_smoke.write_tiff16_deflate(path, img, rows_per_strip)


@pytest.fixture(scope="module")
def tiffs(tmp_path_factory):
    """Frames written by PIL (LZW, Deflate, PackBits, none; u16 and u8)
    and by a multi-strip Deflate writer, with their arrays."""
    d = tmp_path_factory.mktemp("tiffs")
    rng = np.random.default_rng(12)
    out = {}
    for name, dtype, comp in (("lzw16", np.uint16, "tiff_lzw"),
                              ("deflate16", np.uint16, "tiff_adobe_deflate"),
                              ("packbits16", np.uint16, "packbits"),
                              ("raw16", np.uint16, None),
                              ("lzw8", np.uint8, "tiff_lzw")):
        hi = 65536 if dtype == np.uint16 else 256
        arr = rng.integers(0, hi, (97, 131)).astype(dtype)
        p = str(d / f"{name}.tif")
        Image.fromarray(arr).save(p, format="TIFF", compression=comp)
        out[name] = (p, arr)
    for ch in (2, 3):
        arr = rng.integers(0, 4096, (97, 131)).astype(np.uint16)
        p = str(d / f"strips_{ch}.tif")
        _deflate_strips(p, arr, 16)
        out[f"strips{ch}"] = (p, arr)
    return out


@pytest.mark.parametrize("name", ["lzw16", "deflate16", "packbits16", "raw16",
                                  "lzw8", "strips2"])
def test_decode_tiff_equals_jax_binding(tiffs, name):
    path, arr = tiffs[name]
    got, want = tnative.decode_tiff(path), jnative.decode_tiff(path)
    assert got is not None and want is not None
    assert got.dtype == want.dtype == arr.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)
    assert tnative.tiff_info(path) == jnative.tiff_info(path)


def test_decode_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.tif"
    bad.write_bytes(b"II*\x00garbage")
    assert tnative.tiff_info(str(bad)) is None and jnative.tiff_info(str(bad)) is None
    assert tnative.decode_tiff(str(bad)) is None and jnative.decode_tiff(str(bad)) is None


@pytest.mark.parametrize("stride", [0, 1, 4])
def test_decode_batch_hist_equals_jax(tiffs, stride):
    paths = [tiffs["strips2"][0], tiffs["strips3"][0]]
    pool = tnative.FrameBufferPool()
    got = tnative.decode_tiff_batch_hist(paths, stride, pool=pool)
    want = jnative.decode_tiff_batch_hist(paths, stride)
    np.testing.assert_array_equal(got[0], want[0])
    if stride:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None
    mixed = [tiffs["strips2"][0], tiffs["lzw8"][0]]
    assert tnative.decode_tiff_batch_hist(mixed, 1) is None
    assert jnative.decode_tiff_batch_hist(mixed, 1) is None


@pytest.mark.parametrize("pad", [0, 3])
def test_decode_batch_hist_tiles_equals_jax(tiffs, pad):
    paths = [tiffs["strips2"][0], tiffs["strips3"][0]]
    offs = np.array([[0, 0], [10, 37], [65, 99], [5, 2]], np.int32)
    got = tnative.decode_tiff_batch_hist_tiles(paths, 4, offs, 32, pad_tiles=pad,
                                               pool=tnative.FrameBufferPool())
    want = jnative.decode_tiff_batch_hist_tiles(paths, 4, offs, 32, pad_tiles=pad)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (4 + pad, 2, 32, 32)
    assert tnative.decode_tiff_batch_hist_tiles([tiffs["lzw8"][0]], 1, offs, 8) is None


@pytest.mark.parametrize("p1000", [0, 1000, 5000, 50000, 95000, 99000, 100000])
def test_hist_functions_equal_jax(p1000):
    rng = np.random.default_rng(p1000)
    arr = (rng.gamma(2.0, 300.0, (111, 123))).clip(0, 65535).astype(np.uint16)
    for stride in (1, 3, 4):
        h = tnative.u16_hist(arr, stride)
        np.testing.assert_array_equal(h, jnative.u16_hist(arr, stride))
        assert tnative.u16_percentile_strided(arr, stride, p1000) == \
            jnative.u16_percentile_strided(arr, stride, p1000)
        assert tnative.hist_order_stats(h, p1000) == jnative.hist_order_stats(h, p1000)
        got = tnative.percentile_from_hist(h, p1000)
        assert got == jnative.percentile_from_hist(h, p1000)
        assert got == pytest.approx(np.percentile(
            arr.ravel()[::stride].astype(np.float64), p1000 / 1000), rel=1e-12)
        assert tnative.hist_mode_from_hist(h, max(p1000, 1)) == \
            jnative.hist_mode_from_hist(h, max(p1000, 1))
    vals = rng.normal(100, 20, 5000).astype(np.float32)
    vals[::97] = np.nan
    assert tnative.hist_mode_from_values(vals, max(p1000, 1)) == \
        jnative.hist_mode_from_values(vals, max(p1000, 1))
    empty = np.zeros(65536, np.uint32)
    assert tnative.hist_order_stats(empty, p1000) == jnative.hist_order_stats(empty, p1000)
    assert tnative.hist_mode_from_hist(empty, p1000) == 0.0


def test_frame_buffer_pool_recycles():
    pool = tnative.FrameBufferPool(max_items=1)
    a = pool.get((4, 5), np.uint16)
    pool.put(a)
    pool.put(np.empty((4, 5), np.uint16))      # over max_items: dropped
    pool.put(a[1:])                            # a view: not recyclable
    assert pool.get((4, 5), np.uint16) is a
    assert pool.get((4, 5), np.uint16) is not a


def test_native_builds_into_the_port_and_raises_on_failure(tmp_path, monkeypatch):
    """The library lands in the port's build folder under a hashed name;
    concurrent builds of one library leave one complete file; a build
    that fails raises instead of falling back."""
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "imageprocess_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libiptiff_")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    out = str(tmp_path / "libiptiff_test.so")
    errs = []

    def build():
        try:
            tnative._build(out)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and os.listdir(tmp_path) == ["libiptiff_test.so"]
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative._build(str(tmp_path / "libbad.so"))
    assert not os.path.exists(tmp_path / "libbad.so")


# ------------------------------------------------------------------ image outputs

def _frame32(seed=0, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    img = rng.normal(300.0, 120.0, shape).astype(np.float32)
    img[3, 4:9] = np.nan
    img[10, 10] = np.inf
    return img


@pytest.mark.parametrize("writer,cast", [("write_tiff32", np.float32),
                                         ("write_tiff16", np.uint16),
                                         ("write_tiff8", np.uint8)])
def test_tiff_writers_equal_jax(tmp_path, writer, cast):
    """The same file bytes as the JAX package's writers (PIL infers the
    mode from the array's dtype), read back to the same pixels, and no
    ``.tmp`` file left behind."""
    from imageprocess_tpu.core import tiffio as jtiff
    from imageprocess_tpu_torch.core import tiffio as ttiff

    img = _frame32()                    # float32 keeps its NaN and inf
    if cast != np.float32:
        img = np.abs(np.nan_to_num(img, nan=7.0, posinf=9.0)) % (
            255 if cast == np.uint8 else 60000)
    jp, tp = tmp_path / "j" / "a.tif", tmp_path / "t" / "sub" / "a.tif"
    getattr(jtiff, writer)(str(jp), img)
    getattr(ttiff, writer)(str(tp), img)
    assert tp.read_bytes() == jp.read_bytes()
    assert sorted(os.listdir(tp.parent)) == ["a.tif"]
    back = ttiff.read_2d(str(tp), dtype=None)
    assert back.dtype == cast
    assert np.array_equal(back, img.astype(cast), equal_nan=True)


@pytest.mark.parametrize("lo,hi", [(100.0, 500.0), (0.0, 0.0), (-5.0, 1e9)])
def test_normalize_to_u16_and_auto_minmax_equal_jax(lo, hi):
    from imageprocess_tpu.core import tiffio as jtiff
    from imageprocess_tpu.report import render as jrender
    from imageprocess_tpu_torch.core import tiffio as ttiff
    from imageprocess_tpu_torch.report import render as trender

    img = np.nan_to_num(_frame32(1), posinf=1e6)
    got = ttiff.normalize_to_u16(img, lo, hi)
    assert got.dtype == np.uint16
    assert np.array_equal(got, jtiff.normalize_to_u16(img, lo, hi))
    assert got[3, 4] == 0                                  # NaN -> 0
    for vals in (_frame32(2), np.full(5, 3.0, np.float32), np.array([np.nan])):
        for p in ((1.0, 99.0), (0.0, 100.0), (5.0, 50.0)):
            assert trender._auto_minmax_np(vals, *p) == jrender._auto_minmax_np(vals, *p)


@pytest.mark.parametrize("shape", [(3, 40, 50), (40, 50, 4), (1, 3, 40, 50),
                                   (40, 50)])
def test_squeeze_smallest_axis_and_read_2d_equal_jax(tmp_path, shape):
    from imageprocess_tpu.core import tiffio as jtiff
    from imageprocess_tpu_torch.core import tiffio as ttiff

    a = np.arange(np.prod(shape), dtype=np.uint16).reshape(shape)
    got = ttiff.squeeze_smallest_axis(a)
    assert got.shape == (40, 50)
    assert np.array_equal(got, jtiff.squeeze_smallest_axis(a))
    if a.ndim == 3 and shape[-1] == 4:
        path = str(tmp_path / "rgba.tif")
        Image.fromarray(a.astype(np.uint8)).save(path)
        for squeeze in ("first_channel", "smallest_axis"):
            for dtype in (None, np.float32):
                want = jtiff.read_2d(path, dtype=dtype, squeeze=squeeze)
                got = ttiff.read_2d(path, dtype=dtype, squeeze=squeeze)
                assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("rule", ["mpl", "pnpoly"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_polygon_np_equals_jax(rule, seed):
    """The host rasterizer: equal to the JAX package's on free float
    vertices (both float64 numpy), and to the port's device rasterizer on
    the half-integer lattice."""
    import torch

    from imageprocess_tpu.geom import rasterize as jrast
    from imageprocess_tpu_torch.geom import rasterize as trast

    rng = np.random.default_rng(seed)
    shape = (45, 61)
    pts = rng.uniform(-4, 64, (9, 2))
    c = pts.mean(axis=0)
    pts = pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]
    got = trast.rasterize_polygon_np(pts, shape, trast.EdgeRule(rule))
    assert got.dtype == bool and got.any()
    assert np.array_equal(got, jrast.rasterize_polygon_np(pts, shape,
                                                          jrast.EdgeRule(rule)))
    lattice = np.round(pts * 2) / 2
    dev = trast.rasterize_polygons(torch.from_numpy(lattice[None].astype(np.float32)),
                                   shape, trast.EdgeRule(rule))[0].numpy()
    assert np.array_equal(trast.rasterize_polygon_np(lattice, shape,
                                                     trast.EdgeRule(rule)), dev)


def test_load_roi_bundle_equals_jax(tmp_path):
    from imageprocess_tpu.core import roiio as jroi
    from imageprocess_tpu_torch.core import roiio as troi

    path = str(tmp_path / "S01.json")
    troi.save_roi_bundle(path, "S01", (40, 50), [np.array([[1, 2], [30, 4], [9, 33.5]])],
                         view_params={"gamma": 1.5}, generated_by="test")
    got = troi.load_roi_bundle(path)
    assert got == jroi.load_roi_bundle(path)
    assert got["rois"] == [[[1.0, 2.0], [30.0, 4.0], [9.0, 33.5]]]
    assert got["view_params"] == {"gamma": 1.5}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_polygon_union_equals_full_frame_masks(seed):
    """render.polygon_union rasterizes each polygon on its own rows: the
    same union as OR-ing the JAX package's full-frame host masks, for free
    float vertices, polygons that leave the frame and one wholly outside."""
    from imageprocess_tpu.geom import rasterize as jrast
    from imageprocess_tpu_torch.report import render as trender

    rng = np.random.default_rng(seed)
    shape = (90, 70)
    polys = []
    for _ in range(5):
        c = rng.uniform(-10, 100, 2)
        pts = c + rng.uniform(-30, 30, (7, 2))
        m = pts.mean(axis=0)
        polys.append(pts[np.argsort(np.arctan2(pts[:, 1] - m[1], pts[:, 0] - m[0]))])
    polys.append(np.array([[5.0, 200.0], [40.0, 205.0], [20.0, 260.0]]))   # below
    polys.append(np.array([[5.0, -60.0], [40.0, -55.0], [20.0, -20.5]]))   # above
    want = np.zeros(shape, bool)
    for P in polys:
        want |= jrast.rasterize_polygon_np(P, shape)
    got = trender.polygon_union(polys, shape)
    assert got.dtype == bool and got.any() and np.array_equal(got, want)
