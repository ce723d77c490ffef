"""Port parity end to end: the batched intensity runner on the CPU
(``device="cpu"``, the plain PyTorch step) against the JAX package's
``run_intensity_batched`` on the same folders.

Keys, area_px, npx and chN_bg must be exactly equal, the statistics within
rtol 1e-5 (sums are taken in another order); the CSVs parse to the same
table under the same bars, and the XLSX files hold the same sheets and
headers."""

import csv
import math
import os

import numpy as np
import pytest
import torch

from imageprocess_tpu.core import roiio, tiffio
from imageprocess_tpu.pipelines import intensity as jint
from imageprocess_tpu_torch import native as port_native
from imageprocess_tpu_torch.report import xlsxlite
from imageprocess_tpu_torch.ops import roistats as port_roistats
from imageprocess_tpu_torch.ops import tile_stats_kernel as tsk
from imageprocess_tpu_torch.parallel import runner as port_runner
from imageprocess_tpu_torch.pipelines import intensity as tint
from test_torch_tiffout import assert_pngs_match, png_files

RTOL = 1e-5
P1 = np.array([[15, 15], [60, 18], [55, 70], [12, 66]], float)
P2 = np.array([[70, 40], [115, 45], [110, 85], [65, 80]], float)


def _exact_col(c):
    return c in ("roi", "area_px", "bg_stride", "stage_idx", "time_idx") or \
        c.endswith(("_npx", "_bg"))


def _run_both(folder, tmp_path, batch_size=3, log=None, **cfg_kw):
    jrows = jint.run_intensity_batched(
        str(folder), jint.IntensityConfig(**cfg_kw), out_root=str(tmp_path / "j"),
        log=lambda *_: None, batch_size=batch_size)
    logs = []
    trows = tint.run_intensity_batched(
        str(folder), tint.IntensityConfig(**cfg_kw), out_root=str(tmp_path / "t"),
        log=logs.append if log is None else log, batch_size=batch_size,
        device="cpu")
    return jrows, trows, logs


def _assert_rows_match(trows, jrows):
    key = lambda r: (r["stage"], r["time"], r["roi"])  # noqa: E731
    assert [key(r) for r in trows] == [key(r) for r in jrows]
    for rt, rj in zip(trows, jrows):
        assert list(rt) == list(rj)
        for k, v in rj.items():
            if isinstance(v, float) and not _exact_col(k):
                if math.isnan(v):
                    assert math.isnan(rt[k]), k
                else:
                    assert abs(rt[k] - v) <= RTOL * max(abs(v), 1e-9), (
                        key(rj), k, rt[k], v)
            else:
                assert rt[k] == v and type(rt[k]) is type(v), (key(rj), k,
                                                               rt[k], v)


def _cells_match(col, a, b):
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except (TypeError, ValueError):
        return False
    if _exact_col(col):
        return fa == fb
    return abs(fa - fb) <= RTOL * max(abs(fb), 1e-9)


def _assert_reports_match(tmp_path):
    xls_t, xls_j = tmp_path / "t" / "xls", tmp_path / "j" / "xls"
    with open(xls_t / "fluor_intensity_perROI.csv", newline="") as f:
        ct = list(csv.reader(f))
    with open(xls_j / "fluor_intensity_perROI.csv", newline="") as f:
        cj = list(csv.reader(f))
    assert ct[0] == cj[0] and len(ct) == len(cj)
    for rt, rj in zip(ct[1:], cj[1:]):
        for col, a, b in zip(cj[0], rt, rj):
            assert _cells_match(col, a, b), (col, a, b)
    wt = xlsxlite.read_xlsx(str(xls_t / "fluor_intensity_perROI.xlsx"))
    wj = xlsxlite.read_xlsx(str(xls_j / "fluor_intensity_perROI.xlsx"))
    assert list(wt) == list(wj)
    for name in wj:
        assert wt[name][0] == wj[name][0], name          # headers
        assert len(wt[name]) == len(wj[name]), name
        for rt, rj in zip(wt[name][1:], wj[name][1:]):
            for col, a, b in zip(wj[name][0], rt, rj):
                assert _cells_match(col, a, b), (name, col, a, b)


def _write_stage(folder, s, shape, polys, rng, chans=(1,), t=None):
    H, W = shape
    tag = f"S{s:02d}" if t is None else f"S{s:02d}_t{t:02d}"
    for ch in chans:
        tiffio.write_tiff16(str(folder / f"{tag}_{ch}.TIF"),
                            rng.integers(10, 3000, (H, W)).astype(np.uint16))
    roiio.save_roi_bundle(str(folder / "roi" / f"{tag}.json"), tag, (H, W),
                          polys)


@pytest.fixture(scope="module")
def timelapse_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("tl")
    rng = np.random.default_rng(0)
    for t in range(8):
        _write_stage(folder, 1, (160, 192), [P1, P2], rng, (1, 2), t)
    return folder


def test_config_fields_and_defaults_match():
    import dataclasses

    jf = {f.name: f for f in dataclasses.fields(jint.IntensityConfig)}
    tf = {f.name: f for f in dataclasses.fields(tint.IntensityConfig)}
    assert list(tf) == list(jf)
    jc, tc = jint.IntensityConfig(), tint.IntensityConfig()
    for name in jf:
        if name in ("png_full", "png_crop"):   # a PanelPngOptions() each
            assert dataclasses.astuple(getattr(tc, name)) == \
                dataclasses.astuple(getattr(jc, name))
            continue
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.grammar.value == jc.grammar.value


def test_timelapse_rows_and_reports_match_jax(timelapse_folder, tmp_path):
    jrows, trows, logs = _run_both(timelapse_folder, tmp_path,
                                   channels=(1, 2), timelapse=True)
    assert len(trows) == 16
    assert any(str(line).startswith(("[batch]", "[배치]")) for line in logs)
    _assert_rows_match(trows, jrows)
    _assert_reports_match(tmp_path)


def test_histmode_rows_match_jax(timelapse_folder, tmp_path):
    jrows, trows, _ = _run_both(timelapse_folder, tmp_path, channels=(1, 2),
                                timelapse=True, bg_mode="hist-mode",
                                do_xls=False)
    _assert_rows_match(trows, jrows)


def test_varying_roi_counts_and_channel_sheets(tmp_path):
    """Stages with different ROI counts batch at one padded shape; the
    non-timelapse workbook holds per-channel sheets."""
    folder = tmp_path / "vary"
    rng = np.random.default_rng(1)
    for s, n in enumerate([2, 1, 2, 1, 1, 2], 1):
        _write_stage(folder, s, (160, 192), [P1, P2][:n], rng)
    jrows, trows, logs = _run_both(folder, tmp_path, channels=(1,))
    assert any(str(line).startswith(("[batch]", "[배치]")) for line in logs)
    assert len(trows) == 9
    _assert_rows_match(trows, jrows)
    _assert_reports_match(tmp_path)


def test_smaller_frame_than_hint_tile(tmp_path):
    folder = tmp_path / "mix"
    rng = np.random.default_rng(3)
    big = np.array([[20, 20], [150, 25], [145, 150], [18, 140]], float)
    small = np.array([[10, 10], [40, 12], [38, 40], [8, 36]], float)
    _write_stage(folder, 1, (200, 200), [big], rng)
    _write_stage(folder, 2, (64, 64), [small], rng)
    jrows, trows, logs = _run_both(folder, tmp_path, batch_size=2,
                                   channels=(1,), do_xls=False)
    assert [r["stage"] for r in trows] == ["S01", "S02"], logs
    _assert_rows_match(trows, jrows)


def test_mixed_shapes_keep_key_order(tmp_path):
    folder = tmp_path / "mixed"
    rng = np.random.default_rng(1)
    shapes = {1: (160, 192), 2: (160, 192), 3: (192, 160), 4: (160, 192)}
    for s, shape in shapes.items():
        _write_stage(folder, s, shape, [P1], rng)
    jrows, trows, _ = _run_both(folder, tmp_path, batch_size=2,
                                channels=(1,), do_xls=False)
    assert [r["stage"] for r in trows] == ["S01", "S02", "S03", "S04"]
    _assert_rows_match(trows, jrows)


@pytest.mark.parametrize("compression", ["tiff_adobe_deflate", "packbits"])
def test_deflate_and_packbits_datasets(tmp_path, compression):
    from PIL import Image

    folder = tmp_path / "exp"
    os.makedirs(folder / "roi")
    rng = np.random.default_rng(3)
    for s in range(1, 6):
        for ch in (1, 2):
            arr = rng.integers(10, 3000, (160, 192)).astype(np.uint16)
            Image.fromarray(arr).save(str(folder / f"S{s:02d}_{ch}.TIF"),
                                      format="TIFF", compression=compression)
        roiio.save_roi_bundle(str(folder / "roi" / f"S{s:02d}.json"),
                              f"S{s:02d}", (160, 192), [P1, P2])
    jrows, trows, _ = _run_both(folder, tmp_path, channels=(1, 2),
                                do_xls=False)
    assert len(trows) == 10
    _assert_rows_match(trows, jrows)


def test_cancel_keeps_partial_rows(timelapse_folder, tmp_path):
    state = {"n": 0}

    def cancel():
        state["n"] += 1
        return state["n"] > 6

    cfg = tint.IntensityConfig(channels=(1, 2), timelapse=True)
    logs = []
    rows = tint.run_intensity_batched(str(timelapse_folder), cfg,
                                      out_root=str(tmp_path), log=logs.append,
                                      batch_size=2, cancel=cancel,
                                      device="cpu")
    assert 0 < len(rows) < 16
    assert any("취소" in str(line) or "CANCEL" in str(line).upper()
               for line in logs)
    assert (tmp_path / "xls" / "fluor_intensity_perROI.csv").exists()
    jrows = jint.run_intensity_batched(
        str(timelapse_folder), jint.IntensityConfig(channels=(1, 2),
                                                    timelapse=True,
                                                    do_xls=False),
        log=lambda *_: None, batch_size=2)
    _assert_rows_match(rows, jrows[:len(rows)])


def test_fused_native_path_and_chunk_growth(tmp_path, monkeypatch):
    """Every key's tiles come out of ONE fused native call (no numpy
    gather), and the chunk size grows when decode runs ahead."""
    folder = tmp_path / "exp"
    rng = np.random.default_rng(1)
    for t in range(24):
        _write_stage(folder, 1, (160, 192), [P1], rng, t=t)
    fused, gathers, chunk_lens = [], [], []
    real_fused = port_native.decode_tiff_batch_hist_tiles
    real_gather = port_roistats.gather_tiles
    real_stream = port_runner.stream_batches

    def counting_fused(paths, hist_stride, offsets, tile, **k):
        fused.append(len(offsets) + k.get("pad_tiles", 0))
        return real_fused(paths, hist_stride, offsets, tile, **k)

    def counting_gather(*a, **k):
        gathers.append(a[2])
        return real_gather(*a, **k)

    def spy(loader, batch_size, classify, dispatch, *rest, **kw):
        def dispatch_spy(chunk):
            chunk_lens.append(len(chunk))
            return dispatch(chunk)
        return real_stream(loader, batch_size, classify, dispatch_spy, *rest,
                           **kw)

    monkeypatch.setattr(port_native, "decode_tiff_batch_hist_tiles",
                        counting_fused)
    monkeypatch.setattr(port_roistats, "gather_tiles", counting_gather)
    monkeypatch.setattr(port_runner, "stream_batches", spy)
    jrows, trows, _ = _run_both(folder, tmp_path, batch_size=2,
                                channels=(1,), timelapse=True, do_xls=False)
    assert len(trows) == 24
    assert len(fused) == 24 and len(set(fused)) == 1
    assert gathers == []
    assert max(chunk_lens) > 2, chunk_lens
    _assert_rows_match(trows, jrows)


def test_decode_then_gather_path_matches_fused(timelapse_folder, tmp_path,
                                               monkeypatch):
    """Without the fused native call the loader decodes, then gathers the
    tiles with numpy: the rows are the same, bit for bit."""
    cfg = tint.IntensityConfig(channels=(1, 2), timelapse=True, do_xls=False)
    fused = tint.run_intensity_batched(str(timelapse_folder), cfg,
                                       log=lambda *_: None, batch_size=3,
                                       device="cpu")
    gathers = []
    real_gather = port_roistats.gather_tiles
    monkeypatch.setattr(port_native, "decode_tiff_batch_hist_tiles",
                        lambda *a, **k: None)
    monkeypatch.setattr(port_roistats, "gather_tiles",
                        lambda *a, **k: gathers.append(a[2]) or real_gather(*a, **k))
    rows = tint.run_intensity_batched(str(timelapse_folder), cfg,
                                      log=lambda *_: None, batch_size=3,
                                      device="cpu")
    assert len(gathers) == 8
    assert len(rows) == len(fused) == 16
    for a, b in zip(rows, fused):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), k


@pytest.mark.parametrize("kw", [{"bg_scope": "roi_union"}, {"do_png": True},
                                {"do_tif": True}, {"save_raw_crop_tif": True}],
                         ids=lambda kw: next(iter(kw)))
def test_unsupported_configs_raise(timelapse_folder, tmp_path, kw):
    """The configs the batch does not cover do not raise: a bg_scope other
    than "full" and the image outputs (TIFF and PNG) hand the run to
    run_intensity, as the JAX runner does, and the rows and files are the
    JAX runner's.  ``save_raw_crop_tif`` alone (it belongs to the PNG
    crops) runs the batched path and writes no image.  (The name is kept
    from when the PNG outputs raised.)"""
    jrows, trows, logs = _run_both(timelapse_folder, tmp_path, channels=(1, 2),
                                   timelapse=True, do_xls=False, **kw)
    assert len(trows) == 16
    handed_over = "save_raw_crop_tif" not in kw
    assert (logs[0] == tint.t("int_images_serial")) == handed_over
    _assert_rows_match(trows, jrows)
    tiffs = {side: sorted(os.path.relpath(os.path.join(d, f), tmp_path / side)
                          for d, _, fs in os.walk(tmp_path / side) for f in fs
                          if f.endswith(".tif")) for side in "tj"}
    assert tiffs["t"] == tiffs["j"]
    assert bool(tiffs["t"]) == ("do_tif" in kw)
    if "do_png" in kw:
        # 8 timepoints x channels 1, 2 x (the frame and two ROI crops)
        assert_pngs_match(tmp_path / "t", tmp_path / "j", expect=48)
    else:
        assert png_files(tmp_path / "t") == []


def test_cuda_requested_without_card_raises(timelapse_folder, tmp_path,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tint.IntensityConfig(channels=(1, 2), timelapse=True)
    with pytest.raises(RuntimeError, match="is_available"):
        tint.run_intensity_batched(str(timelapse_folder), cfg,
                                   out_root=str(tmp_path))
    assert not (tmp_path / "xls").exists()


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    from imageprocess_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.load_library("tilestats_u16")
    monkeypatch.setattr(build, "find_nvcc",
                        lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="could not run nvcc"):
        build.load_library("tilestats_u16")


def test_keys_needing_the_full_frame_are_logged(tmp_path):
    """Mask-only ROIs, a missing ROI with skip_no_roi=False (whole-frame
    ROI 0) and 8-bit frames take the runner's per-key path
    (``process_key``, the full-frame program where they need it) and give
    the JAX runner's rows, in key order beside the batched keys; with
    skip_no_roi (the default) the key without ROI logs the reference's
    message once."""
    from PIL import Image

    folder = tmp_path / "exp"
    rng = np.random.default_rng(4)
    _write_stage(folder, 1, (160, 192), [P1], rng)
    tiffio.write_tiff16(str(folder / "S02_1.TIF"),
                        rng.integers(10, 3000, (160, 192)).astype(np.uint16))
    mask = np.zeros((160, 192), np.uint8)
    mask[20:60, 30:90] = 255
    Image.fromarray(mask).save(str(folder / "roi" / "S02.png"))
    tiffio.write_tiff8(str(folder / "S03_1.TIF"),
                       rng.integers(0, 255, (160, 192)).astype(np.uint8))
    roiio.save_roi_bundle(str(folder / "roi" / "S03.json"), "S03",
                          (160, 192), [P2])
    _write_stage(folder, 4, (160, 192), [P2], rng)
    tiffio.write_tiff16(str(folder / "S05_1.TIF"),
                        rng.integers(10, 3000, (160, 192)).astype(np.uint16))
    jrows, rows, logs = _run_both(folder, tmp_path, batch_size=2, channels=(1,),
                                  skip_no_roi=False, do_xls=False)
    assert [(r["stage"], r["roi"]) for r in rows] == [
        ("S01", 1), ("S02", 1), ("S03", 1), ("S04", 1), ("S05", 0)]
    assert not any("ERROR" in str(line) or "오류" in str(line) for line in logs)
    _assert_rows_match(rows, jrows)
    # skip_no_roi (the default) skips S05 with the reference's message
    logs.clear()
    cfg = tint.IntensityConfig(channels=(1,), do_xls=False)
    tint.run_intensity_batched(str(folder), cfg, out_root=str(tmp_path),
                               log=logs.append, batch_size=2, device="cpu")
    assert sum("S05" in str(line) and "Queue" not in str(line)
               for line in logs) == 1


def test_main_path_on_cpu_launches_no_kernel(timelapse_folder, tmp_path):
    tsk.reset_launches()
    rows = tint.run_intensity_batched(
        str(timelapse_folder), tint.IntensityConfig(channels=(1,),
                                                    timelapse=True,
                                                    do_xls=False),
        out_root=str(tmp_path), log=lambda *_: None, device="cpu")
    assert len(rows) == 16
    assert tsk.launches["tilestats_u16"] == 0


def _timing_keys(err, tag):
    lines = [ln for ln in err.splitlines() if ln.startswith(tag + " ")]
    assert len(lines) == 1, err
    return [kv.split("=")[0] for kv in lines[0][len(tag) + 1:].split("  ")], lines[0]


def test_ip_timing_line_has_jax_keys_and_leaves_rows_equal(timelapse_folder, tmp_path,
                                                           monkeypatch, capfd):
    """``IP_TIMING=1``: one ``[IP_TIMING] k=Nms ...`` line on stderr with
    the JAX runner's keys in its order; rows equal to the run without it;
    without the variable, no line."""
    kw = dict(channels=(1, 2), timelapse=True)
    monkeypatch.delenv("IP_TIMING", raising=False)
    plain = tint.run_intensity_batched(str(timelapse_folder), tint.IntensityConfig(**kw),
                                       out_root=str(tmp_path / "a"), log=lambda *_: None,
                                       batch_size=3, device="cpu")
    assert "[IP_TIMING" not in capfd.readouterr().err
    monkeypatch.setenv("IP_TIMING", "1")
    jint.run_intensity_batched(str(timelapse_folder), jint.IntensityConfig(**kw),
                               out_root=str(tmp_path / "j"), log=lambda *_: None,
                               batch_size=3)
    want, _ = _timing_keys(capfd.readouterr().err, "[IP_TIMING]")
    timed = tint.run_intensity_batched(str(timelapse_folder), tint.IntensityConfig(**kw),
                                       out_root=str(tmp_path / "b"), log=lambda *_: None,
                                       batch_size=3, device="cpu")
    got, line = _timing_keys(capfd.readouterr().err, "[IP_TIMING]")
    assert got == want and "ld_decode" in got
    assert all(kv.split("=")[1].endswith("ms") for kv in line.split("  ")[1:])
    assert timed == plain
