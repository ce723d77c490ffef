"""Port parity: the batched FRET tables path (pipelines.fret,
parallel.runner.batched_fret_tile_stats_step, report.excel.save_fret_excel)
against the JAX package on the CPU (``device="cpu"``, the plain PyTorch
statistics).

Bars, and why:
- keys, strings, ints, area_px, npx and the config columns exact: no
  arithmetic;
- host backgrounds and eps exact against the JAX host function (the same
  numpy arithmetic on the same histograms); the eps column within 1e-6
  relative where the JAX run takes its serial path, which computes eps in
  float32 on the device;
- quantiles (median, p5, p95) within 1e-6 relative: the same order
  statistics, interpolated by the same f32 operations, which the JAX CPU
  compiler may contract into one fused multiply-add;
- mean and std within 1e-5 relative: the sums run in another order."""

import csv
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.core import roiio, tiffio
from imageprocess_tpu.geom.polygon import pad_polygons
from imageprocess_tpu.pipelines import fret as jfret
from imageprocess_tpu_torch import native as port_native
from imageprocess_tpu_torch.report import xlsxlite
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.ops.stats import STAT_FIELDS
from imageprocess_tpu_torch.parallel import runner as port_runner
from imageprocess_tpu_torch.pipelines import fret as tfret
from imageprocess_tpu_torch.report import render as trender
from test_torch_tiffout import assert_pngs_match, lut_step, png_files

Q_RTOL = 1e-6
M_RTOL = 1e-5
EPS_RTOL = 1e-6
P1 = np.array([[15, 15], [60, 18], [55, 70], [12, 66]], float)
P2 = np.array([[70, 40], [115, 45], [110, 85], [65, 80]], float)
P3 = np.array([[120.5, 100.5], [170.5, 104.5], [150.5, 140.5]], float)


def _rtol(col):
    if col.endswith(("_median", "_p5", "_p95")):
        return Q_RTOL
    if col.endswith(("_mean", "_std")):
        return M_RTOL
    if col == "eps":
        return EPS_RTOL
    return 0.0


def _close(col, a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    tol = _rtol(col)
    if tol == 0.0:
        return a == b and type(a) is type(b)
    return abs(a - b) <= tol * max(abs(b), 1e-9)


def _assert_rows_match(trows, jrows):
    key = lambda r: (r["stage"], r["time"], r["roi"])  # noqa: E731
    assert [key(r) for r in trows] == [key(r) for r in jrows]
    for rt, rj in zip(trows, jrows):
        assert list(rt) == list(rj)
        for k, v in rj.items():
            assert _close(k, rt[k], v), (key(rj), k, rt[k], v)


def _cells_match(col, a, b):
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except (TypeError, ValueError):
        return False
    return abs(fa - fb) <= _rtol(col) * max(abs(fb), 1e-9)


def _assert_reports_match(xls_t, xls_j):
    with open(xls_t / "fret_ratio_perROI.csv", newline="") as f:
        ct = list(csv.reader(f))
    with open(xls_j / "fret_ratio_perROI.csv", newline="") as f:
        cj = list(csv.reader(f))
    assert ct[0] == cj[0] and len(ct) == len(cj)
    for rt, rj in zip(ct[1:], cj[1:]):
        for col, a, b in zip(cj[0], rt, rj):
            assert _cells_match(col, a, b), (col, a, b)
    wt = xlsxlite.read_xlsx(str(xls_t / "fret_ratio_perROI.xlsx"))
    wj = xlsxlite.read_xlsx(str(xls_j / "fret_ratio_perROI.xlsx"))
    assert list(wt) == list(wj) == ["per_ROI", "ratio_mean_matrix",
                                    "ratio_median_matrix"]
    for name in wj:
        assert wt[name][0] == wj[name][0], name          # headers
        assert len(wt[name]) == len(wj[name]), name
        for rt, rj in zip(wt[name][1:], wj[name][1:]):
            for col, a, b in zip(wj[name][0], rt, rj):
                if name != "per_ROI" and col != "time_idx":  # an ROI label
                    col = name[:-len("_matrix")]
                assert _cells_match(col, a, b), (name, col, a, b)


def _write_pair(folder, tag, shape, polys, rng, chans=(1, 2)):
    H, W = shape
    for ch in chans:
        base = rng.integers(10, 3000, (H, W))
        base[: H // 3] //= 8            # a dim band: clipped corrections
        tiffio.write_tiff16(str(folder / f"{tag}_{ch}.TIF"), base.astype(np.uint16))
    if polys is not None:
        roiio.save_roi_bundle(str(folder / "roi" / f"{tag}.json"), tag, (H, W),
                              polys)


@pytest.fixture(scope="module")
def exp_folder(tmp_path_factory):
    """6 stages: ROI counts 2/1/3/2/-/1, S04 of another frame shape (the
    per-pair path), S05 without an ROI file."""
    folder = tmp_path_factory.mktemp("fret")
    rng = np.random.default_rng(0)
    plan = [(1, (160, 192), [P1, P2]), (2, (160, 192), [P2]),
            (3, (160, 192), [P1, P2, P3]), (4, (192, 224), [P3, P1]),
            (5, (160, 192), None), (6, (160, 192), [P1])]
    (folder / "roi").mkdir()
    for s, shape, polys in plan:
        _write_pair(folder, f"S{s:02d}", shape, polys, rng)
    return folder


@pytest.fixture(scope="module")
def timelapse_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("fret_tl")
    rng = np.random.default_rng(1)
    (folder / "roi").mkdir()
    for t in range(5):
        _write_pair(folder, f"S02_t{t:02d}", (150, 180), [P1, P2], rng, (2, 3))
    return folder


def _run_both(folder, tmp_path, batch_size=2, log=None, **cfg_kw):
    jrows = jfret.run_fret_batched(
        str(folder), jfret.FretConfig(**cfg_kw), out_root=str(tmp_path / "j"),
        log=lambda *_: None, batch_size=batch_size)
    logs = []
    trows = tfret.run_fret_batched(
        str(folder), tfret.FretConfig(**cfg_kw), out_root=str(tmp_path / "t"),
        log=logs.append if log is None else log, batch_size=batch_size,
        device="cpu")
    return jrows, trows, logs


def test_config_fields_and_defaults_match():
    jf = [f.name for f in dataclasses.fields(jfret.FretConfig)]
    assert [f.name for f in dataclasses.fields(tfret.FretConfig)] == jf
    jc, tc = jfret.FretConfig(), tfret.FretConfig()
    for name in jf:
        if name == "grammar":
            assert tc.grammar.value == jc.grammar.value
        else:
            assert getattr(tc, name) == getattr(jc, name), name


def test_experiment_rows_and_reports_match_jax(exp_folder, tmp_path):
    jrows, trows, logs = _run_both(exp_folder, tmp_path, donor_ch=1,
                                   acceptor_ch=2)
    assert [r["stage"] for r in trows] == ["S01"] * 2 + ["S02"] + ["S03"] * 3 \
        + ["S04"] * 2 + ["S06"]
    assert sum("S05" in str(line) for line in logs) == 1       # ROI missing
    assert not any("ERROR" in str(line) or "오류" in str(line)
                   for line in logs), logs
    _assert_rows_match(trows, jrows)
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")


def test_timelapse_donor_over_fret_matches_jax(timelapse_folder, tmp_path):
    jrows, trows, _ = _run_both(timelapse_folder, tmp_path, batch_size=3,
                                donor_ch=2, acceptor_ch=3, timelapse=True,
                                ratio_mode="Donor/FRET")
    assert [r["time"] for r in trows] == [f"t{t:02d}" for t in range(5)
                                          for _ in range(2)]
    _assert_rows_match(trows, jrows)
    _assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")


@pytest.mark.parametrize("kw", [
    {"clip_neg": False, "bg_mode": "none"},
    {"per_channel_p": True, "donor_p": 2.5, "fret_p": 0.5,
     "eps_percentile": 5.0, "eps_abs": 1.0},
], ids=["noclip-nobg", "per-channel-p"])
def test_variants_match_jax(exp_folder, tmp_path, kw):
    jrows, trows, _ = _run_both(exp_folder, tmp_path, batch_size=3,
                                donor_ch=1, acceptor_ch=2, do_xls=False, **kw)
    assert len(trows) == 9
    _assert_rows_match(trows, jrows)


def test_build_fret_pairs_match(exp_folder, timelapse_folder):
    for folder, kw in ((exp_folder, {}), (exp_folder, {"subset_stage": 3}),
                       (timelapse_folder, {"timelapse": True, "donor_ch": 2,
                                           "acceptor_ch": 3}),
                       (timelapse_folder, {"timelapse": True, "donor_ch": 2,
                                           "acceptor_ch": 3, "subset_stage": 2,
                                           "subset_time": 3})):
        assert tfret.build_fret_pairs(str(folder), tfret.FretConfig(**kw)) == \
            jfret.build_fret_pairs(str(folder), jfret.FretConfig(**kw))


@pytest.mark.parametrize("kw", [{}, {"ratio_mode": "Donor/FRET"},
                                {"bg_mode": "none"},
                                {"bg_mode": "none", "ratio_mode": "Donor/FRET"},
                                {"clip_neg": False, "eps_percentile": 30.0},
                                {"per_channel_p": True, "donor_p": 0.1,
                                 "fret_p": 99.9}])
def test_host_scalars_equal_jax(exp_folder, kw):
    D = tiffio.read_2d(str(exp_folder / "S03_1.TIF"), dtype=None)
    A = tiffio.read_2d(str(exp_folder / "S03_2.TIF"), dtype=None)
    hists = np.stack([port_native.u16_hist(D), port_native.u16_hist(A)])
    for h in (None, hists):
        got = tfret._host_fret_scalars(D, A, tfret.FretConfig(**kw), hists=h)
        want = jfret._host_fret_scalars(D, A, jfret.FretConfig(**kw), hists=h)
        assert got == want


def _step_inputs(seed=2, B=3, N=4, t=48):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 3000, (B, N, 2, t, t)).astype(np.uint16)
    polys = []
    for _ in range(B * N):
        k = int(rng.integers(3, 10))
        p = rng.uniform(1, t - 2, (k, 2))
        c = p.mean(axis=0)
        polys.append(p[np.argsort(np.arctan2(p[:, 1] - c[1], p[:, 0] - c[0]))])
    lp = pad_polygons(polys, 16).reshape(B, N, 16, 2).astype(np.float32)
    lp[0, 2] = 3.0                  # degenerate polygon: an empty ROI
    valid = np.ones((B, N), bool)
    valid[2, 2:] = False            # padded lanes
    # without clipping, x - bg goes down to -30; eps > 30 keeps every
    # ratio's denominator positive, so no ratio mean is a sum that cancels
    # to near zero (where a relative bar means nothing)
    bgs = rng.uniform(0, 30, (B, 2)).astype(np.float32)
    eps = rng.uniform(35, 60, B).astype(np.float32)
    return tiles, lp, valid, bgs, eps


@pytest.mark.parametrize("flip", [False, True], ids=["FoverD", "DoverF"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
def test_batched_fret_tile_stats_matches_jax(clip, flip):
    tiles, lp, valid, bgs, eps = _step_inputs()
    ws, wa = jfret.batched_fret_tile_stats(
        *(jnp.asarray(a) for a in (tiles, lp, valid, bgs, eps)),
        clip_neg=clip, flip=flip)
    gs, ga = tfret.batched_fret_tile_stats(
        *(torch.from_numpy(a) for a in (tiles, lp, valid, bgs, eps)),
        clip_neg=clip, flip=flip)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert (ga.numpy()[0, 2] == 0) and (ga.numpy()[2, 2:] == 0).all()
    for f in STAT_FIELDS:
        a, b = gs[f].numpy().astype(np.float64), np.asarray(ws[f], np.float64)
        assert a.shape == b.shape == (3, 3, 4), f
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        ok = ~np.isnan(b)
        if f in ("npx", "vmin", "vmax"):
            np.testing.assert_array_equal(a[ok], b[ok], err_msg=f)
        else:
            np.testing.assert_allclose(a[ok], b[ok], atol=0, err_msg=f, rtol=(
                Q_RTOL if f in ("median", "p5", "p95") else M_RTOL))


def test_step_on_cpu_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _step_inputs(seed=3)]
    before = dict(rsk.launches)
    got = port_runner.batched_fret_tile_stats_step(*args, clip_neg=False, flip=True)
    want = rsk.fret_tile_stats_packed_plain(*args, clip_neg=False, flip=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert got.shape == (3, 10, 3, 4)
    assert rsk.launches == before


EXP_PLAN = {1: [P1, P2], 2: [P2], 3: [P1, P2, P3], 4: [P3, P1], 6: [P1]}


def _exp_colorbar(name):
    """The crop under the inset colorbar of an ``exp_folder`` crop PNG."""
    if not name.startswith("PNG_RAT/crop"):
        return None
    stage, roi = int(name.split("/S")[1][:2]), int(name.split("_roi")[1].split("_")[0])
    W, H = (224, 192) if stage == 4 else (192, 160)
    x0, x1, y0, y1 = trender.crop_bbox_poly(EXP_PLAN[stage][roi - 1], W, H)
    return x1 - x0 + 1, y1 - y0 + 1


@pytest.mark.parametrize("kw", [{"bg_scope": "roi_union"}, {"do_png": True},
                                {"do_tif": True}, {"bg_mode": "hist-mode"}],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unsupported_configs_raise(exp_folder, tmp_path, kw):
    """The configs the batch does not cover (bg_scope "roi_union", bg_mode
    "hist-mode", the TIFF and PNG outputs) do not raise: the batched runner
    hands them to run_fret, as the JAX runner does, and the rows are the
    JAX runner's.  The PNGs, at FretConfig's defaults (the inset colorbar
    on every crop), are the JAX runner's without the colorbar outside the
    colorbar's box (``assert_pngs_match``).  (The name is kept from when
    the PNG outputs raised.)"""
    jkw = dict(kw, show_colorbar=False) if "do_png" in kw else kw
    jrows = jfret.run_fret_batched(
        str(exp_folder), jfret.FretConfig(donor_ch=1, acceptor_ch=2, do_xls=False, **jkw),
        out_root=str(tmp_path / "j"), log=lambda *_: None, batch_size=2)
    trows = tfret.run_fret_batched(
        str(exp_folder), tfret.FretConfig(donor_ch=1, acceptor_ch=2, do_xls=False, **kw),
        out_root=str(tmp_path / "t"), log=lambda *_: None, batch_size=2, device="cpu")
    assert len(trows) == 9
    _assert_rows_match(trows, jrows)
    if "do_png" in kw:
        # six full ratio frames, nine crops
        names = assert_pngs_match(tmp_path / "t", tmp_path / "j", step=lut_step("jet"),
                                  expect=15, colorbar=_exp_colorbar)
        assert sum(_exp_colorbar(n) is not None for n in names) == 9
    else:
        assert png_files(tmp_path / "t") == []


def test_cuda_requested_without_card_raises(exp_folder, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tfret.run_fret_batched(str(exp_folder), tfret.FretConfig(),
                               out_root=str(tmp_path))
    assert not (tmp_path / "xls").exists()


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    from imageprocess_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.load_library("roistats_f32")


def test_pairs_needing_the_full_frame_are_logged(tmp_path):
    """An 8-bit pair and a pair whose ROI needs the whole frame take the
    runner's per-pair path (``process_pair``, the full-frame program for
    the latter) and give the JAX runner's rows, in key order beside the
    batched pairs; a folder without pairs logs that and writes nothing."""
    folder = tmp_path / "exp"
    (folder / "roi").mkdir(parents=True)
    rng = np.random.default_rng(4)
    _write_pair(folder, "S01", (160, 192), [P1], rng)
    for ch in (1, 2):
        tiffio.write_tiff8(str(folder / f"S02_{ch}.TIF"),
                           rng.integers(0, 255, (160, 192)).astype(np.uint8))
    roiio.save_roi_bundle(str(folder / "roi" / "S02.json"), "S02", (160, 192), [P2])
    big = np.array([[0.5, 0.5], [190.5, 2.5], [180.5, 158.5], [3.5, 150.5]])
    _write_pair(folder, "S03", (160, 192), [big], rng)
    _write_pair(folder, "S04", (160, 192), [P2], rng)
    jrows, rows, logs = _run_both(folder, tmp_path, do_xls=False)
    assert [r["stage"] for r in rows] == ["S01", "S02", "S03", "S04"]
    assert not any("ERROR" in str(line) or "오류" in str(line)
                   for line in logs), logs
    _assert_rows_match(rows, jrows)
    logs.clear()
    assert tfret.run_fret_batched(str(folder), tfret.FretConfig(donor_ch=7),
                                  out_root=str(tmp_path / "o"), log=logs.append,
                                  device="cpu") == []
    assert len(logs) == 1 and "7" in logs[0]
    assert not (tmp_path / "o").exists()


def test_fused_native_path_feeds_every_batched_pair(exp_folder, tmp_path,
                                                    monkeypatch):
    """Same-shaped pairs come out of ONE fused native call each; with the
    fused call unavailable the decode-then-gather loader gives the same
    rows, bit for bit."""
    fused = []
    real = port_native.decode_tiff_batch_hist_tiles

    def counting(paths, *a, **k):
        fused.append(paths[0])
        return real(paths, *a, **k)

    cfg = tfret.FretConfig(do_xls=False)
    monkeypatch.setattr(port_native, "decode_tiff_batch_hist_tiles", counting)
    # one loader thread: S01 sets the run's hints (tile 64, 2 ROIs)
    rows = tfret.run_fret_batched(str(exp_folder), cfg, log=lambda *_: None,
                                  batch_size=2, prefetch_workers=1, device="cpu")
    # S03 outgrows the ROI-count hint and S05 has no ROI file; S04 fits
    # the hint but not the run's frame shape (the per-pair path)
    assert [p.rsplit("/", 1)[1][:3] for p in fused] == ["S01", "S02", "S04", "S06"]
    monkeypatch.setattr(port_native, "decode_tiff_batch_hist_tiles",
                        lambda *a, **k: None)
    again = tfret.run_fret_batched(str(exp_folder), cfg, log=lambda *_: None,
                                   batch_size=2, device="cpu")
    assert len(rows) == len(again) == 9
    for a, b in zip(rows, again):
        assert a == b


def test_main_path_on_cpu_launches_no_kernel(timelapse_folder, tmp_path):
    rsk.reset_launches()
    rows = tfret.run_fret_batched(
        str(timelapse_folder), tfret.FretConfig(donor_ch=2, acceptor_ch=3,
                                                timelapse=True, do_xls=False),
        out_root=str(tmp_path), log=lambda *_: None, device="cpu")
    assert len(rows) == 10
    assert rsk.launches["roistats_f32"] == 0


@pytest.mark.cuda
def test_cuda_run_matches_cpu_run(exp_folder, tmp_path):
    """On a card: the runner on the card (the hand kernel) against the
    same run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    cfg = tfret.FretConfig(do_xls=False)
    rsk.reset_launches()
    on_card = tfret.run_fret_batched(str(exp_folder), cfg, log=lambda *_: None,
                                     batch_size=2, device="cuda")
    assert rsk.launches["roistats_f32"] >= 1
    on_cpu = tfret.run_fret_batched(str(exp_folder), cfg, log=lambda *_: None,
                                    batch_size=2, device="cpu")
    _assert_rows_match(on_card, on_cpu)
