"""The port's command line end to end on the CPU (``--device cpu``), on one
tiny experiment: 80 x 112 u16 frames of channels 1 and 2, one polygon.

- ``intensity`` (the serial default) and ``fret`` through both CLIs: the
  rows the runners return and the CSV / XLSX reports, held to the runner
  tests' bars (``test_torch_serial``, ``test_torch_fret``: areas, npx and
  strings exact, order statistics equal up to XLA's last ulps, moments
  within 1e-5 relative).
- ``intensity --batched`` writes ``RES/logs/run_*.txt`` with
  ``[START]`` / ``[END]``.
- Every other command through the port's CLI alone: its files equal the
  port's direct runner call on the same folder, byte for byte (zip
  archives entry by entry).  The runner tests hold those runners to JAX.
- ``--xprof DIR`` writes a ``torch.profiler`` trace that parses as JSON.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from imageprocess_tpu import cli as jcli
from imageprocess_tpu.core import roiio, tiffio
from imageprocess_tpu.pipelines import fret as jfret
from imageprocess_tpu.pipelines import intensity as jint
from imageprocess_tpu_torch import cli as tcli
from imageprocess_tpu_torch.core import i18n as ti18n
from imageprocess_tpu_torch.pipelines import fret as tfret
from imageprocess_tpu_torch.pipelines import intensity as tint

import test_torch_fret
import test_torch_serial

H, W = 80, 112
POLY = np.array([[15, 15], [60, 18], [55, 60], [12, 55]], float)
CPU = ["--device", "cpu", "--lang", "en"]


@pytest.fixture(autouse=True)
def _restore_lang():
    yield
    ti18n.set_lang("en")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny CPU runs: with the suite's other
    workers busy, torch's full thread pool stalled the U-Net case many
    times over its time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """Channels 1 and 2 of one stage (values below 4096, with a bright
    blob inside the ROI), the ROI bundle, and ratio / BF thumbnails for
    the deck."""
    from PIL import Image

    d = tmp_path_factory.mktemp("cli_exp")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    blob = 1800 * np.exp(-((yy - 38) ** 2 + (xx - 36) ** 2) / 60.0)
    for ch in (1, 2):
        img = rng.integers(10, 2000, (H, W)) + blob
        tiffio.write_tiff16(str(d / f"S01_{ch}.TIF"), img.clip(0, 4000).astype(np.uint16))
    roiio.save_roi_bundle(str(d / "roi" / "S01.json"), "S01", (H, W), [POLY])
    thumbs = d / "thumbs"
    thumbs.mkdir()
    for s in ("S01", "S02"):
        for t in range(3):
            for suffix, shape in (("DoverF_rim", (40, 40, 3)), ("BF", (40, 60, 3))):
                Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8)).save(
                    thumbs / f"{s}_t{t:02d}_roi1_{suffix}.png")
    return d


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """One 256 x 320 synthcells "fluor" frame (channel 4) for the U-Net."""
    from imageprocess_tpu_torch.models import synthcells

    d = tmp_path_factory.mktemp("cli_cells")
    img, _ = synthcells.synth_frame(np.random.default_rng(11), 256, 320, "fluor")
    tiffio.write_tiff16(str(d / "S01_4.TIF"), np.clip(img, 0, 65535).astype(np.uint16))
    return d


def _capture_rows(monkeypatch, module, name):
    """Wrap *module*.*name* so that the rows it returns are kept."""
    real, kept = getattr(module, name), []

    def wrapped(*args, **kw):
        rows = real(*args, **kw)
        kept.append(rows)
        return rows

    monkeypatch.setattr(module, name, wrapped)
    return kept


def test_intensity_matches_jax(exp, tmp_path, monkeypatch, capsys):
    jrows = _capture_rows(monkeypatch, jint, "run_intensity")
    trows = _capture_rows(monkeypatch, tint, "run_intensity")
    argv = ["intensity", str(exp), "--channels", "1", "2", "--colors", "1=Green",
            "2=Red", "--lang", "en"]
    assert jcli.main(argv + ["--out", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out.splitlines()
    assert tcli.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    tout = capsys.readouterr().out.splitlines()
    assert len(jrows) == len(trows) == 1 and len(trows[0]) == 1
    test_torch_serial._assert_rows_match(trows[0], jrows[0])
    test_torch_serial._assert_reports_match(str(tmp_path / "t" / "xls"),
                                            str(tmp_path / "j" / "xls"),
                                            "fluor_intensity_perROI")
    for name in ("j", "t"):  # run_log=True, progress=True
        logs = glob.glob(str(tmp_path / name / "logs" / "run_*.txt"))
        assert len(logs) == 1
    assert tout[0] == jout[0] == "================= Run start ================="
    assert tout[-2:] == jout[-2:] == ["[Progress] 1/1", "================= Run end ================="]


def test_fret_matches_jax(exp, tmp_path, monkeypatch):
    jrows = _capture_rows(monkeypatch, jfret, "run_fret_batched")
    trows = _capture_rows(monkeypatch, tfret, "run_fret_batched")
    argv = ["fret", str(exp), "--donor-ch", "1", "--acceptor-ch", "2", "--lang", "en"]
    assert jcli.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert tcli.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert len(trows[0]) == 1
    test_torch_fret._assert_rows_match(trows[0], jrows[0])
    test_torch_fret._assert_reports_match(tmp_path / "t" / "xls", tmp_path / "j" / "xls")


def _same_files(a, b, expect):
    """chip_smoke.py's comparison of two output trees (bytes; zip archives
    entry by entry; run logs and traces left out)."""
    import chip_smoke

    chip_smoke.same_tree(str(a), str(b), "e2e", expect)


def test_intensity_batched_writes_the_run_log(exp, tmp_path):
    out = tmp_path / "t"
    assert tcli.main(["intensity", str(exp), "--channels", "1", "2", "--batched",
                      "--out", str(out)] + CPU) == 0
    logs = glob.glob(str(out / "logs" / "run_*.txt"))
    assert len(logs) == 1
    text = open(logs[0], encoding="utf-8").read()
    assert text.startswith("[START]") and "[END]" in text
    tint.run_intensity_batched(str(exp), tint.IntensityConfig(channels=(1, 2)),
                               out_root=str(tmp_path / "d"), log=lambda *_: None,
                               device="cpu")
    _same_files(out, tmp_path / "d", [os.path.join("xls", "fluor_intensity_perROI.csv")])


def _direct(cmd, exp, out):
    """The port's runner as the CLI calls it for *cmd* (below)."""
    from imageprocess_tpu_torch.pipelines import crop, fa, morphology, nesprin2
    from imageprocess_tpu_torch.segment import auto, drawer

    q = dict(log=lambda *_: None, device="cpu")
    f = str(exp)
    if cmd == "morphology":
        morphology.run_morphology(f, morphology.MorConfig(px_um=0.223, sel_ch=2),
                                  out_root=out, **q)
    elif cmd in ("nesprin2", "nesprin2-batched"):
        cfg = nesprin2.Nesprin2Config(donor_ch=1, fret_ch=2, px_um=0.223, rim_um=1.0)
        run = nesprin2.run_nesprin2_batched if cmd.endswith("batched") else nesprin2.run_nesprin2
        run(f, cfg, out_root=out, **q)
    elif cmd in ("fa", "fa-batched"):
        cfg = fa.FaConfig(channel=1, alpha=1.5, min_area_um=0.2)
        run = fa.run_fa_batched if cmd.endswith("batched") else fa.run_fa_batch
        run(f, f + "/roi", out, cfg, **q)
    elif cmd == "crop":
        crop.run_crop(f, f + "/roi", out, crop.CropConfig(channel=1, save_tiff16=True), **q)
    elif cmd in ("roi-auto", "roi-auto-unet"):
        cfg = (auto.AutoSegConfig(backend="unet", channel=4) if cmd.endswith("unet") else
               auto.AutoSegConfig(channel=1, thr_mode="mean_std", min_size_px=20))
        auto.run_auto_drawer(f, cfg, roi_dir=out, **q)
    elif cmd == "refine":
        drawer.refine_and_save(f, drawer.RefineConfig(thr_param=90.0, min_area=10.0),
                               roi_dir=out, **q)


CLI_ARGV = {  # the port's CLI; the direct call above
    "morphology": (["morphology", "{f}", "--px-um", "0.223", "--channel", "2"],
                   [os.path.join("xls", "morphology_perROI.csv")]),
    "nesprin2": (["nesprin2", "{f}", "--donor-ch", "1", "--fret-ch", "2",
                  "--px-um", "0.223", "--rim-um", "1.0"],
                 [os.path.join("xls", "nesprin2_fret_perROI.csv")]),
    "nesprin2-batched": (["nesprin2", "{f}", "--donor-ch", "1", "--fret-ch", "2",
                          "--px-um", "0.223", "--rim-um", "1.0", "--batched"],
                         [os.path.join("xls", "nesprin2_fret_perROI.csv")]),
    "fa": (["fa", "{f}", "--roi-dir", "{f}/roi", "--channel", "1", "--alpha", "1.5",
            "--min-area-um", "0.2"], ["FA_Results_Master.xlsx"]),
    "fa-batched": (["fa", "{f}", "--roi-dir", "{f}/roi", "--channel", "1", "--alpha",
                    "1.5", "--min-area-um", "0.2", "--batched"], ["FA_Results_Master.xlsx"]),
    "crop": (["crop", "{f}", "--channel", "1", "--tiff16"],
             [os.path.join("TIFF16", "S01_roi1_ch1.tif")]),
    "roi-auto": (["roi-auto", "{f}", "--channel", "1", "--thr-mode", "mean_std",
                  "--min-size-px", "20"], ["S01.json"]),
    "roi-auto-unet": (["roi-auto", "{f}", "--channel", "4", "--backend", "unet"],
                      ["S01.json"]),
    "refine": (["refine", "{f}", "--thr", "90", "--min-area", "10"],
               ["S01.json", os.path.join("mask", "S01_mask.tif"),
                os.path.join("zip", "S01.zip")]),
}


@pytest.mark.parametrize("cmd", list(CLI_ARGV))
def test_command_equals_the_direct_call(cmd, exp, cells, tmp_path):
    argv, expect = CLI_ARGV[cmd]
    src = cells if cmd == "roi-auto-unet" else exp
    if cmd == "refine":  # it rewrites the rough ROIs in place: one copy each
        src = tmp_path / "exp"
        shutil.copytree(exp, src, ignore=shutil.ignore_patterns("thumbs"))
        shutil.copytree(src / "roi", tmp_path / "d")
        shutil.copytree(src / "roi", tmp_path / "t")
    argv = [a.format(f=src) for a in argv] + ["--out", str(tmp_path / "t")] + CPU
    assert tcli.main(argv) == 0
    _direct(cmd, src, str(tmp_path / "d"))
    _same_files(tmp_path / "t", tmp_path / "d", expect)


def test_ppt_equals_the_direct_call(exp, tmp_path):
    from imageprocess_tpu_torch.pipelines import fretppt

    for name in ("t", "d"):
        shutil.copytree(exp / "thumbs", tmp_path / name)
    assert tcli.main(["ppt", str(tmp_path / "t"), "--width-cm", "2.5", "--lang", "en"]) == 0
    ok, _ = fretppt.run_fret_ppt(str(tmp_path / "d"), 2.5, log=lambda *_: None)
    assert ok
    _same_files(tmp_path / "t", tmp_path / "d", ["FRET_timelapse_auto.pptx"])


def test_xprof_writes_a_trace(exp, tmp_path):
    trace_dir = tmp_path / "trace"
    assert tcli.main(["intensity", str(exp), "--channels", "1", "--out",
                      str(tmp_path / "t"), "--xprof", str(trace_dir)] + CPU) == 0
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
