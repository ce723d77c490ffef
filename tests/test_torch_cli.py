"""The port's command line (``imageprocess_tpu_torch.cli``) against the JAX
package's (``imageprocess_tpu.cli``), without computing anything.

- Parser parity: every command and option of the JAX parser exists in the
  port's with the same option strings, dest, default, choices, nargs, type
  and ``required``; the one addition is ``--device`` on the commands that
  compute.
- The language pick (``-mode KO`` / ``--lang``) against the JAX
  ``pick_lang_from_argv`` on a table of argv.
- Config parity: the runners of both packages are replaced by recorders,
  and for a table of argv that sets every option to a value other than its
  default the two CLIs must hand the same configs (``dataclasses.asdict``),
  positional arguments and output paths to the same runners.
- Exit codes and the refusals: ``--devices`` above the count, malformed
  ``CH=VALUE`` pairs, ``ppt`` without pairs, no ``--device`` on a machine
  without a card, and the commands and flags of later slices, which raise
  before a file appears.
"""

import argparse
import dataclasses
import importlib
import os

import pytest
import torch

from imageprocess_tpu import cli as jcli
from imageprocess_tpu.core import i18n as ji18n
from imageprocess_tpu_torch import cli as tcli
from imageprocess_tpu_torch.core import i18n as ti18n

COMMANDS = ("intensity", "morphology", "fret", "nesprin2", "fa", "fa-tune",
            "crop", "roi-auto", "refine", "draw", "ppt", "doctor")
COMPUTING = ("intensity", "morphology", "fret", "nesprin2", "fa", "crop",
             "roi-auto", "refine")
RUNNERS = {  # runner: its module under either package
    "run_intensity": "pipelines.intensity",
    "run_intensity_batched": "pipelines.intensity",
    "run_morphology": "pipelines.morphology",
    "run_fret_batched": "pipelines.fret",
    "run_nesprin2": "pipelines.nesprin2",
    "run_nesprin2_batched": "pipelines.nesprin2",
    "run_fa_batch": "pipelines.fa",
    "run_fa_batched": "pipelines.fa",
    "run_crop": "pipelines.crop",
    "run_auto_drawer": "segment.auto",
    "refine_and_save": "segment.drawer",
    "run_fret_ppt": "pipelines.fretppt",
}


@pytest.fixture(autouse=True)
def _restore_lang():
    yield
    ti18n.set_lang("en")
    ji18n.set_lang("en")


def _subparsers(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _options(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parsers_list_the_same_commands():
    assert list(_subparsers(tcli.build_parser())) == list(COMMANDS)
    assert list(_subparsers(jcli.build_parser())) == list(COMMANDS)


@pytest.mark.parametrize("cmd", COMMANDS)
def test_parser_parity(cmd):
    """Same option strings, dest, default, choices, nargs, type, required
    and action for every option; ``--device`` (default ``cuda``) the only
    addition, on the commands that compute."""
    jopts = _options(_subparsers(jcli.build_parser())[cmd])
    topts = _options(_subparsers(tcli.build_parser())[cmd])
    extra = set(topts) - set(jopts)
    assert extra == ({"device"} if cmd in COMPUTING else set())
    assert set(jopts) <= set(topts)
    for dest, ja in jopts.items():
        ta = topts[dest]
        for attr in ("option_strings", "dest", "default", "choices", "nargs",
                     "type", "required", "const", "metavar"):
            assert getattr(ta, attr) == getattr(ja, attr), (cmd, dest, attr)
        assert type(ta) is type(ja), (cmd, dest)
    if cmd in COMPUTING:
        dev = topts["device"]
        assert dev.option_strings == ["--device"] and dev.default == "cuda"


def test_help_lists_all_workloads(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in ("intensity", "morphology", "fret", "nesprin2", "fa", "crop",
                "roi-auto", "refine", "ppt", "doctor"):
        assert cmd in out


LANG_ARGV = [
    [], ["-mode", "EN"], ["-mode", "KO"], ["-mode", "ko"], ["-mode", "FR"],
    ["-mode"], ["--lang", "en"], ["--lang=en"], ["--lang=ko"], ["--lang"],
    ["--lang", "xx"], ["-mode", "EN", "--lang", "ko"],
    ["--lang", "en", "-mode", "KO"], ["intensity", "f", "-mode", "EN"],
    ["--language", "en"],
]


@pytest.mark.parametrize("argv", LANG_ARGV, ids=lambda a: " ".join(a) or "none")
def test_pick_lang_from_argv_matches_jax(argv):
    assert ti18n.pick_lang_from_argv(argv) == ji18n.pick_lang_from_argv(argv)


def test_set_lang_matches_jax():
    for lang in ("EN", "ko", "xx", "en"):
        ti18n.set_lang(lang)
        ji18n.set_lang(lang)
        assert ti18n.LANG_CURRENT == ji18n.LANG_CURRENT
        assert ti18n.t("run_start") == ji18n.t("run_start")


@pytest.mark.parametrize("argv, banner", [
    (["-mode", "KO", "ppt", "{d}"], "실행 시작"),
    (["-mode", "KO", "ppt", "{d}", "--lang", "en"], "Run start"),
    (["ppt", "-mode", "EN", "{d}"], "Run start"),
])
def test_mode_flag_and_lang_pick_the_banner(argv, banner, tmp_path, capsys):
    """``-mode`` is stripped before argparse; ``--lang`` overrides it."""
    assert tcli.main([a.format(d=tmp_path) for a in argv]) == 1
    assert banner in capsys.readouterr().out.splitlines()[0]


# ------------------------------------------------------------------ config parity

def _record(monkeypatch, pkg):
    calls = []
    for fn, mod in RUNNERS.items():
        module = importlib.import_module(f"{pkg}.{mod}")

        def fake(*args, _fn=fn, **kw):
            calls.append((_fn, args, kw))
            return (True, "recorded") if _fn == "run_fret_ppt" else []

        monkeypatch.setattr(module, fn, fake)
    return calls


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _normalized(calls):
    """(runner, positional arguments, keyword arguments) with configs as
    dicts and the log callback, JAX's mesh and the port's device left
    out."""
    return [(fn, [_plain(a) for a in args],
             {k: _plain(v) for k, v in kw.items() if k not in ("log", "mesh", "device")})
            for fn, args, kw in calls]


def _run_both(monkeypatch, capsys, argv_of):
    """Both CLIs with recording runners: (exit codes, recorded calls, the
    port's devices, stdout lines) of each."""
    out = {}
    for name, mod, pkg in (("j", jcli, "imageprocess_tpu"),
                           ("t", tcli, "imageprocess_tpu_torch")):
        calls = _record(monkeypatch, pkg)
        argv = argv_of(name)
        if name == "t" and argv[0] != "ppt":
            argv = argv + ["--device", "cpu"]
        rc = mod.main(argv)
        out[name] = (rc, calls, capsys.readouterr().out.splitlines())
    return out


def _flags(d):
    """Every option of each computing command at a value other than its
    default (the flags of later slices are left out: the port refuses
    them)."""
    o = str(d / "out")
    return {
        "intensity": [
            "--channels", "2", "3", "--bg-mode", "hist-mode", "--bg-scope",
            "roi_union", "--percentile", "2.5", "--per-channel-p", "2=1", "3=0.5",
            "--bg-stride", "2", "--no-clip-neg", "--colors", "2=Green", "3=Red",
            "--tif", "--png", "--raw-crop-tif", "--tif-mask-outside", "--no-xls",
            "--px-um", "0.2", "--auto-lo", "2", "--auto-hi", "98", "--crop-size",
            "300", "--no-fixed-crop", "--dpi", "150", "--cmap", "viridis",
            "--colorbar", "--scalebar-um", "10", "--subset-stage", "1",
            "--subset-time", "2", "--subset-roi", "3", "--out", o, "--timelapse",
            "--lang", "en"],
        "morphology": [
            "--px-um", "0.3", "--channel", "2", "--include-no-channel",
            "--no-full", "--no-crop", "--mask-outside", "--scalebar-um", "5",
            "--mpl-canvas", "--out", o, "--timelapse", "--lang", "ko"],
        "fret": [
            "--donor-ch", "2", "--acceptor-ch", "3", "--ratio-mode", "Donor/FRET",
            "--percentile", "2", "--donor-p", "1.5", "--fret-p", "0.5",
            "--eps-percentile", "2", "--eps-abs", "3", "--bg-scope", "roi_union",
            "--tif", "--png", "--no-xls", "--no-mask-outside", "--no-cmap",
            "--cmap", "viridis", "--no-colorbar", "--cmin", "1", "--cmax", "2",
            "--dpi", "100", "--crop-w", "300", "--crop-h", "200",
            "--scalebar-um", "5", "--subset-stage", "1", "--subset-time", "2",
            "--out", o, "--timelapse"],
        "nesprin2": [
            "--donor-ch", "2", "--fret-ch", "3", "--intensity-ch", "1",
            "--aonly-ch", "4", "--px-um", "0.2", "--rim-um", "0.6", "--annulus",
            "--ann-in-um", "1.0", "--ann-out-um", "2.0", "--spectral", "--alpha",
            "0.1", "--beta", "0.2", "--g-factor", "1.5", "--sat-threshold", "4000",
            "--clip-ratio-max", "5", "--ratio-mode", "Donor/FRET", "--bg-mode",
            "hist-mode", "--bg-scope", "annulus", "--percentile", "2",
            "--donor-p", "1", "--fret-p", "0.5", "--eps-percentile", "2",
            "--eps-abs", "3", "--tif", "--png", "--no-xls", "--subset-stage", "1",
            "--subset-time", "2", "--out", o, "--timelapse"],
        "fa": [
            "--roi-dir", str(d / "roi"), "--out", o, "--channel", "1",
            "--px-size", "0.2", "--alpha", "2", "--min-area-um", "1",
            "--max-area-um", "20", "--close-radius", "2", "--no-subtract-bg",
            "--ok-only", "--max-fa-per-cell", "100", "--master-name", "M.xlsx",
            "--no-master", "--mat-dir", str(d / "mat")],
        "crop": [
            "--roi-dir", str(d / "roi"), "--channel", "2", "--color", "Red",
            "--gamma", "0.8", "--low-cut", "1", "--high-cut", "2",
            "--mask-outside", "--tiff16", "--tiff-raw", "--no-png", "--crop-w",
            "300", "--crop-h", "200", "--no-fixed-crop", "--dpi", "100",
            "--scalebar-um", "5", "--subset-stage", "1", "--subset-time", "2",
            "--subset-roi", "3", "--px-um", "0.2", "--out", o, "--timelapse"],
        "roi-auto": [
            "--backend", "unet", "--checkpoint", "general", "--prob-threshold",
            "0.4", "--channel", "2", "--thr-mode", "mean_std", "--thr-percentile",
            "80", "--thr-k", "1.5", "--smooth-sigma", "1", "--min-size-px", "50",
            "--diameter", "30", "--model-type", "cyto2", "--gpu", "--out", o,
            "--timelapse"],
        "refine": [
            "--thr", "80", "--mode", "bnd", "--min-area", "20", "--tolerance", "2",
            "--channel", "2", "--out", o, "--timelapse"],
        "ppt": ["--width-cm", "3.5"],
    }


CASES = {  # id: (command, argv after the folder, the runners called)
    "intensity-defaults": ("intensity", [], ["run_intensity"]),
    "intensity-all-flags": ("intensity", ["ALL"], ["run_intensity"]),
    "intensity-batched": ("intensity", ["--batched", "--channels", "2"],
                          ["run_intensity_batched"]),
    "intensity-batched-all-flags": ("intensity", ["ALL", "--batched"],
                                    ["run_intensity_batched"]),
    "intensity-all-experiments": ("intensity", ["--all-experiments"],
                                  ["run_intensity"] * 2),
    "intensity-all-experiments-out": ("intensity", ["--all-experiments", "--out", "O"],
                                      ["run_intensity"] * 2),
    "intensity-all-experiments-batched": (
        "intensity", ["--all-experiments", "--batched", "--out", "O"],
        ["run_intensity_batched"] * 2),
    "morphology": ("morphology", ["ALL"], ["run_morphology"]),
    "morphology-defaults": ("morphology", ["--px-um", "0.223"], ["run_morphology"]),
    "fret-defaults": ("fret", [], ["run_fret_batched"]),
    "fret-all-flags": ("fret", ["ALL"], ["run_fret_batched"]),
    "fret-donor-p-only": ("fret", ["--donor-p", "0.25"], ["run_fret_batched"]),
    "nesprin2-defaults": ("nesprin2", [], ["run_nesprin2"]),
    "nesprin2-all-flags": ("nesprin2", ["ALL"], ["run_nesprin2"]),
    "nesprin2-batched": ("nesprin2", ["ALL", "--batched"], ["run_nesprin2_batched"]),
    "nesprin2-preset-zero-thresholds": (
        "nesprin2", ["--rim-preset", "thick", "--sat-threshold", "0",
                     "--clip-ratio-max", "0", "--panel"], ["run_nesprin2"]),
    "fa-defaults": ("fa", ["--roi-dir", "R", "--out", "O"], ["run_fa_batch"]),
    "fa-all-flags": ("fa", ["ALL"], ["run_fa_batch"]),
    "fa-batched": ("fa", ["ALL", "--batched"], ["run_fa_batched"]),
    "crop-all-flags": ("crop", ["ALL"], ["run_crop"]),
    "crop-defaults": ("crop", [], ["run_crop"]),
    "roi-auto-all-flags": ("roi-auto", ["ALL"], ["run_auto_drawer"]),
    "roi-auto-defaults": ("roi-auto", [], ["run_auto_drawer"]),
    "refine-all-flags": ("refine", ["ALL"], ["refine_and_save"]),
    "refine-defaults": ("refine", [], ["refine_and_save"]),
    "ppt": ("ppt", ["ALL"], ["run_fret_ppt"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_config_parity(case, tmp_path, monkeypatch, capsys):
    """The same runners get the same configs, positional arguments and
    output paths ("O" is each CLI's own directory; ``--all-experiments``
    with ``--out`` writes each experiment under it)."""
    cmd, extra, runners = CASES[case]
    folder = tmp_path / "exp"
    for e in ("e1", "e2"):
        (folder / e).mkdir(parents=True)
        (folder / e / "S01_2.TIF").touch()
    (folder / "not_an_experiment").mkdir()
    flags = _flags(tmp_path)

    def argv_of(name):
        rest = []
        for a in extra:
            rest += flags[cmd] if a == "ALL" else [
                str(tmp_path / name / "O") if a == "O" else a]
        return [cmd, str(folder)] + rest

    out = _run_both(monkeypatch, capsys, argv_of)
    (jrc, jcalls, _), (trc, tcalls, tlines) = out["j"], out["t"]
    assert jrc == trc == 0
    assert [c[0] for c in tcalls] == runners

    def own_dirs_out(calls, name):
        def own(v):
            return v.replace(str(tmp_path / name), "<own>") if isinstance(v, str) else v

        return [(fn, [own(a) for a in args], {k: own(v) for k, v in kw.items()})
                for fn, args, kw in _normalized(calls)]

    assert own_dirs_out(tcalls, "t") == own_dirs_out(jcalls, "j")
    if cmd != "ppt":
        assert all(kw["device"] == torch.device("cpu") for _, _, kw in tcalls)
    if cmd == "intensity":
        assert tlines[-2] == ti18n.t("progress").format(done=0, total=0)


def test_all_experiments_without_experiments_exits_1(tmp_path, monkeypatch, capsys):
    out = _run_both(monkeypatch, capsys, lambda name: [
        "intensity", str(tmp_path), "--all-experiments", "--lang", "en"])
    assert out["j"][0] == out["t"][0] == 1
    assert out["j"][2] == out["t"][2]
    assert out["t"][1] == []


@pytest.mark.parametrize("argv", [
    ["intensity", "--batched"], ["intensity"], ["fret"], ["nesprin2"],
    ["nesprin2", "--batched"], ["fa", "--roi-dir", "R", "--out", "O"],
    ["fa", "--roi-dir", "R", "--out", "O", "--batched"], ["roi-auto"]])
def test_devices_above_the_count_exit_1_with_the_same_line(argv, tmp_path, monkeypatch,
                                                           capsys):
    """``--devices 2`` on one device (JAX's CPU backend cut to one device,
    the port's ``--device cpu``): exit 1 with the reference's line, no
    runner called."""
    import jax

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])
    out = _run_both(monkeypatch, capsys, lambda name: argv[:1] + [str(tmp_path)] + argv[1:]
                    + ["--devices", "2", "--lang", "en"])
    line = ti18n.t("cli_devices_error", lang="en").format(n=2, avail=1)
    for name in ("j", "t"):
        rc, calls, lines = out[name]
        assert rc == 1 and calls == [] and line in lines, (name, lines)
    assert out["j"][2] == out["t"][2]


def test_devices_within_the_count_raise_before_any_read(monkeypatch):
    """More than one device that the machine has: not ported, so it raises
    naming item 12, never running on one device silently."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = argparse.Namespace(devices=4, device=torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="item 12"):
        tcli._devices_ok(args, print)
    args.devices = 1
    assert tcli._devices_ok(args, print)


@pytest.mark.parametrize("argv", [
    ["--colors", "2Green"], ["--colors", "x=Green"], ["--per-channel-p", "2=x"],
    ["--per-channel-p", "2"]])
def test_malformed_channel_pairs_raise_the_same_system_exit(argv, tmp_path):
    msgs = []
    for mod, dev in ((jcli, []), (tcli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            mod.main(["intensity", str(tmp_path)] + argv + dev)
        msgs.append(e.value.code)
    assert msgs[0] == msgs[1] and str(msgs[0]).startswith(argv[0])


def test_ppt_without_pairs_exits_1(tmp_path, capsys):
    assert jcli.main(["ppt", str(tmp_path), "--lang", "en"]) == 1
    jout = capsys.readouterr().out
    assert tcli.main(["ppt", str(tmp_path), "--lang", "en"]) == 1
    assert capsys.readouterr().out == jout


# ------------------------------------------------------------------ refusals

def _refused(tmp_path, argv, exc):
    out = tmp_path / "out"
    with pytest.raises(exc) as e:
        tcli.main(argv)
    assert not out.exists() or not any(out.rglob("*"))
    return e.value


@pytest.mark.parametrize("cmd", COMPUTING)
def test_no_device_flag_fails_without_a_card(cmd, tmp_path, capsys):
    """No fallback: the default device is the card, and without one the run
    stops with resolve_device's message before anything is read."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    argv = [cmd, str(tmp_path), "--out", str(tmp_path / "out")]
    if cmd == "morphology":
        argv += ["--px-um", "0.2"]
    if cmd == "fa":
        argv += ["--roi-dir", str(tmp_path)]
    err = _refused(tmp_path, argv, SystemExit)
    assert "torch.cuda.is_available() is False" in str(err.code)
    assert "--device cpu" in str(err.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv, match", [
    (["nesprin2", "{d}", "--png", "--panel", "--out", "{o}", "--device", "cpu"],
     "item 14d"),
    (["nesprin2", "{d}", "--png", "--panel", "--batched", "--out", "{o}",
      "--device", "cpu"], "item 14d"),
    (["fa", "{d}", "--roi-dir", "{d}", "--out", "{o}", "--figs", "--device", "cpu"],
     "item 14d"),
    (["fa", "{d}", "--roi-dir", "{d}", "--out", "{o}", "--export-crops",
      "--device", "cpu"], "item 14d"),
    (["fa", "{d}", "--roi-dir", "{d}", "--out", "{o}", "--figs", "--export-crops",
      "--batched", "--device", "cpu"], "item 14d"),
    (["draw", "{d}"], "item 15"),
    (["fa-tune", "{d}", "--roi-dir", "{d}", "--out", "{o}"], "item 15"),
])
def test_later_slices_raise_before_any_file(argv, match, tmp_path):
    """The commands and flags of later slices raise, naming their item,
    before a file is read or written."""
    import numpy as np
    from PIL import Image

    Image.fromarray(np.zeros((8, 8), np.uint16)).save(tmp_path / "S01_1.TIF")
    before = sorted(os.listdir(tmp_path))
    err = _refused(tmp_path, [a.format(d=tmp_path, o=tmp_path / "out") for a in argv],
                   NotImplementedError)
    assert match in str(err)
    assert sorted(os.listdir(tmp_path)) == before


def test_devices_2_on_the_cpu_exits_1(tmp_path, capsys):
    """``--devices 2 --device cpu``: exit 1 with the reference's line, as
    JAX on one CPU device, before a file appears."""
    rc = tcli.main(["intensity", str(tmp_path), "--batched", "--devices", "2",
                    "--device", "cpu", "--out", str(tmp_path / "out"), "--lang", "en"])
    assert rc == 1
    assert "[error] --devices 2 > 1 available" in capsys.readouterr().out.splitlines()
    assert not (tmp_path / "out").exists()
