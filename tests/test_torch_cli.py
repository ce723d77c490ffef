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
  without a card.
- The interactive ``draw`` and ``fa-tune`` through ``cli.main`` under Agg,
  ``plt.show`` replaced by synthetic key presses and clicks: the files they
  save equal the JAX CLI's driven the same way.
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
COMPUTING = ("intensity", "morphology", "fret", "nesprin2", "fa", "fa-tune",
             "crop", "roi-auto", "refine", "draw")
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
    "draw.main": "apps.draw",          # module.function of the interactive apps
    "fa_tune.main": "apps.fa_tune",
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


# choices the port has and the JAX CLI lacks: (command, dest) -> appended choices
PORT_CHOICES = {("roi-auto", "backend"): ["cpsam"]}   # Cellpose-SAM, models.cpsam


@pytest.mark.parametrize("cmd", COMMANDS)
def test_parser_parity(cmd):
    """Same option strings, dest, default, choices, nargs, type, required
    and action for every option; ``--device`` (default ``cuda``) the only
    addition, on the commands that compute, and ``PORT_CHOICES`` the only
    choices added."""
    jopts = _options(_subparsers(jcli.build_parser())[cmd])
    topts = _options(_subparsers(tcli.build_parser())[cmd])
    extra = set(topts) - set(jopts)
    assert extra == ({"device"} if cmd in COMPUTING else set())
    assert set(jopts) <= set(topts)
    for dest, ja in jopts.items():
        ta = topts[dest]
        for attr in ("option_strings", "dest", "default", "nargs",
                     "type", "required", "const", "metavar"):
            assert getattr(ta, attr) == getattr(ja, attr), (cmd, dest, attr)
        extra_choices = PORT_CHOICES.get((cmd, dest), [])
        assert ta.choices == (ja.choices + extra_choices if extra_choices else ja.choices), (
            cmd, dest, "choices")
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

        monkeypatch.setattr(module, fn.split(".")[-1], fake)
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
        "fa-tune": [
            "--roi-dir", str(d / "roi"), "--out", o, "--channel", "1",
            "--px-size", "0.2", "--alpha", "2.5", "--mat-dir", str(d / "mat"),
            "--lang", "ko"],
        "draw": ["--timelapse", "--lang", "en"],
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
    "fa-tune-all-flags": ("fa-tune", ["ALL"], ["fa_tune.main"]),
    "fa-tune-defaults": ("fa-tune", ["--roi-dir", "R", "--out", "O"], ["fa_tune.main"]),
    "draw-all-flags": ("draw", ["ALL"], ["draw.main"]),
    "draw-defaults": ("draw", [], ["draw.main"]),
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


def test_devices_within_the_count_build_a_mesh(monkeypatch):
    """More than one device that the machine has: the mesh of its first N
    cards, never a run on one device; one device: no mesh, as JAX."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = argparse.Namespace(devices=4, device=torch.device("cuda"))
    ok, mesh = tcli._mesh_for(args, print)
    assert ok and mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    args.devices = 1
    assert tcli._mesh_for(args, print) == (True, None)


@pytest.mark.parametrize("argv", [
    ["intensity", "--batched"], ["fret"], ["nesprin2", "--batched"],
    ["fa", "--roi-dir", "R", "--out", "O", "--batched"]])
def test_devices_1_calls_the_runner_as_without_it(argv, tmp_path, monkeypatch):
    """``--devices 1`` is the run without a mesh: the same runner call,
    ``mesh=None``."""
    calls = _record(monkeypatch, "imageprocess_tpu_torch")
    base = argv[:1] + [str(tmp_path)] + argv[1:] + ["--device", "cpu", "--lang", "en"]
    assert tcli.main(base) == 0 and tcli.main(base + ["--devices", "1"]) == 0
    assert len(calls) == 2 and calls[0][2]["mesh"] is None
    assert _normalized(calls[:1]) == _normalized(calls[1:]) and \
        calls[0][2] == calls[1][2] | {"log": calls[0][2]["log"]}


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
    argv = [cmd, str(tmp_path)] + ([] if cmd == "draw" else ["--out", str(tmp_path / "out")])
    if cmd == "morphology":
        argv += ["--px-um", "0.2"]
    if cmd in ("fa", "fa-tune"):
        argv += ["--roi-dir", str(tmp_path)]
    err = _refused(tmp_path, argv, SystemExit)
    assert "torch.cuda.is_available() is False" in str(err.code)
    assert "--device cpu" in str(err.code)
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------ the apps

def _scripted_show(monkeypatch, plt, script):
    """``plt.show`` replaced by *script*'s events on the figure it would show:
    ("key", k, (x, y) or None) or ("click", (x, y)), at data coordinates of
    the figure's first axes."""
    from matplotlib.backend_bases import KeyEvent, MouseEvent

    def show(*a, **k):
        fig = plt.gcf()
        ax = fig.axes[0]
        for ev in script:
            xy = ev[-1]
            px, py = ax.transData.transform(xy) if xy is not None else (1.0, 1.0)
            if ev[0] == "key":
                e = KeyEvent("key_press_event", fig.canvas, ev[1], px, py)
            else:
                e = MouseEvent("button_press_event", fig.canvas, px, py, button=1)
            fig.canvas.callbacks.process(e.name, e)
        plt.close("all")

    monkeypatch.setattr(plt, "show", show)


def _app_folder(root):
    """Two stages of two channels (a 120 x 160 u16 frame with two blobs),
    S01 with a saved bundle of two ROIs, S02 without; for fa-tune the
    channel-0 frames and the ROI JSONs of both stages."""
    import numpy as np

    from imageprocess_tpu_torch.core import roiio, tiffio

    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:120, 0:160]
    polys = [np.array([[40.5, 30.5], [100.5, 32.5], [98.5, 90.5], [42.5, 88.5]]),
             np.array([[110.5, 10.5], [150.5, 12.5], [148.5, 50.5], [112.5, 48.5]])]
    for s in (1, 2):
        img = rng.normal(500, 30, (120, 160))
        for cy, cx in ((60, 70), (45, 55), (30, 130)):
            img += 3000 * np.exp(-((yy - cy - s) ** 2 + (xx - cx) ** 2) / 80.0)
        for ch in (0, 1, 2):
            tiffio.write_tiff16(str(root / f"S0{s}_{ch}.TIF"),
                                (img * (1 + ch)).clip(0, 65535).astype(np.uint16))
        roiio.save_roi_bundle(str(root / "rois" / f"S0{s}.json"), f"S0{s}", (120, 160), polys)
    roiio.save_roi_bundle(str(root / "roi" / "S01.json"), "S01", (120, 160), polys,
                          view_params={"gamma": 0.8, "last_channel": 2})


APP_CASES = {  # id: (argv after the folder, the scripted events)
    "draw-delete-and-view": (["draw", "{d}"], [
        ("key", "x", (120.0, 20.0)), ("key", "i", None), ("key", "o", None),
        ("key", "b", None), ("key", "shift+tab", None), ("key", "q", None)]),
    "draw-redraw-at-cursor": (["draw", "{d}", "--lang", "ko"], [
        ("key", "r", (70.0, 60.0)), ("key", "w", None)]),
    "fa-tune-click-and-save": (
        ["fa-tune", "{d}", "--roi-dir", "{d}/rois", "--out", "{o}", "--alpha", "2.5"],
        [("click", (70.0, 60.0)), ("key", "+", None), ("key", "z", None),
         ("key", "s", None), ("key", "q", None)]),
    "fa-tune-boost-and-save": (
        ["fa-tune", "{d}", "--roi-dir", "{d}/rois", "--out", "{o}", "--px-size", "0.2",
         "--channel", "0"],
        [("key", "-", None), ("key", "m", None), ("click", (5.0, 5.0)), ("key", "s", None)]),
}


@pytest.mark.parametrize("case", list(APP_CASES))
def test_apps_run_through_the_cli(case, tmp_path, monkeypatch, capsys):
    """``draw`` and ``fa-tune`` through ``cli.main`` with ``--device cpu``,
    each window driven by the same scripted events as the JAX CLI's: the
    saved files equal JAX's (bundle JSON, mask, overlay and zip entries;
    the tuner's CSVs cell for cell), the run's lines too."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    from test_torch_fa import _assert_csv_match
    from test_torch_refine import _assert_bundles_equal, _bundle_files

    argv, script = APP_CASES[case]
    _scripted_show(monkeypatch, plt, script)
    out = {}
    for name, mod, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        _app_folder(d)
        rc = mod.main([a.format(d=d, o=d / "out") for a in argv] + dev)
        lines = [s.replace(str(d), "<d>") for s in capsys.readouterr().out.splitlines()]
        out[name] = (rc, d, lines)
    (jrc, jd, jlines), (trc, td, tlines) = out["j"], out["t"]
    assert jrc == trc == 0
    assert tlines == jlines
    if argv[0] == "draw":
        # S01 had a bundle, which closing rewrites; S02 drew nothing: no bundle
        assert sorted(os.listdir(td / "roi")) == sorted(os.listdir(jd / "roi")) == \
            ["S01.json", "mask", "overlay", "zip"]
        _assert_bundles_equal(_bundle_files(str(td / "roi")), _bundle_files(str(jd / "roi")))
    else:
        indiv = ("out", "individual_results")
        names = sorted(os.listdir(td.joinpath(*indiv)))
        assert names == sorted(os.listdir(jd.joinpath(*indiv))) == \
            ["S01_results.csv", "S02_results.csv"]
        for n in names:
            _assert_csv_match(str(td.joinpath(*indiv, n)), str(jd.joinpath(*indiv, n)))


FA_FIGS = [os.path.join("fig", "S01_FA.png")]
FA_CROPS = [os.path.join("crops_export", "S01", f"Cell_{c}.png") for c in (1, 2)]


@pytest.fixture(scope="module")
def figure_ds(tmp_path_factory):
    """One FA stage (a 96 x 120 u16 frame with two cells) and one rim-FRET
    pair (channels 1 and 2, two ROIs)."""
    import numpy as np

    from imageprocess_tpu_torch.core import roiio, tiffio

    root = tmp_path_factory.mktemp("figs")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:120]
    frame = rng.normal(500, 30, (96, 120))
    for cy, cx in [(30, 30), (60, 85)]:
        frame += 4000.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    cells = [np.array([[10.5, 10.5], [55.5, 12.5], [52.5, 50.5], [12.5, 48.5]]),
             np.array([[62.5, 40.5], [110.5, 42.5], [108.5, 85.5], [64.5, 84.5]])]
    for sub, names in (("fa", ["S01_0.tif"]), ("n2", ["S01_1.TIF", "S01_2.TIF"])):
        (root / sub / "roi").mkdir(parents=True)
        for name in names:
            tiffio.write_tiff16(str(root / sub / name), frame.astype(np.uint16))
        roiio.save_roi_bundle(str(root / sub / "roi" / "S01.json"), "S01", frame.shape,
                              cells)
    return root


@pytest.mark.parametrize("argv, files", [
    (["nesprin2", "{n2}", "--donor-ch", "1", "--fret-ch", "2", "--png", "--panel"],
     [os.path.join("PNG", "panel", "S01_panel_FoverD.png")]),
    (["nesprin2", "{n2}", "--donor-ch", "1", "--fret-ch", "2", "--png", "--panel",
      "--batched"], [os.path.join("PNG", "panel", "S01_panel_FoverD.png")]),
    (["fa", "{fa}", "--roi-dir", "{fa}/roi", "--figs"], FA_FIGS),
    (["fa", "{fa}", "--roi-dir", "{fa}/roi", "--export-crops"], FA_CROPS),
    (["fa", "{fa}", "--roi-dir", "{fa}/roi", "--figs", "--export-crops", "--batched"],
     FA_FIGS + FA_CROPS),
], ids=["nesprin2-panel", "nesprin2-panel-batched", "fa-figs", "fa-export-crops",
        "fa-figs-crops-batched"])
def test_figure_flags_write_the_jax_files(figure_ds, tmp_path, argv, files):
    """``nesprin2 --png --panel``, ``fa --figs`` and ``fa --export-crops``
    run after the tables and write the JAX CLI's files under its names
    (tests/test_torch_figures.py holds their pixels to JAX's)."""
    from test_torch_tiffout import png_files

    out = tmp_path / "out"
    argv = [a.format(n2=figure_ds / "n2", fa=figure_ds / "fa") for a in argv]
    assert tcli.main(argv + ["--out", str(out), "--device", "cpu", "--lang", "en"]) == 0
    pngs = png_files(out)
    assert all(f in pngs for f in files), (files, pngs)
    if argv[0] == "fa":
        assert [p for p in pngs if not p.startswith("PNG")] == sorted(files)
        assert (out / "individual_results").is_dir()
    else:
        assert sum(p.startswith(os.path.join("PNG", "panel")) for p in pngs) == 1


def test_fa_figure_flags_write_the_jax_clis_files(figure_ds, tmp_path):
    """``fa --figs --export-crops``: the same PNG names and count as the JAX
    CLI's run on the same input (the rim-FRET panel's are held in
    tests/test_torch_figures.py)."""
    from test_torch_tiffout import png_files

    argv = ["fa", str(figure_ds / "fa"), "--roi-dir", str(figure_ds / "fa" / "roi"),
            "--figs", "--export-crops", "--lang", "en"]
    assert jcli.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert tcli.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert png_files(tmp_path / "t") == png_files(tmp_path / "j") == sorted(FA_FIGS + FA_CROPS)


def test_cli_docs_are_fresh(monkeypatch):
    """docs/CLI_torch.md is generated from the port's argparse tree; a flag
    change without regenerating (python scripts/gen_cli_docs_torch.py)
    fails here.  The generator imports no jax."""
    import ast
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "scripts", "gen_cli_docs_torch.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert not any(m and (m.split(".")[0] in ("jax", "imageprocess_tpu")) for m in mods)
    spec = importlib.util.spec_from_file_location("gen_cli_docs_torch", path)
    mod = importlib.util.module_from_spec(spec)
    # argparse wraps help to $COLUMNS: pin it so the comparison is stable
    # (render() itself pins the i18n language, which other tests mutate)
    monkeypatch.setenv("COLUMNS", "80")
    spec.loader.exec_module(mod)
    with open(os.path.join(root, "docs", "CLI_torch.md")) as f:
        assert f.read() == mod.render()


def test_devices_2_on_the_cpu_exits_1(tmp_path, capsys):
    """``--devices 2 --device cpu``: exit 1 with the reference's line, as
    JAX on one CPU device, before a file appears."""
    rc = tcli.main(["intensity", str(tmp_path), "--batched", "--devices", "2",
                    "--device", "cpu", "--out", str(tmp_path / "out"), "--lang", "en"])
    assert rc == 1
    assert "[error] --devices 2 > 1 available" in capsys.readouterr().out.splitlines()
    assert not (tmp_path / "out").exists()
