"""The port imports torch and never jax: no port source names ``jax`` or
the ``imageprocess_tpu`` package, nor pandas (at module level or inside a
function), nor matplotlib (but inside a function under
``imageprocess_tpu_torch/apps/``: the interactive apps' windows), nor h5py
at module level (the MATLAB boundary reader imports it inside its
function), none executes a file of that package, and importing its main
paths and the apps pulls in neither jax, flax, PIL, pandas, matplotlib nor
h5py (the card's machine is not promised them)."""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "imageprocess_tpu_torch")
APPS = os.path.join(PORT, "apps", "")


TRAIN_SCRIPT = os.path.join(REPO, "scripts", "train_unet_general_torch.py")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    """(module name, inside a function) of every absolute import."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    in_function = {id(n) for f in ast.walk(tree)
                   if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in in_function) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in in_function


@pytest.mark.parametrize("path", _port_sources() + [TRAIN_SCRIPT],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_import(path):
    for name, in_function in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "imageprocess_tpu",
                           "pandas"), (path, name)
        assert top != "h5py" or in_function, (path, name)
        # the apps' display methods import matplotlib inside the function
        assert top != "matplotlib" or (in_function and path.startswith(APPS)), (path, name)


def test_main_path_import_pulls_in_no_jax_pil_pandas():
    code = (
        "import json, sys\n"
        "import imageprocess_tpu_torch.pipelines.intensity\n"
        "import imageprocess_tpu_torch.parallel.runner\n"
        "import imageprocess_tpu_torch.parallel.spatial\n"
        "import imageprocess_tpu_torch.parallel.dryrun\n"
        "import imageprocess_tpu_torch.ops.tile_stats_kernel\n"
        "import imageprocess_tpu_torch.pipelines.fret\n"
        "import imageprocess_tpu_torch.ops.roi_stats_kernel\n"
        "import imageprocess_tpu_torch.ops.ratio\n"
        "import imageprocess_tpu_torch.ops.background\n"
        "import imageprocess_tpu_torch.core.tiffio\n"
        "import imageprocess_tpu_torch.core.roiio\n"
        "import imageprocess_tpu_torch.core.runlog\n"
        "import imageprocess_tpu_torch.kernels.build\n"
        "import imageprocess_tpu_torch.models.checkpoint\n"
        "import imageprocess_tpu_torch.models.train\n"
        "import imageprocess_tpu_torch.models.golden\n"
        "import imageprocess_tpu_torch.models.synthcells\n"
        "import imageprocess_tpu_torch.morphology.binary\n"
        "import imageprocess_tpu_torch.morphology.ccl\n"
        "import imageprocess_tpu_torch.ops.view\n"
        "import imageprocess_tpu_torch.segment.auto\n"
        "import imageprocess_tpu_torch.segment.cellseg\n"
        "import imageprocess_tpu_torch.segment.flows\n"
        "import imageprocess_tpu_torch.pipelines.fa\n"
        "import imageprocess_tpu_torch.pipelines.nesprin2\n"
        "import imageprocess_tpu_torch.morphology.regions\n"
        "import imageprocess_tpu_torch.report.render\n"
        "import imageprocess_tpu_torch.segment.autoseg\n"
        "import imageprocess_tpu_torch.segment.drawer\n"
        "import imageprocess_tpu_torch.segment.evalseg\n"
        "import imageprocess_tpu_torch.morphology.contours\n"
        "import imageprocess_tpu_torch.report.pptxlite\n"
        "import imageprocess_tpu_torch.pipelines.fretppt\n"
        "import imageprocess_tpu_torch.pipelines.crop\n"
        "import imageprocess_tpu_torch.pipelines.morphology\n"
        "import imageprocess_tpu_torch.report.cmaps\n"
        "import imageprocess_tpu_torch.report.ticks\n"
        "import imageprocess_tpu_torch.timing\n"
        "import imageprocess_tpu_torch.apps.draw\n"
        "import imageprocess_tpu_torch.apps.fa_tune\n"
        "import chip_smoke\n"
        "mods = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'PIL', 'pandas', 'matplotlib', "
        "'h5py', 'imageprocess_tpu')]\n"
        "print(json.dumps(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_training_script_pulls_in_no_jax(tmp_path):
    """The port's training script, loaded and asked to write into the JAX
    package (which it refuses before any work), with the training modules
    imported: no jax, flax, optax, orbax, matplotlib or JAX-package module
    is loaded, and no module from a file under imageprocess_tpu/."""
    code = (
        "import importlib.util, json, os, sys\n"
        "import imageprocess_tpu_torch.models.train\n"
        "import imageprocess_tpu_torch.models.golden\n"
        "import imageprocess_tpu_torch.models.synthcells\n"
        f"spec = importlib.util.spec_from_file_location('train_script', {TRAIN_SCRIPT!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "try:\n"
        "    mod.main([os.path.join('imageprocess_tpu', 'models', 'x'), '--device', 'cpu'])\n"
        "except SystemExit as e:\n"
        "    assert 'refusing' in str(e), e\n"
        "ref = os.path.join(os.getcwd(), 'imageprocess_tpu', '')\n"
        "mods = [m for m, v in sys.modules.items() if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'matplotlib', 'imageprocess_tpu') "
        "or (getattr(v, '__file__', None) or '').startswith(ref)]\n"
        "print(json.dumps(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("argv", [None, ["--help"], ["doctor", "--skip-backend"]],
                         ids=["import", "help", "doctor"])
def test_cli_and_doctor_pull_in_no_jax_and_no_pipeline(argv):
    """Importing ``imageprocess_tpu_torch.cli`` and ``utils.doctor`` (and
    running ``--help`` or ``doctor``) pulls in none of jax, flax, pandas,
    matplotlib, h5py or the JAX package, and loads no pipeline: each
    command imports its runner when it runs."""
    run = "" if argv is None else (
        "try:\n"
        f"    imageprocess_tpu_torch.cli.main({argv!r})\n"
        "except SystemExit:\n"
        "    pass\n")
    code = (
        "import json, sys\n"
        "import imageprocess_tpu_torch.cli\n"
        "import imageprocess_tpu_torch.utils.doctor\n"
        "import imageprocess_tpu_torch.utils.profiling\n"
        + run +
        "mods = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pandas', 'matplotlib', 'h5py', "
        "'imageprocess_tpu') or m.startswith(('imageprocess_tpu_torch.pipelines', "
        "'imageprocess_tpu_torch.segment'))]\n"
        "print(json.dumps(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_png_outputs_and_the_cropper_run_without_matplotlib(tmp_path):
    """A process in which ``import matplotlib`` fails runs every PNG output
    -- intensity, FRET and rim FRET with ``do_png`` at their defaults (the
    inset colorbar included), rim FRET's 2-up panel, morphology's overlays,
    the cropper, the FA overview figures (with the MATLAB overlay where h5py
    imports) and the FA crop PNGs -- and holds no module of matplotlib, jax
    or the JAX package afterwards."""
    code = (
        "import json, os, sys\n"
        "sys.modules['matplotlib'] = None   # any import of it fails\n"
        "try:\n"
        "    import h5py\n"
        "except ImportError:\n"
        "    h5py = None\n"
        "import numpy as np\n"
        "from imageprocess_tpu_torch.core import roiio, tiffio\n"
        "from imageprocess_tpu_torch.pipelines import crop, fa, fret, intensity, morphology, nesprin2\n"
        f"d = {str(tmp_path)!r}\n"
        "rng = np.random.default_rng(0)\n"
        "for ch in (1, 2):\n"
        "    tiffio.write_tiff16(os.path.join(d, f'S01_{ch}.TIF'),\n"
        "                        rng.integers(10, 3000, (96, 128)).astype(np.uint16))\n"
        "P = np.array([[10.5, 12.5], [60.5, 15.5], [55.5, 70.5], [8.5, 66.5]])\n"
        "roiio.save_roi_bundle(os.path.join(d, 'roi', 'S01.json'), 'S01', (96, 128), [P])\n"
        "q = dict(log=lambda *_: None, device='cpu')\n"
        "intensity.run_intensity(d, intensity.IntensityConfig(channels=(1, 2), do_png=True,\n"
        "    save_raw_crop_tif=True), out_root=os.path.join(d, 'i'), **q)\n"
        "fret.run_fret(d, fret.FretConfig(donor_ch=1, acceptor_ch=2, do_png=True),\n"
        "    out_root=os.path.join(d, 'f'), **q)\n"
        "nesprin2.run_nesprin2(d, nesprin2.Nesprin2Config(donor_ch=1, fret_ch=2, do_png=True,\n"
        "    annulus_on=True, save_panel=True), out_root=os.path.join(d, 'n'), **q)\n"
        "morphology.run_morphology(d, morphology.MorConfig(sel_ch=2),\n"
        "    out_root=os.path.join(d, 'm'), **q)\n"
        "crop.run_crop(d, os.path.join(d, 'roi'), os.path.join(d, 'c'),\n"
        "    crop.CropConfig(channel=2, save_tiff16=True), **q)\n"
        "mat = None\n"
        "if h5py is not None:\n"
        "    mat = os.path.join(d, 'mat')\n"
        "    os.makedirs(mat)\n"
        "    with h5py.File(os.path.join(mat, 'BNDb_e1s1.mat'), 'w') as f:\n"
        "        r = f.create_group('#refs#')\n"
        "        ref = r.create_dataset('c0', data=P[:, [1, 0]].T).ref\n"
        "        cell = r.create_dataset('cell0',\n"
        "                                data=np.array([ref], dtype=h5py.ref_dtype)[:, None])\n"
        "        f.create_dataset('bdokcc', data=np.array([cell.ref], dtype=h5py.ref_dtype)[:, None])\n"
        "cfg = fa.FaConfig(channel=2, alpha=1.0)\n"
        "fa.save_fa_figs(d, os.path.join(d, 'roi'), os.path.join(d, 'a'), cfg,\n"
        "    mat_dir=mat, **q)\n"
        "fa.export_fa_crops(d, os.path.join(d, 'roi'), os.path.join(d, 'a'), cfg, **q)\n"
        "pngs = {k: sum(f.endswith('.png') for _, _, fs in os.walk(os.path.join(d, k))\n"
        "               for f in fs) for k in 'ifnmca'}\n"
        "mods = [m for m, mod in sys.modules.items() if mod is not None and\n"
        "        m.split('.')[0] in ('matplotlib', 'jax', 'jaxlib', 'imageprocess_tpu')]\n"
        "print(json.dumps([pngs, mods, mat is not None]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    pngs, mods, with_mat = json.loads(res.stdout.strip().splitlines()[-1])
    assert mods == []
    assert pngs == {"i": 4, "f": 2, "n": 6, "m": 2, "c": 1, "a": 2}
    assert with_mat == (importlib.util.find_spec("h5py") is not None)


# string constants that name the JAX package as a path: "imageprocess_tpu"
# as a path component, or a path starting with "imageprocess_tpu/"
_REF_PATH = re.compile(r"^imageprocess_tpu(?:$|[/\\])")
_LOADERS = ("spec_from_file_location", "SourceFileLoader", "run_path",
            "exec_module")


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_file_of_the_reference_package_is_executed(path):
    """No port source and not chip_smoke.py loads a module from a file
    path, and none builds a path into imageprocess_tpu/ other than the
    bundled checkpoints (data read by models/checkpoint.py)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for word in _LOADERS:
        assert word not in text, (path, word)
    tree = ast.parse(text, path)
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        args = [a.value if isinstance(a, ast.Constant) else None for a in node.args]
        for i, a in enumerate(args):
            if isinstance(a, str) and id(node.args[i]) not in docs and _REF_PATH.match(a):
                rest = [x for x in args[i:] if isinstance(x, str)]
                joined = "/".join(rest).replace("\\", "/")
                assert joined.startswith("imageprocess_tpu/models/pretrained"), (
                    path, node.lineno, rest)


def test_main_paths_load_no_reference_file_and_build_outside_it(tmp_path):
    """A process that imports every main path and decodes a TIFF for the
    first time (the decoder built from scratch) holds no module whose file
    lies under imageprocess_tpu/, and writes nothing of its own there: the
    decoder and its temp file (both named libiptiff_<hash>...) land in the
    port's build folder.  (The JAX binding, which other tests may build
    meanwhile, writes its own ``libiptiff.so`` into imageprocess_tpu/native/;
    only the port's names are looked for.)"""
    ref = os.path.join(REPO, "imageprocess_tpu")
    build_dir = str(tmp_path / "build")

    def port_files():
        return sorted(os.path.join(d, n) for d, _, names in os.walk(ref)
                      for n in names if n.startswith("libiptiff_"))

    before = port_files()
    code = (
        "import json, os, sys\n"
        "import numpy as np\n"
        "import chip_smoke\n"
        "import imageprocess_tpu_torch.pipelines.intensity\n"
        "import imageprocess_tpu_torch.pipelines.fret\n"
        "import imageprocess_tpu_torch.parallel.runner\n"
        "import imageprocess_tpu_torch.parallel.spatial\n"
        "import imageprocess_tpu_torch.parallel.dryrun\n"
        "import imageprocess_tpu_torch.segment.auto\n"
        "import imageprocess_tpu_torch.segment.cellseg\n"
        "import imageprocess_tpu_torch.models.synthcells\n"
        "import imageprocess_tpu_torch.report.excel\n"
        "from imageprocess_tpu_torch import native\n"
        f"native.BUILD_DIR = {build_dir!r}\n"
        "lib = native.library_path()\n"
        "assert not os.path.exists(lib)\n"
        f"p = {str(tmp_path / 'f.tif')!r}\n"
        "img = (np.arange(60 * 70) % 4001).astype(np.uint16).reshape(60, 70)\n"
        "chip_smoke.write_tiff16_deflate(p, img, 16)\n"
        "assert (native.decode_tiff(p) == img).all()\n"
        "assert os.path.exists(lib)\n"
        f"ref = {os.path.join(ref, '')!r}\n"
        "bad = [m for m, mod in list(sys.modules.items())\n"
        "       if (getattr(mod, '__file__', None) or '').startswith(ref)]\n"
        "print(json.dumps([bad, lib]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    bad, lib = json.loads(res.stdout.strip().splitlines()[-1])
    assert bad == []
    assert os.path.dirname(lib) == build_dir
    assert os.path.basename(lib).startswith("libiptiff_")
    assert port_files() == before


def test_chip_smoke_alone_prints_no_result(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo it exits non-zero and prints no result, with or without a card."""
    import shutil

    script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
