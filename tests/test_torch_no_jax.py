"""The port imports torch and never jax: no port source names ``jax`` or
the ``imageprocess_tpu`` package, and importing its main path pulls in
neither jax, PIL nor pandas (the card's machine is not promised them)."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "imageprocess_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "imageprocess_tpu"), (
            path, name)


def test_main_path_import_pulls_in_no_jax_pil_pandas():
    code = (
        "import json, sys\n"
        "import imageprocess_tpu_torch.pipelines.intensity\n"
        "import imageprocess_tpu_torch.parallel.runner\n"
        "import imageprocess_tpu_torch.ops.tile_stats_kernel\n"
        "import imageprocess_tpu_torch.kernels.build\n"
        "import chip_smoke\n"
        "mods = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'PIL', 'pandas', 'matplotlib', 'imageprocess_tpu')]\n"
        "print(json.dumps(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_host_leaf_modules_load_by_path():
    """The shared host modules are executed from the reference's files
    under private names, and dataclasses in them work."""
    from imageprocess_tpu_torch import _host

    for name in ("native", "naming", "i18n", "polygon", "xlsxlite"):
        mod = getattr(_host, name)
        assert sys.modules[mod.__name__] is mod
        assert mod.__file__.startswith(os.path.join(REPO, "imageprocess_tpu", ""))
        assert not mod.__name__.startswith("imageprocess_tpu.")
    key = _host.naming.parse_tokens("S03_t02_2.TIF", timelapse=True)
    assert (key.stage, key.time, key.channel) == (3, 2, 2)


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
