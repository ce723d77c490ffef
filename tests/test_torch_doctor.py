"""``doctor`` of the port (``imageprocess_tpu_torch.utils.doctor``), as
``tests/test_doctor.py`` holds the JAX one: every check that touches the
card runs in a subprocess under a hard timeout, so the doctor never
hangs.  ``IP_DOCTOR_BACKEND=cpu`` asks the probe for one CPU dispatch;
without it, a machine without a card fails the probe, naming the missing
card.  ``mesh`` holds a sharded reduce and a sharded percentile on a
virtual 4-shard mesh of the probed kind to the unsharded results: ``ok``
or ``fail``, never skipped."""

import json
import time

import pytest
import torch

from imageprocess_tpu_torch import cli as tcli
from imageprocess_tpu_torch.core import i18n as ti18n
from imageprocess_tpu_torch.utils.doctor import _run_sub, backend_probe, mesh_probe, run_doctor

CHECKS = ("deps", "native", "numerics", "write", "backend", "mesh")


@pytest.fixture
def cpu_backend_env(monkeypatch):
    monkeypatch.setenv("IP_DOCTOR_BACKEND", "cpu")


@pytest.fixture(autouse=True)
def _restore_lang():
    yield
    ti18n.set_lang("en")


def test_doctor_all_green_with_the_mesh(cpu_backend_env):
    lines = []
    rc = run_doctor(backend_timeout=240.0, log=lines.append)
    assert rc == 0, lines
    joined = "\n".join(lines)
    for name in CHECKS:
        assert f"[ok] {name}" in joined, joined
    assert "virtual 4-shard cpu mesh + sharded reduce and percentile ok" in joined
    assert "cpu x1" in joined
    assert lines[-1] == "all checks passed"


def test_doctor_skip_backend(cpu_backend_env):
    lines = []
    rc = run_doctor(backend_timeout=240.0, skip_backend=True, log=lines.append)
    assert rc == 0, lines
    assert any(line.startswith("[skip] backend") for line in lines)


def test_doctor_hung_probe_is_killed_not_waited():
    t0 = time.monotonic()
    ok, detail = _run_sub("import time\ntime.sleep(600)\nprint('x')", timeout=3.0)
    assert not ok
    assert "hung" in detail
    assert time.monotonic() - t0 < 30


def test_doctor_failing_probe_reports_error():
    ok, detail = _run_sub("raise RuntimeError('boom')", timeout=30.0)
    assert not ok
    assert "boom" in detail


def test_doctor_cli_json_output(cpu_backend_env, capsys):
    rc = tcli.main(["doctor", "--backend-timeout", "240", "--json", "--lang", "en"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("{"))
    d = json.loads(line)
    assert rc == 0 and d["ok"] and d["failures"] == 0
    assert set(d["checks"]) == set(CHECKS)
    assert {k: v["status"] for k, v in d["checks"].items()} == {k: "ok" for k in CHECKS}


def test_doctor_without_a_card_fails_the_backend(monkeypatch, capsys):
    """No fallback to the CPU: without IP_DOCTOR_BACKEND and without a
    card, ``backend`` and ``mesh`` are [FAIL] and say that no CUDA device
    was found; the exit status is 1."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    monkeypatch.delenv("IP_DOCTOR_BACKEND", raising=False)
    rc = tcli.main(["doctor", "--backend-timeout", "240", "--lang", "en"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 1
    backend = next(ln for ln in lines if "backend" in ln)
    assert backend.startswith("[FAIL] backend") and "no CUDA device found" in backend
    mesh = next(ln for ln in lines if " mesh " in ln)
    assert mesh.startswith("[FAIL] mesh") and "no CUDA device found" in mesh
    assert "2 check(s) FAILED" in lines


@pytest.mark.cuda
def test_backend_probe_on_the_card(capsys):
    """On a card: both kernels build and one launch of each equals its
    plain version; the line names the card and both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    backend_probe()
    line = capsys.readouterr().out.strip()
    assert torch.cuda.get_device_name(0) in line
    assert "tilestats_u16" in line and "roistats_f32" in line
    assert "roistats_f32_frame" in line


@pytest.mark.cuda
def test_mesh_probe_on_the_card(capsys):
    """On a card: the virtual 4-shard mesh of cuda:0 (and a mesh of two
    cards where there are two) passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    mesh_probe()
    assert "virtual 4-shard cuda mesh" in capsys.readouterr().out
