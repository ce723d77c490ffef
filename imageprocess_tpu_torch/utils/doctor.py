"""Environment self-check (``python -m imageprocess_tpu_torch.cli doctor``).

Every check that touches the card runs in a SUBPROCESS under a hard
timeout, so the doctor itself never hangs: a wedged CUDA runtime, a hung first
launch or an ``nvcc`` that never returns is reported as a failed check.

Checks:
  deps       versions of the stack: torch and its CUDA build, numpy, PIL
             with FreeType (the PNG outputs' text), OpenCV (the polygons)
  native     the C++ TIFF tier builds and loads; LZW and deflate decode
             bit-exact against PIL
  numerics   the exact (k, g) percentile and both rasterizer edge rules
  write      atomic write and replace in a temporary directory
  backend    the CUDA probe, under --backend-timeout: a card is present,
             one launch runs, both hand kernels build with nvcc and one
             small launch of each equals its plain PyTorch version
  mesh       skipped: the port runs on one device

``IP_DOCTOR_BACKEND=cpu`` asks the backend probe for one dispatch on the
CPU and nothing more; without it, a machine without a card fails the
probe.  Exit status: 0 when every check that ran passed, 1 otherwise.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Callable, List, Tuple

_OK, _FAIL, _SKIP = "[ok]", "[FAIL]", "[skip]"
#: the directory that holds the package, put on the probe's sys.path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_sub(code: str, timeout: float) -> Tuple[bool, str]:
    """Run a python snippet in a subprocess under a hard timeout.  Returns
    (ok, last_output_line_or_error)."""
    try:
        p = subprocess.run(
            [sys.executable, "-c", code], capture_output=True,
            text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return False, (f"hung (> {timeout:.0f}s) — killed; the first call "
                       "builds both kernels with nvcc — retry with a larger "
                       "--backend-timeout before concluding the card is "
                       "wedged")
    out = (p.stdout or "").strip().splitlines()
    if p.returncode == 0 and out:
        return True, out[-1]
    tail = (p.stderr or "").strip().splitlines()
    return False, tail[-1][:160] if tail else f"exit {p.returncode}"


def _check_deps() -> Tuple[bool, str]:
    import cv2
    import numpy
    import PIL
    import torch
    from PIL import features

    if not features.check("freetype2"):
        return False, f"pillow {PIL.__version__} lacks FreeType (the PNG text)"
    return True, (
        f"torch {torch.__version__} (CUDA {torch.version.cuda or 'none'}), "
        f"numpy {numpy.__version__}, pillow {PIL.__version__} with FreeType "
        f"{features.version('freetype2')}, opencv {cv2.__version__}"
    )


def _check_native() -> Tuple[bool, str]:
    import time

    import numpy as np
    from PIL import Image

    from ..native import decode_tiff

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 65536, (512, 640)).astype(np.uint16)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.tif")
        Image.fromarray(arr).save(p, format="TIFF", compression="tiff_lzw")
        # untimed warm-up: the first call may include the one-time g++
        # build of the decoder
        if decode_tiff(p) is None:
            return False, "native decoder unavailable (build failed?)"
        t0 = time.perf_counter()
        got = decode_tiff(p)
        dt = time.perf_counter() - t0
        if got is None:
            return False, "native decoder unavailable (build failed?)"
        if not np.array_equal(got, arr):
            return False, "LZW decode mismatch vs PIL"
        # the deflate path exercises the zlib link
        p2 = os.path.join(d, "t2.tif")
        Image.fromarray(arr).save(p2, format="TIFF",
                                  compression="tiff_adobe_deflate")
        got2 = decode_tiff(p2)
        if got2 is None or not np.array_equal(got2, arr):
            return False, "deflate decode mismatch (zlib link?)"
    return True, f"LZW+deflate bit-exact vs PIL ({arr.size / dt / 1e6:.0f} Mpix/s single-frame)"


def _check_numerics() -> Tuple[bool, str]:
    import numpy as np

    from ..geom.rasterize import EdgeRule, rasterize_polygon_np
    from ..native import u16_percentile_strided
    from ..ops.percentile import p1000_of

    rng = np.random.default_rng(1)
    vals = rng.integers(0, 65536, (317, 317)).astype(np.uint16)
    for q in (1.0, 25.0, 99.5):
        want = np.percentile(vals.ravel().astype(np.float64), q)
        got = u16_percentile_strided(vals, 1, p1000_of(q))
        if abs(got - want) > 1e-9 * max(1.0, abs(want)):
            return False, f"percentile({q}) {got} != {want}"
    poly = np.array([[1.0, 1.0], [6.0, 1.0], [6.0, 5.0], [1.0, 5.0]])
    areas = {rule: int(rasterize_polygon_np(poly, (8, 8), rule=rule).sum())
             for rule in (EdgeRule.MPL, EdgeRule.PNPOLY)}
    # integer-corner rect: MPL includes both edges (6x4=24 at these
    # half-open thresholds), PNPOLY the half-open 5x4=20
    if areas[EdgeRule.MPL] != 24 or areas[EdgeRule.PNPOLY] != 20:
        return False, f"rasterizer edge rule drift ({areas})"
    return True, "exact percentile + both rasterizer edge rules"


def _check_write() -> Tuple[bool, str]:
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.txt")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            f.write("ok")
        os.replace(tmp, p)
        with open(p) as f:
            if f.read() != "ok":
                return False, "read-back mismatch"
    return True, "atomic write/replace"


_EXACT, _MOMENTS = (1, 3, 4, 5, 6, 8), (0, 2, 7)  # the nine statistics' order


def _held_to_plain(got, want, what: str) -> float:
    """Kernel vs plain statistics (the statistic on the last axis): the
    order statistics, extrema and counts equal, the moments within 1e-5
    relative.  Returns the moments' largest relative difference."""
    import torch

    g, w = got.double().cpu(), want.double().cpu()
    if not torch.equal(g[..., list(_EXACT)], w[..., list(_EXACT)]):
        raise RuntimeError(f"{what}: order statistics differ from the plain version")
    gm, wm = g[..., list(_MOMENTS)], w[..., list(_MOMENTS)]
    rel = ((gm - wm).abs() / wm.abs().clamp(min=1e-9)).max().item()
    if not rel <= 1e-5:
        raise RuntimeError(f"{what}: moments differ by {rel:.2e} relative")
    return rel


def _probe_kernels() -> float:
    """One small launch of each hand kernel on the card, held to its plain
    version on the same tensors."""
    import torch

    from ..ops import roi_stats_kernel as rsk
    from ..ops import tile_stats_kernel as tsk

    gen = torch.Generator().manual_seed(0)
    B, N, C, t = 2, 3, 2, 64
    tiles = torch.randint(0, 65536, (B, N, C, t, t), generator=gen,
                          dtype=torch.int32).to(torch.uint16).cuda()
    square = torch.tensor([[4.5, 6.5], [50.5, 4.5], [56.5, 48.5], [8.5, 58.5]])
    polys = square.expand(B, N, 4, 2).contiguous().cuda()
    valid = torch.ones((B, N), dtype=torch.bool, device="cuda")
    bgs = torch.full((B, C), 100.0, device="cuda")
    # stats are (B, 10, C, N): the statistic moves to the last axis
    rel = _held_to_plain(
        tsk.tile_stats_packed(tiles, polys, valid, bgs).movedim(1, -1),
        tsk.tile_stats_packed_plain(tiles, polys, valid, bgs).movedim(1, -1),
        "tilestats_u16")
    frames = (torch.rand((1, C, 96, 128), generator=gen) * 4000 - 50).cuda()
    masks = tsk.tile_masks(polys[:1], valid[:1], t)[0]           # (N, t, t)
    offs = torch.tensor([[0, 0, 0], [0, 17, 33], [0, 32, 64]],
                        dtype=torch.int32, device="cuda")
    rel = max(rel, _held_to_plain(rsk.roi_stat_rows(frames, masks, offs),
                                  rsk.roi_stat_rows_plain(frames, masks, offs),
                                  "roistats_f32"))
    torch.cuda.synchronize()
    return rel


def backend_probe(forced: str = "") -> None:
    """The ``backend`` check, run inside its subprocess; prints one line,
    or raises.  *forced* (``IP_DOCTOR_BACKEND``) other than ``cuda`` asks
    for one dispatch on that device and nothing more."""
    import torch

    if forced and forced != "cuda":
        dev = torch.device(forced)
        float(torch.zeros((), device=dev) + 1.0)
        print(f"{dev.type} x1 — dispatch ok (IP_DOCTOR_BACKEND={forced})")
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device found: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, CUDA build {torch.version.cuda})")
    name = torch.cuda.get_device_name(0)
    float(torch.zeros((), device="cuda") + 1.0)
    import concurrent.futures as cf

    from ..kernels.build import load_library

    names = ("tilestats_u16", "roistats_f32")
    with cf.ThreadPoolExecutor(len(names)) as pool:  # one nvcc each
        list(pool.map(load_library, names))
    rel = _probe_kernels()
    print(f"{name} x{torch.cuda.device_count()} — dispatch ok; "
          f"{' and '.join(names)} built, one launch each equal to its plain "
          f"version (moments within {rel:.1e} rel)")


def _backend_code(forced: str) -> str:
    return (f"import sys\nsys.path.insert(0, {_ROOT!r})\n"
            "from imageprocess_tpu_torch.utils.doctor import backend_probe\n"
            f"backend_probe({forced!r})\n")


def run_doctor(backend_timeout: float = 600.0, skip_backend: bool = False,
               log: Callable[[str], None] = print,
               as_json: bool = False) -> int:
    """Run all checks; print one line each (or, with *as_json*, one final
    JSON object); return 0 iff all run checks pass."""
    results: List[Tuple[str, str, str]] = []  # (name, status, detail)

    def record(name: str, status: str, detail: str) -> None:
        results.append((name, status, detail))
        if not as_json:
            tag = {"ok": _OK, "fail": _FAIL, "skip": _SKIP}[status]
            log(f"{tag} {name:8s} {detail}")

    checks: List[Tuple[str, Callable[[], Tuple[bool, str]]]] = [
        ("deps", _check_deps),
        ("native", _check_native),
        ("numerics", _check_numerics),
        ("write", _check_write),
    ]
    for name, fn in checks:
        try:
            ok, detail = fn()
        except Exception as e:  # noqa: BLE001 — a crashed check is a FAIL
            ok, detail = False, f"{type(e).__name__}: {e}"
        record(name, "ok" if ok else "fail", detail)

    if skip_backend:
        record("backend", "skip", "(--skip-backend)")
    else:
        ok, detail = _run_sub(
            _backend_code(os.environ.get("IP_DOCTOR_BACKEND", "")),
            timeout=backend_timeout)
        record("backend", "ok" if ok else "fail", detail)

    from ..device import MULTI_DEVICE

    record("mesh", "skip", f"the port runs on one device; {MULTI_DEVICE}")

    failures = sum(1 for _, status, _ in results if status == "fail")
    if as_json:
        import json

        log(json.dumps({
            "ok": failures == 0,
            "failures": failures,
            "checks": {n: {"status": s, "detail": d} for n, s, d in results},
        }))
        return 0 if failures == 0 else 1

    log(("all checks passed" if failures == 0
         else f"{failures} check(s) FAILED"))
    return 0 if failures == 0 else 1
