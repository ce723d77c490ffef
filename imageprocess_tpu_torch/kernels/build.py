"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``*.cu`` source here exposes a plain C interface (``extern "C"``), is
compiled for ``sm_90a`` into a shared library under
``imageprocess_tpu_torch/_build/`` at first use, and is loaded with
``ctypes`` — the pattern of the reference's ``native/`` decoder.  No
PyTorch headers are compiled, so a build takes seconds and needs neither
``ninja`` nor ``torch.utils.cpp_extension``.

Flags: ``--fmad=false`` keeps every product a separately rounded
operation, as in the plain PyTorch version (``--use_fast_math`` is never
used).  A library is rebuilt when its source or flags change.

Usage: ``load_library("tilestats_u16")``; the build runs only inside that
call, never when a module is imported.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(KERNEL_DIR), "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register and shared-memory report) per library
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")


def _build(name: str) -> str:
    src = os.path.join(KERNEL_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"could not run nvcc for {src}: {e}") from e
    build_logs[name] = (res.stdout + res.stderr).strip()
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{build_logs[name]}")
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (when needed) and load ``kernels/<name>.cu``; cached per
    process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            _libs[name] = lib
        return lib
