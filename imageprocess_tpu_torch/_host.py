"""The jax-free host modules of ``imageprocess_tpu``, loaded by file path.

The port shares the reference's host tier instead of copying it: the
native TIFF decoder (ctypes over ``native/tiff_lzw.cpp``), the filename
grammar, the message catalog, polygon padding and the XLSX writer.  Those
modules import only the standard library and numpy, but their packages do
not: ``imageprocess_tpu/__init__.py`` tries ``import jax``,
``geom/__init__.py`` imports the jax rasterizer, ``core/__init__.py`` pulls
in PIL through ``tiffio``/``roiio`` and ``report/__init__.py`` pulls in
pandas.  A plain ``import imageprocess_tpu.core.naming`` would run all of
those ``__init__``s, so each leaf file is executed on its own with
``importlib.util.spec_from_file_location``.

Each module is registered in ``sys.modules`` under a private name before it
executes: ``@dataclass`` looks its class's module up there, and fails with
``AttributeError: 'NoneType' object has no attribute '__dict__'`` without
it.  The private names keep these module objects apart from the JAX
package's own (a process may import both, as the parity tests do).
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading
from types import ModuleType

_REF_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "imageprocess_tpu")
_lock = threading.Lock()


def _load(name: str, relpath: str) -> ModuleType:
    full = f"imageprocess_tpu_torch._host.{name}"
    with _lock:
        mod = sys.modules.get(full)
        if mod is not None:
            return mod
        spec = importlib.util.spec_from_file_location(
            full, os.path.join(_REF_ROOT, relpath))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[full]
            raise
        return mod


native = _load("native", os.path.join("native", "__init__.py"))
naming = _load("naming", os.path.join("core", "naming.py"))
i18n = _load("i18n", os.path.join("core", "i18n.py"))
polygon = _load("polygon", os.path.join("geom", "polygon.py"))
xlsxlite = _load("xlsxlite", os.path.join("report", "xlsxlite.py"))
