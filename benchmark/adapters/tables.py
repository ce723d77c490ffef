"""Adapter of the tables pipelines: one unit of work is one runner call over
the whole experiment, from TIFFs on disk to the XLSX and CSV tables.

The configuration file names the runner per ``runner`` of the traffic
(``"module:function"``), the settings class and its settings, the keyword
arguments of the call, the kernel libraries to load in set-up, the CSV and
XLSX the call writes, and the fields the comparison reads.  Nothing here names one
configuration.
"""

from __future__ import annotations

import collections
import importlib


def _resolve(ref: str):
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


def _settings(cls, settings: dict):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in settings.items()}
    return cls(**kw)


class Adapter:
    def __init__(self, config: dict, traffic: dict, exp: dict, out_dir: str, device: str):
        self.config, self.exp, self.out_dir, self.device = config, exp, out_dir, device
        runner = traffic["runner"]
        self.entry = _resolve(config["entries"][runner])
        self.settings = _settings(_resolve(config["settings_class"]), config["settings"])
        self.kwargs = dict(config["call"].get(runner, {}))
        self.log_tail = collections.deque(maxlen=40)
        H, W = exp["shape"]
        n_ch = len(config["input_channels"])
        self.keys = len(exp["stages"])
        self.pixels = self.keys * n_ch * H * W
        self.rows_expected = sum(len(v) for v in exp["rois"].values())

    def prepare(self) -> None:
        """Build or load the native decoder and, on a card, the kernel
        libraries."""
        import concurrent.futures as cf

        from imageprocess_tpu_torch import native
        from imageprocess_tpu_torch.kernels.build import load_library

        names = self.config.get("kernels", []) if self.device.startswith("cuda") else []
        jobs = [lambda n=n: load_library(n) for n in names]
        jobs.append(native._load)
        with cf.ThreadPoolExecutor(len(jobs)) as ex:
            for f in [ex.submit(j) for j in jobs]:
                f.result()

    def _log(self, *args) -> None:
        self.log_tail.append(" ".join(str(a) for a in args))

    def call(self) -> list:
        """One unit: the runner over the experiment into the out directory."""
        return self.entry(self.exp["folder"], self.settings, out_root=self.out_dir,
                          log=self._log, device=self.device, **self.kwargs)
