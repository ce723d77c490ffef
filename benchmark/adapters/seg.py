"""Adapter of the segmentation path: one unit of work is the experiment's
frames, each read from its TIFF (``core.tiffio.read_2d``, as ``roi-auto``
reads it) and turned into its stitched network maps by the configuration's
entry (``segment.cellseg.frame_maps``), then the maps' values at the
experiment's probe pixels fetched and written as a CSV.

A row holds ``prob`` and the flows as ``exp_dy = exp(dy)`` and ``exp_dx =
exp(dx)``: the comparison's relative gap of exp(v) is |got - want| of v to
first order, the flow's absolute error in the unit length of Cellpose's
flow targets.  A flow's relative error where it is near 0 long measures
nothing but that length; the probability lies in (0, 1) and its relative
error is bounded by the logit's absolute error.

The unit ends at the maps: labels and polygons follow the maps of trained
weights, and the run's weights are seeded (the configuration's
``assumed``).  Each call has its own ``seg_phases()``; the read and the
fetch are its ``seg_read`` and ``seg_fetch`` phases, the rest the entry's.
"""

from __future__ import annotations

import collections
import csv
import importlib
import os

import numpy as np

FIELDS = ("prob", "exp_dy", "exp_dx")


def _resolve(ref: str):
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


class Adapter:
    def __init__(self, config: dict, traffic: dict, exp: dict, out_dir: str, device: str):
        from imageprocess_tpu_torch.core import tiffio
        from imageprocess_tpu_torch.models.checkpoint import load_cpsam
        from imageprocess_tpu_torch.segment.cellseg import seg_phases

        self.config, self.exp, self.out_dir, self.device = config, exp, out_dir, device
        self.entry = _resolve(config["entries"][traffic["runner"]])
        self.kwargs = dict(config["call"].get(traffic["runner"], {}))
        self.overlap = config["settings"]["overlap"]
        self.cull_margin = config["settings"]["cull_margin"]
        self.read, self.load, self.phases = tiffio.read_2d, load_cpsam, seg_phases
        self.log_tail = collections.deque(maxlen=40)
        H, W = exp["shape"]
        (self.channel,) = config["input_channels"]
        self.keys = len(exp["stages"])
        self.pixels = self.keys * H * W
        self.rows_expected = sum(len(p) for p in exp["probes"].values())
        self.model = None

    def prepare(self) -> None:
        """The native decoder, the network from the experiment's checkpoint
        on the device, and the probes' indices there."""
        import torch

        from imageprocess_tpu_torch import native

        native._load()
        model, self.tile = self.load(self.exp["checkpoint"])
        self.model = model.to(self.device)
        self.probes = {st: torch.tensor(p, device=self.device).T
                       for st, p in self.exp["probes"].items()}

    def call(self) -> list:
        ph = self.phases()
        rows = []
        for st in self.exp["stages"]:
            with ph("seg_read"):
                img = self.read(os.path.join(self.exp["folder"], f"{st}_{self.channel}.TIF"))
            maps = self.entry(img, self.model, self.tile, self.overlap, self.cull_margin,
                              device=self.device, phases=ph, **self.kwargs)
            if maps is None:
                raise RuntimeError(f"{st}: every tile culled")
            with ph("seg_fetch"):
                py, px = self.probes[st]
                vals = maps[:, py, px].cpu().numpy().astype(np.float64)
            vals[1:] = np.exp(vals[1:])
            rows += [{"stage": st, "roi": k, **dict(zip(FIELDS, map(float, vals[:, k])))}
                     for k in range(vals.shape[1])]
        ph.report()
        path = os.path.join(self.out_dir, self.config["csv"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(("stage", "roi") + FIELDS)
            w.writerows((r["stage"], r["roi"], *(repr(r[c]) for c in FIELDS)) for r in rows)
        return rows
