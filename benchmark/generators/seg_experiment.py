"""A segmentation experiment from a seed: the frames a lab's automatic ROI
drawer reads, the pixels at which its maps are checked, and the network's
weights.

- The frames are ``tiff_experiment``'s (its ``frame`` and ``rois``
  parameters: one Gaussian body per lattice place gives the field); the
  ROI files it writes beside them are not read.
- ``probes``: that many pixels a stage, drawn from the seed, at which the
  program's maps are compared with the reference's.
- ``weights``: a Cellpose-SAM state dict under Cellpose's own key names,
  of the sizes of the configuration ``weights.config`` (its ``model``),
  float32, every weight, bias, position embedding and relative-position
  table drawn from normal(0, ``weights.sd``), LayerNorm scales 1 and
  shifts 0, ``W2`` Cellpose's identity readout.  It is written as
  ``cpsam.pt`` (``torch.save``) into the experiment's folder, so that
  every run's set-up writes it and the program's set-up reads it, as a
  user's first segmentation loads the published file (here from the page
  cache: the read is warm).

:func:`ensure` returns ``tiff_experiment``'s manifest with ``probes``
({stage: [[y, x], ...]}) and ``checkpoint`` added.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import tiff_experiment

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = "cpsam.pt"


def model_of(config: str) -> dict:
    with open(os.path.join(BENCH_DIR, "configs", config + ".json"), encoding="utf-8") as f:
        return json.load(f)["model"]


def shapes(m: dict) -> dict:
    """{Cellpose key: shape} of a Cellpose-SAM of the sizes *m*."""
    W, p, S, nk = m["width"], m["patch"], m["tile"] // m["patch"], m["neck_dim"]
    hd, mlp, no = m["width"] // m["heads"], m["mlp_dim"], m["nout"] * m["patch"] ** 2
    out = {"encoder.patch_embed.proj.weight": (W, 3, p, p),
           "encoder.patch_embed.proj.bias": (W,), "encoder.pos_embed": (1, S, S, W)}
    for i in range(m["depth"]):
        b = f"encoder.blocks.{i}."
        rows = m["rel_rows_global"] if i in m["global_blocks"] else m["rel_rows_windowed"]
        out.update({b + "norm1.weight": (W,), b + "norm1.bias": (W,),
                    b + "attn.qkv.weight": (3 * W, W), b + "attn.qkv.bias": (3 * W,),
                    b + "attn.proj.weight": (W, W), b + "attn.proj.bias": (W,),
                    b + "attn.rel_pos_h": (rows, hd), b + "attn.rel_pos_w": (rows, hd),
                    b + "norm2.weight": (W,), b + "norm2.bias": (W,),
                    b + "mlp.lin1.weight": (mlp, W), b + "mlp.lin1.bias": (mlp,),
                    b + "mlp.lin2.weight": (W, mlp), b + "mlp.lin2.bias": (W,)})
    out.update({"encoder.neck.0.weight": (nk, W, 1, 1), "encoder.neck.1.weight": (nk,),
                "encoder.neck.1.bias": (nk,), "encoder.neck.2.weight": (nk, nk, 3, 3),
                "encoder.neck.3.weight": (nk,), "encoder.neck.3.bias": (nk,),
                "out.weight": (no, nk, 1, 1), "out.bias": (no,)})
    return out


def state_dict(m: dict, sd: float, seed: int) -> dict:
    """The seeded float32 Cellpose-SAM state dict of the sizes *m*."""
    import torch

    g = torch.Generator().manual_seed(
        int(tiff_experiment.seed_sequence(seed, 7).generate_state(1, np.uint64)[0]))
    out = {}
    for k, shape in shapes(m).items():
        if ".norm" in k or k.startswith("encoder.neck.1.") or k.startswith("encoder.neck.3."):
            out[k] = torch.full(shape, 1.0 if k.endswith("weight") else 0.0)
        else:
            out[k] = torch.randn(shape, generator=g).mul_(sd)
    no = m["nout"] * m["patch"] ** 2
    out["W2"] = torch.eye(no).reshape(no, m["nout"], m["patch"], m["patch"])
    out["diam_labels"] = torch.tensor([30.0])
    out["diam_mean"] = torch.tensor([30.0])
    return out


def ensure(params: dict, seed: int, root: str) -> dict:
    import torch

    exp = tiff_experiment.ensure(params, seed, root)
    H, W = exp["shape"]
    rng = np.random.default_rng(tiff_experiment.seed_sequence(seed, 5))
    n = int(params["probes"])
    exp["probes"] = {st: np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], 1).tolist()
                     for st in exp["stages"]}
    w = params["weights"]
    path = os.path.join(exp["folder"], CHECKPOINT)
    torch.save(state_dict(model_of(w["config"]), float(w["sd"]), seed), path)
    exp["checkpoint"] = path
    return exp
