"""U-Net checkpoints carried across from flax (numpy only).

A bundled checkpoint is a directory with ``config.json`` (``features``,
``tile``) and ``params.npz``, whose keys are the flax params paths as
``jax.tree_util.keystr`` writes them, e.g.
``['params']['ConvBlock_0']['Conv_0']['kernel']``.

flax names the UNet's submodules in call order: ``ConvBlock_0`` ..
``ConvBlock_{n-1}`` are the encoder, ``ConvBlock_n`` the bottleneck and the
rest the decoder; ``ConvTranspose_j`` are the up-samplings and ``Conv_0``
the 1x1 head.  Kernels map HWIO -> OIHW; ConvTranspose kernels are flipped
spatially and map to torch's (in, out, kh, kw), because flax's
``transpose_kernel=False`` convolution is the unflipped one.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .unet import UNet

_KEY = re.compile(r"\['([^']+)'\]")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    """{path tuple: array} of a nested params dict, or of the npz dict of
    ``keystr`` keys; a leading ``params`` collection is dropped."""
    out = {}
    for k, v in tree.items():
        path = prefix + (tuple(_KEY.findall(k)) or (k,))
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    if not prefix:
        out = {p[1:] if p[0] == "params" else p: v for p, v in out.items()}
    return out


def _block_name(i: int, n_levels: int) -> str:
    if i < n_levels:
        return f"down.{i}"
    if i == n_levels:
        return "bottleneck"
    return f"dec.{i - n_levels - 1}"


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The port's ``UNet`` state_dict from a flax UNet params tree (numpy
    arrays, with or without the ``params`` collection) or from the npz dict
    of a bundled checkpoint."""
    flat = _flatten(dict(tree))
    n_levels = sum(1 for p in flat
                   if p[0].startswith("ConvTranspose_") and p[1] == "kernel")
    sd = {}
    for path, arr in flat.items():
        mod, leaf = path[0], path[-1]
        a = np.asarray(arr, np.float32)
        if mod.startswith("ConvBlock_"):
            base = _block_name(int(mod.split("_")[1]), n_levels)
            sub, idx = path[1].split("_")
            name = f"{base}.{'conv' if sub == 'Conv' else 'gn'}{idx}"
        elif mod.startswith("ConvTranspose_"):
            name = f"up.{mod.split('_')[1]}"
            if leaf == "kernel":
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif mod == "Conv_0":
            name = "head"
        else:
            raise KeyError(f"unexpected U-Net parameter {path}")
        if leaf == "kernel" and not mod.startswith("ConvTranspose_"):
            a = a.transpose(3, 2, 0, 1)
        key = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
        sd[f"{name}.{key}"] = torch.from_numpy(np.array(a, np.float32))
    return sd


def load_unet(ckpt_dir: str, dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[UNet, int]:
    """(UNet in eval mode on the CPU, inference tile) of a checkpoint
    directory; raises when ``config.json`` or ``params.npz`` is missing."""
    with open(os.path.join(ckpt_dir, "config.json"), encoding="utf-8") as f:
        meta = json.load(f)
    model = UNet(features=tuple(meta["features"]), dtype=dtype)
    with np.load(os.path.join(ckpt_dir, "params.npz")) as data:
        sd = params_from_flax({k: data[k] for k in data.files})
    model.load_state_dict(sd)
    return model.eval(), int(meta.get("tile", 128))
