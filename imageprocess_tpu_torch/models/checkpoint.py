"""U-Net checkpoints in flax's layout, read and written (numpy only), and
Cellpose-SAM state dicts under Cellpose's own names (:func:`load_cpsam`).

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
:func:`params_to_flax` is the exact inverse, so :func:`save_checkpoint`
writes what the JAX package's training script writes and both packages'
loaders read it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .cpsam import CellposeSAM, TileMaps
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


def _block_index(base: str, n_levels: int) -> int:
    """The call-order ``ConvBlock_i`` index of a port block name (the
    inverse of :func:`_block_name`)."""
    if base == "bottleneck":
        return n_levels
    kind, i = base.split(".")
    return int(i) if kind == "down" else n_levels + 1 + int(i)


def params_to_flax(state_dict) -> Dict[str, np.ndarray]:
    """The flax params of the port's ``UNet`` *state_dict*, as the
    ``{keystr: float32 array}`` dict of a checkpoint's ``params.npz``:
    the exact inverse of :func:`params_from_flax`."""
    n_levels = sum(1 for k in state_dict if k.startswith("up.") and k.endswith(".weight"))
    out = {}
    for key, v in state_dict.items():
        name, leaf = key.rsplit(".", 1)
        a = v.detach().cpu().numpy().astype(np.float32, copy=False)
        if name == "head":
            path = ("Conv_0",)
        elif name.startswith("up."):
            path = (f"ConvTranspose_{name.split('.')[1]}",)
        else:
            base, sub = name.rsplit(".", 1)
            i = _block_index(base, n_levels)
            mod = f"{'Conv' if sub.startswith('conv') else 'GroupNorm'}_{sub[-1]}"
            path = (f"ConvBlock_{i}", mod)
        if leaf == "bias":
            flax_leaf = "bias"
        elif path[-1].startswith("GroupNorm"):
            flax_leaf = "scale"
        else:
            flax_leaf = "kernel"
            a = (a.transpose(2, 3, 0, 1)[::-1, ::-1] if name.startswith("up.")
                 else a.transpose(2, 3, 1, 0))
        keystr = "".join(f"['{p}']" for p in ("params",) + path + (flax_leaf,))
        out[keystr] = np.ascontiguousarray(a)
    return out


def save_checkpoint(path: str, model: UNet, config: Mapping) -> None:
    """Write *model* as the generalist training script does: the flax
    params in ``params.npz`` (``np.savez_compressed``) and ``config.json``
    with the model's ``features`` and the fields of *config* (``tile``,
    the inference tile, and the training fields)."""
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "params.npz"),
                        **params_to_flax(model.state_dict()))
    meta = {"features": list(model.features), **dict(config)}
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The ``{keystr: array}`` dict of a checkpoint's ``params.npz`` (what
    :func:`params_from_flax` reads); raises for an orbax checkpoint
    directory, which only the JAX package reads."""
    npz = os.path.join(path, "params.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"{path!r} has no params.npz: an orbax checkpoint is read by the "
            "JAX package only (imageprocess_tpu.models.checkpoint)")
    with np.load(npz) as data:
        return {k: data[k] for k in data.files}


def load_unet(ckpt_dir: str, dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[UNet, int]:
    """(UNet in eval mode on the CPU, inference tile) of a checkpoint
    directory; raises when ``config.json`` or ``params.npz`` is missing."""
    with open(os.path.join(ckpt_dir, "config.json"), encoding="utf-8") as f:
        meta = json.load(f)
    model = UNet(features=tuple(meta["features"]), dtype=dtype)
    model.load_state_dict(params_from_flax(load_checkpoint(ckpt_dir)))
    return model.eval(), int(meta.get("tile", 128))


def cpsam_from_state_dict(sd: Mapping[str, torch.Tensor],
                          dtype: torch.dtype = torch.bfloat16) -> CellposeSAM:
    """A :class:`CellposeSAM` in eval mode on the CPU, in *dtype*, holding
    the Cellpose state dict *sd* (keys ``encoder.*``, ``out.*``, ``W2``,
    ``diam_labels``, ``diam_mean``; a leading ``module.`` is stripped).
    Every size comes from the tensors' shapes: the width and tokens from
    ``pos_embed``, the patch from ``patch_embed``, the head size from the
    relative-position tables (each block's own length, 27 or 127 rows in
    ViT-L), the depth from the block indices.  ``W2`` must be the identity
    (the readout is then a pixel shuffle); ``diam_labels`` and
    ``diam_mean``, Cellpose's size calibration, are not used (no
    rescaling).  Raises ``ValueError`` for another ``W2`` and for missing
    or unexpected keys."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    try:
        _, S, _, width = sd["encoder.pos_embed"].shape
        patch = sd["encoder.patch_embed.proj.weight"].shape[-1]
        depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.blocks."))
        rel_rows = [sd[f"encoder.blocks.{i}.attn.rel_pos_h"].shape[0] for i in range(depth)]
        head_dim = sd["encoder.blocks.0.attn.rel_pos_h"].shape[1]
        with torch.device("meta"):          # no initialisation: every tensor is assigned
            net = CellposeSAM(
                width=width, depth=depth, heads=width // head_dim,
                mlp_dim=sd["encoder.blocks.0.mlp.lin1.weight"].shape[0], patch=patch,
                tile=S * patch, neck_dim=sd["encoder.neck.0.weight"].shape[0],
                nout=sd["out.weight"].shape[0] // patch ** 2, rel_rows=rel_rows)
    except (KeyError, ValueError) as e:
        raise ValueError(f"not a Cellpose-SAM state dict: {e!r}") from e
    no, nout = net.out.out_channels, net.out.out_channels // patch ** 2
    w2 = sd.pop("W2", None)
    eye = torch.eye(no).reshape(no, nout, patch, patch)
    if w2 is not None and not torch.equal(w2.float(), eye):
        raise ValueError("W2 is not the identity readout of Cellpose-SAM")
    sd.pop("diam_labels", None)
    sd.pop("diam_mean", None)
    missing, unexpected = net.load_state_dict(sd, strict=False, assign=True)
    if missing or unexpected:
        raise ValueError(f"Cellpose-SAM state dict: missing {missing}, unexpected {unexpected}")
    return net.to(dtype).eval()


def load_cpsam(path: str, dtype: torch.dtype = torch.bfloat16) -> Tuple[TileMaps, int]:
    """(``TileMaps`` of the Cellpose-SAM network in the ``torch.save``d state
    dict *path*, in eval mode on the CPU, in *dtype*; its tile) -- what
    ``segment.cellseg`` forwards, as :func:`load_unet` gives the U-Net."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = cpsam_from_state_dict(sd, dtype)
    return TileMaps(net).eval(), net.tile
