"""Explicit device selection: the port never falls back to the CPU."""

from __future__ import annotations

import contextlib

import torch

def resolve_device(device) -> torch.device:
    """``torch.device`` for *device*; raises when a CUDA device is asked
    for and no card is present (a run on the CPU must be asked for by
    name, as the tests do with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in full float32 on a card (cuDNN
    rounds them to TF32 by default), restoring the flags afterwards."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
