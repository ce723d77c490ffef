"""U-Net for fluorescence cell segmentation (port of
``imageprocess_tpu/models/unet.py``), NCHW inside.

The arithmetic follows the flax module step by step, because the bundled
checkpoints were trained there and the port must give their logits:

- each 3x3 convolution runs in ``dtype`` (bf16 by default) on the input
  and kernel cast to it, and its bias is added afterwards as a separate
  ``dtype`` op, as ``flax.linen.Conv`` does (folding the bias into the
  convolution doubled the bf16 error against JAX);
- GroupNorm runs in float32 with ``min(8, features)`` groups and eps 1e-6,
  flax's default (torch's 1e-5 gives a 12x larger f32 error);
- the up-sampling is the unflipped fractional-stride convolution of
  ``nn.ConvTranspose(transpose_kernel=False)``: ``checkpoint.params_from_flax``
  flips its kernels spatially for ``F.conv_transpose2d``;
- ``[up (dtype), skip (float32)]`` concatenates to float32;
- the 1x1 head runs in float32.  On a card, ``forward_tiles`` turns TF32
  off around the forward so that this head is not rounded to TF32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

GN_EPS = 1e-6  # flax.linen.GroupNorm's default epsilon


def _conv(x: torch.Tensor, conv: nn.Module, dtype, transpose: bool = False):
    """flax's ``Conv``/``ConvTranspose`` with ``dtype`` compute and float32
    params: conv in ``dtype``, then the bias added in ``dtype``."""
    w = conv.weight.to(dtype)
    x = x.to(dtype)
    if transpose:
        y = F.conv_transpose2d(x, w, None, stride=2)
    else:
        y = F.conv2d(x, w, None, padding=conv.padding)
    return y + conv.bias.to(dtype)[:, None, None]


class ConvBlock(nn.Module):
    """Two (3x3 conv -> GroupNorm (f32) -> ReLU); returns float32."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        groups = min(8, features)
        self.conv0 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.gn0 = nn.GroupNorm(groups, features, eps=GN_EPS)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.gn1 = nn.GroupNorm(groups, features, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, gn in ((self.conv0, self.gn0), (self.conv1, self.gn1)):
            x = F.relu(gn(_conv(x, conv, self.dtype).float()))
        return x


class UNet(nn.Module):
    """Encoder-decoder with skip connections: (B, 1, H, W) -> (B, 3, H, W)
    float32; channel 0 = cell probability logit, channels 1..2 = y/x flow
    maps.  H and W must be divisible by 2**len(features)."""

    def __init__(self, features: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 3, in_channels: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.dtype = dtype
        chans = (in_channels,) + self.features
        self.down = nn.ModuleList(
            ConvBlock(chans[i], f, dtype) for i, f in enumerate(self.features))
        self.bottleneck = ConvBlock(self.features[-1], 2 * self.features[-1],
                                    dtype)
        rev = self.features[::-1]
        ups_in = (2 * self.features[-1],) + rev[:-1]
        self.up = nn.ModuleList(
            nn.ConvTranspose2d(c, f, 2, stride=2) for c, f in zip(ups_in, rev))
        self.dec = nn.ModuleList(ConvBlock(2 * f, f, dtype) for f in rev)
        self.head = nn.Conv2d(self.features[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottleneck(x)
        for up, block, skip in zip(self.up, self.dec, reversed(skips)):
            x = _conv(x, up, self.dtype, transpose=True)
            x = block(torch.cat([x.float(), skip], 1))
        return _conv(x, self.head, torch.float32)
