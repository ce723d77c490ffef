"""Cellpose-SAM (``cpsam``): SAM's ViT image encoder with global attention in
every block, its neck, and a pixel-shuffle readout of three maps per pixel.

Pachitariu, Rariden & Stringer, "Cellpose-SAM: superhuman generalization
for cellular segmentation" (bioRxiv 2025); the network is ``Transformer`` in
``cellpose/vit_sam.py`` (Cellpose >= 4.0), whose encoder is the ViT-L of
``segment_anything/modeling/image_encoder.py`` (Kirillov et al. 2023) with
8 x 8 patches and every ``blk.window_size = 0``.  The modules carry
Cellpose's parameter names, so a Cellpose state dict loads as it is
(``checkpoint.load_cpsam``).

For a (B, 3, t, t) input, with S = t / patch tokens a side:

- ``patch_embed.proj`` (a patch x patch convolution of stride patch) and
  ``pos_embed`` give (B, S, S, width) tokens;
- each block: ``t + proj(attention(norm1(t)))``, then ``t + lin2(GELU(lin1(
  norm2(t))))``, LayerNorms of eps 1e-6, GELU by erf; the attention is
  softmax(q k^T / sqrt(head_dim) + rel_h + rel_w) v over all S * S tokens,
  with SAM's decomposed relative-position terms: each table (L, head_dim),
  L = 27 or 127 in ViT-L, is resized to 2S - 1 rows by linear
  interpolation, ``Rh[i, j] = table[i - j + S - 1]``, and ``rel_h =
  einsum("bhwc,hkc->bhwk", q, Rh)`` with the unscaled q (``rel_w`` alike
  over w);
- the neck: 1x1 conv (no bias), LayerNorm2d, 3x3 conv (no bias),
  LayerNorm2d, eps 1e-6;
- ``out``: a 1x1 conv to 3 * patch**2 channels, and Cellpose's
  ``conv_transpose2d`` with the identity ``W2``, which is a pixel shuffle.

The output channels are ``[dY, dX, cellprob]``, the flows scaled by 5 as
Cellpose trains them.

Precision: Cellpose 4 runs this network in bfloat16 (``use_bfloat16``):
bf16 weights and activations, float32 accumulation inside the matmuls,
LayerNorm and softmax.  The port keeps that and, where it is cheaper or
no dearer, more: the relative-position tables are resized in float32 and
rounded once, the two relative terms are summed in float32 and rounded
once into the additive bias that ``F.scaled_dot_product_attention`` adds
to float32 logits (Cellpose rounds the logits to bf16 and adds each term
in bf16), and LayerNorm2d runs in float32.

:class:`TileMaps` is what ``segment.cellseg`` runs: (n, 1, t, t) float32
tiles in, the frame's channel as ``[x, 0, 0]`` (Cellpose's input for one
channel), and float32 ``[cellprob, dY / 5, dX / 5]`` out, the U-Net's
order and flow scale.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6           # SAM's partial(nn.LayerNorm, eps=1e-6) and LayerNorm2d
FLOW_SCALE = 5.0        # Cellpose trains 5 x the unit flow field
GLOBAL_BLOCKS = (5, 11, 17, 23)   # ViT-L's global blocks in SAM: 127-row tables


def rel_pos_rows(depth: int, tokens: int = 64, window: int = 14,
                 global_blocks: Sequence[int] = GLOBAL_BLOCKS) -> list:
    """Rows of each block's relative-position tables as SAM trained them:
    2 * 64 - 1 = 127 for its global blocks (a 1024-px image of 16-px
    patches), 2 * 14 - 1 = 27 for its windowed ones."""
    return [2 * (tokens if i in global_blocks else window) - 1 for i in range(depth)]


def resized_rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """*table* (L, C) resized to (2 * size - 1, C) as SAM's ``get_rel_pos``
    does (``F.interpolate(mode="linear")``, align_corners False), in
    float32, then gathered into (size, size, C) with ``R[i, j] =
    resized[i - j + size - 1]``."""
    rows = 2 * size - 1
    t = table.float()
    if t.shape[0] != rows:
        t = F.interpolate(t.T[None], size=rows, mode="linear")[0].T
    i = torch.arange(size, device=table.device)
    return t[i[:, None] - i[None, :] + size - 1]


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, width, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)          # (B, S, S, width)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int, rel_rows: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        head_dim = width // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_rows, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_rows, head_dim))

    def bias(self, q: torch.Tensor, S: int) -> torch.Tensor:
        """The additive (B, heads, S*S, S*S) relative-position bias of the
        unscaled q (B, heads, S*S, head_dim), in q's dtype."""
        B, h, N, c = q.shape
        rq = q.reshape(B, h, S, S, c)
        rh = resized_rel_pos(self.rel_pos_h, S).to(q.dtype)
        rw = resized_rel_pos(self.rel_pos_w, S).to(q.dtype)
        # einsum's results are permuted views: made contiguous, the broadcast
        # sum below is written in the bias's own layout, which needs no copy
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, rh).contiguous()
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, rw).contiguous()
        # a bf16 add computes in float32 and rounds once
        return (rel_h[..., :, None] + rel_w[..., None, :]).view(B, h, N, N)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _, C = x.shape
        q, k, v = self.qkv(x).reshape(B, S * S, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=self.bias(q, S))
        return self.proj(o.transpose(1, 2).reshape(B, S, S, C))


class MLPBlock(nn.Module):
    def __init__(self, width: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(width, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int, rel_rows: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads, rel_rows)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = MLPBlock(width, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """SAM's channel LayerNorm of NCHW maps, in float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float()
        u = y.mean(1, keepdim=True)
        s = (y - u).pow(2).mean(1, keepdim=True)
        y = (y - u) / torch.sqrt(s + LN_EPS)
        y = self.weight.float()[:, None, None] * y + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class Encoder(nn.Module):
    def __init__(self, width, depth, heads, mlp_dim, patch, tokens, neck_dim, rel_rows):
        super().__init__()
        self.patch_embed = PatchEmbed(patch, 3, width)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, tokens, width))
        self.blocks = nn.ModuleList(
            Block(width, heads, mlp_dim, rel_rows[i]) for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(width, neck_dim, 1, bias=False), LayerNorm2d(neck_dim),
            nn.Conv2d(neck_dim, neck_dim, 3, padding=1, bias=False), LayerNorm2d(neck_dim))


class CellposeSAM(nn.Module):
    """Cellpose's ``vit_sam.Transformer`` with every block global: (B, 3,
    tile, tile) -> (B, nout, tile, tile) ``[dY, dX, cellprob]`` in the
    parameters' dtype.  The defaults are the published ``cpsam``: ViT-L
    (width 1024, 24 blocks, 16 heads of 64, MLP 4096), 8-px patches on a
    256-px tile, neck 256."""

    def __init__(self, width: int = 1024, depth: int = 24, heads: int = 16,
                 mlp_dim: int = 4096, patch: int = 8, tile: int = 256,
                 neck_dim: int = 256, nout: int = 3, rel_rows: Sequence[int] = None):
        super().__init__()
        if tile % patch:
            raise ValueError(f"tile {tile} is not a multiple of the patch {patch}")
        self.width, self.heads, self.patch, self.tile = width, heads, patch, tile
        self.tokens = tile // patch
        rel_rows = list(rel_rows) if rel_rows is not None else rel_pos_rows(depth)
        self.encoder = Encoder(width, depth, heads, mlp_dim, patch, self.tokens,
                               neck_dim, rel_rows)
        # Cellpose's readout, conv_transpose2d with the identity W2, is a
        # pixel shuffle: W2 is not held (checkpoint.load_cpsam checks it)
        self.out = nn.Conv2d(neck_dim, nout * patch ** 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        t = enc.patch_embed(x) + enc.pos_embed
        for blk in enc.blocks:
            t = blk(t)
        n = enc.neck(t.permute(0, 3, 1, 2))
        return F.pixel_shuffle(self.out(n), self.patch)

    def bias_bytes(self, n_tiles: int) -> int:
        """Bytes of the additive attention bias one forward of *n_tiles*
        tiles materialises, summed over the blocks."""
        N = self.tokens ** 2
        item = self.out.weight.element_size()
        return len(self.encoder.blocks) * n_tiles * self.heads * N * N * item


class TileMaps(nn.Module):
    """``segment.cellseg``'s view of a :class:`CellposeSAM`: (n, 1, t, t)
    float32 normalised tiles -> float32 (n, 3, t, t) ``[cellprob, dY / 5,
    dX / 5]``, the U-Net's channel order and flow scale.  Its ``clamp``
    tells ``segment.cellseg`` that the tiles' stretch is Cellpose's
    ``normalize99``, not clipped to [0, 1]."""

    clamp = False

    def __init__(self, net: CellposeSAM):
        super().__init__()
        self.net = net
        self.tile = net.tile

    def forward(self, tiles: torch.Tensor) -> torch.Tensor:
        dtype = self.net.out.weight.dtype
        x = F.pad(tiles.to(dtype), (0, 0, 0, 0, 0, 2))   # [x, 0, 0]
        y = self.net(x).float()
        return torch.stack([y[:, 2], y[:, 0] / FLOW_SCALE, y[:, 1] / FLOW_SCALE], 1)

    def counts(self, n_tiles: int) -> dict:
        """The seg path's counters for one forward of *n_tiles* tiles."""
        return {"seg_tokens": n_tiles * self.net.tokens ** 2,
                "seg_bias_mb": self.net.bias_bytes(n_tiles) // 2 ** 20}
