"""Plain reference of Cellpose-SAM (``cpsam``) and of its stitched frame maps,
in float32 ``torch`` with no kernel, cache or batching trick, independent
of ``imageprocess_tpu_torch``.

It follows the equations of Cellpose's ``vit_sam.Transformer`` with every
``blk.window_size = 0`` (SAM's ViT image encoder, its neck, Cellpose's
readout) literally: explicit attention (the whole softmax matrix), the
relative-position bias built for every pair of tokens from the resized
tables (``R[(i, j), (k, l)] = Rh[i, k] + Rw[j, l]``, then ``q . R``),
LayerNorms written out, GELU by erf, and the readout as Cellpose's
``conv_transpose2d`` with ``W2``.
Weights are a Cellpose state dict of float32 tensors.

*rnd*, where a function takes it, is applied to the inputs of every
matrix product and convolution (the identity by default): a lower
precision can be put there without touching the rest.

The frame maps follow the tiled path of a segmentation run: the 1/99
percentiles of the frame (``np.percentile``), ``(x - p1) / (p99 - p1)``
unclamped, tiles of ``tile`` px on a grid of stride ``tile - 2 * overlap``
whose last tile ends at the frame's edge, every tile whose maximum lies at
or below ``p1 + cull_margin * (p99 - p1)`` given the response of an
all-zero tile, input ``[x, 0, 0]``, and each tile's sigmoid(cellprob),
dY / 5 and dX / 5 blended with the weight min(a + 1, tile - a) of its
pixel's distance a to the tile's edges along each axis (the smaller of
the two), in float64, on the state dict's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
FLOW_SCALE = 5.0


def _same(x):
    return x


def layer_norm(x, w, b, dim):
    """LayerNorm over *dim*, eps 1e-6, biased variance."""
    u = x.mean(dim, keepdim=True)
    s = ((x - u) ** 2).mean(dim, keepdim=True)
    y = (x - u) / torch.sqrt(s + LN_EPS)
    shape = [1] * x.dim()
    shape[dim] = -1
    return y * w.reshape(shape) + b.reshape(shape)


def linear(x, w, b, rnd=_same):
    return rnd(x) @ rnd(w).T + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def rel_table(table, S):
    """(S, S, C): the table resized to 2S - 1 rows (``F.interpolate``,
    linear), entry [i, j] its row i - j + S - 1."""
    rows = 2 * S - 1
    t = table
    if t.shape[0] != rows:
        t = F.interpolate(t.T.unsqueeze(0), size=rows, mode="linear").squeeze(0).T
    i = torch.arange(S, device=t.device)
    return t[i[:, None] - i[None, :] + S - 1]


def pair_bias(q, rel_h, rel_w, S, rnd=_same):
    """(B, heads, N, N) bias of the unscaled q (B, heads, N, C): for query
    (i, j) and key (k, l), q . (Rh[i, k] + Rw[j, l])."""
    Rh, Rw = rel_table(rel_h, S), rel_table(rel_w, S)
    C = Rh.shape[-1]
    R = (Rh[:, None, :, None, :] + Rw[None, :, None, :, :]).reshape(S * S, S * S, C)
    return torch.einsum("bhnc,nmc->bhnm", rnd(q), rnd(R))


def forward(sd, x, heads, rnd=_same):
    """(B, 3, t, t) float32 -> (B, 3, t, t) ``[dY, dX, cellprob]``."""
    pw = sd["encoder.patch_embed.proj.weight"]
    p = pw.shape[-1]
    t = F.conv2d(rnd(x), rnd(pw), sd["encoder.patch_embed.proj.bias"], stride=p)
    t = t.permute(0, 2, 3, 1) + sd["encoder.pos_embed"]          # (B, S, S, width)
    B, S, _, width = t.shape
    N, hd = S * S, width // heads
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.blocks."))
    for i in range(depth):
        g = {k[len(f"encoder.blocks.{i}."):]: v for k, v in sd.items()
             if k.startswith(f"encoder.blocks.{i}.")}
        h = layer_norm(t, g["norm1.weight"], g["norm1.bias"], -1)
        qkv = linear(h.reshape(B, N, width), g["attn.qkv.weight"], g["attn.qkv.bias"], rnd)
        q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        logits = rnd(q * hd ** -0.5) @ rnd(k).transpose(-1, -2)
        logits = logits + pair_bias(q, g["attn.rel_pos_h"], g["attn.rel_pos_w"], S, rnd)
        attn = torch.softmax(logits, -1)
        o = (rnd(attn) @ rnd(v)).permute(0, 2, 1, 3).reshape(B, S, S, width)
        t = t + linear(o, g["attn.proj.weight"], g["attn.proj.bias"], rnd)
        h = layer_norm(t, g["norm2.weight"], g["norm2.bias"], -1)
        m = gelu(linear(h, g["mlp.lin1.weight"], g["mlp.lin1.bias"], rnd))
        t = t + linear(m, g["mlp.lin2.weight"], g["mlp.lin2.bias"], rnd)
    n = F.conv2d(rnd(t.permute(0, 3, 1, 2)), rnd(sd["encoder.neck.0.weight"]))
    n = layer_norm(n, sd["encoder.neck.1.weight"], sd["encoder.neck.1.bias"], 1)
    n = F.conv2d(rnd(n), rnd(sd["encoder.neck.2.weight"]), padding=1)
    n = layer_norm(n, sd["encoder.neck.3.weight"], sd["encoder.neck.3.bias"], 1)
    y = F.conv2d(rnd(n), rnd(sd["out.weight"]), sd["out.bias"])
    return F.conv_transpose2d(rnd(y), rnd(sd["W2"]), stride=p)


def grid(n, tile, overlap):
    """Tile origins along an axis of *n* >= *tile* px."""
    stride = tile - 2 * overlap
    out = list(range(0, n - tile + 1, stride))
    if out[-1] + tile < n:
        out.append(n - tile)
    return out


def frame_maps(img, sd, heads, tile, overlap, cull_margin, rnd=_same, block=8):
    """(maps (3, H, W) float64 numpy [prob, dy, dx], tiles forwarded) of a
    2-D frame, the network run in blocks of *block* tiles on the device of
    the float32 state dict *sd*."""
    img = np.asarray(img)
    H, W = img.shape
    if H < tile or W < tile:
        raise ValueError("the reference takes frames of at least one tile")
    p1, p99 = np.percentile(img.astype(np.float64), [1.0, 99.0])
    den = p99 - p1 if p99 > p1 else 1e-6
    x = ((img.astype(np.float64) - p1) / den).astype(np.float32)
    thr = p1 + cull_margin * den
    origins = [(y, x0) for y in grid(H, tile, overlap) for x0 in grid(W, tile, overlap)]
    kept = [o for o in origins if cull_margin <= 0 or len(origins) == 1
            or img[o[0]:o[0] + tile, o[1]:o[1] + tile].max() > thr]
    batch = [x[y:y + tile, x0:x0 + tile] for y, x0 in kept]
    culled = len(kept) < len(origins)
    if culled:
        batch.append(np.zeros((tile, tile), np.float32))
    device = sd["out.weight"].device
    outs = []
    for b in range(0, len(batch), block):
        xt = torch.from_numpy(np.stack(batch[b:b + block]))[:, None].to(device)
        xt = torch.cat([xt, torch.zeros_like(xt), torch.zeros_like(xt)], 1)
        with torch.no_grad():
            y = forward(sd, xt, heads, rnd).double()
        outs.append(torch.stack([torch.sigmoid(y[:, 2]), y[:, 0] / FLOW_SCALE,
                                 y[:, 1] / FLOW_SCALE], 1))
    out = torch.cat(outs)
    resp = dict(zip(kept, out))
    a = torch.arange(tile, device=device, dtype=torch.float64)
    w1 = torch.minimum(a + 1, tile - a)
    w = torch.minimum(w1[:, None], w1[None, :])
    acc = torch.zeros((3, H, W), dtype=torch.float64, device=device)
    wacc = torch.zeros((H, W), dtype=torch.float64, device=device)
    for o in origins:
        y, x0 = o
        r = resp[o] if o in resp else out[-1]
        acc[:, y:y + tile, x0:x0 + tile] += r * w
        wacc[y:y + tile, x0:x0 + tile] += w
    return (acc / wacc).cpu().numpy(), len(batch)
