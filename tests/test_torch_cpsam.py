"""Cellpose-SAM in the port (``models.cpsam``, ``checkpoint.load_cpsam``,
``segment.cellseg.frame_maps``, the ``cpsam`` backend of ``roi-auto``)
against the plain reference ``tests/cpsam_reference.py``, on the CPU at a
tiny size: width 64, 4 heads of 16, 2 blocks whose tables have SAM's two
lengths (27 and 127 rows, both resized to 7 for 4 x 4 tokens), 32-px
tiles of 8-px patches.

Bars, and why:
- float32: the same equations in another order of float operations
  (decomposed bias, fused attention, pixel shuffle), 1e-5 of the largest
  output;
- bfloat16, the configuration's precision: every activation is rounded to
  8 significant bits (2**-9 relative) and the rounding compounds through
  the blocks and the neck; 4e-2 of the largest output holds the measured
  1.4e-2 with room, while inputs rounded to float8 e4m3 (the precision
  below) read 0.2 here;
- the frame maps: float32 as above, the sigmoid and the blend in float32
  against the reference's float64.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cpsam_reference as ref
from imageprocess_tpu_torch import cli as tcli
from imageprocess_tpu_torch.models import cpsam
from imageprocess_tpu_torch.models.checkpoint import cpsam_from_state_dict, load_cpsam, load_unet
from imageprocess_tpu_torch.segment import auto as tauto
from imageprocess_tpu_torch.segment import cellseg as tseg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "imageprocess_tpu", "models", "pretrained", "unet_golden_v1")
TINY = dict(width=64, depth=2, heads=4, mlp_dim=256, patch=8, tile=32, neck_dim=32,
            rows=(27, 127))


def cellpose_state_dict(seed, width, depth, heads, mlp_dim, patch, tile, neck_dim, rows,
                        nout=3):
    """A Cellpose-SAM state dict under Cellpose's own key names, seeded
    weights (LayerNorm scales near 1)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, sd=0.15):
        return torch.randn(shape, generator=g) * sd

    S, hd, W = tile // patch, width // heads, width
    sd = {"encoder.patch_embed.proj.weight": rnd(W, 3, patch, patch),
          "encoder.patch_embed.proj.bias": rnd(W),
          "encoder.pos_embed": rnd(1, S, S, W)}
    for i in range(depth):
        b = f"encoder.blocks.{i}."
        sd.update({b + "norm1.weight": 1 + rnd(W, sd=0.1), b + "norm1.bias": rnd(W),
                   b + "attn.qkv.weight": rnd(3 * W, W), b + "attn.qkv.bias": rnd(3 * W),
                   b + "attn.proj.weight": rnd(W, W), b + "attn.proj.bias": rnd(W),
                   b + "attn.rel_pos_h": rnd(rows[i], hd, sd=0.5),
                   b + "attn.rel_pos_w": rnd(rows[i], hd, sd=0.5),
                   b + "norm2.weight": 1 + rnd(W, sd=0.1), b + "norm2.bias": rnd(W),
                   b + "mlp.lin1.weight": rnd(mlp_dim, W), b + "mlp.lin1.bias": rnd(mlp_dim),
                   b + "mlp.lin2.weight": rnd(W, mlp_dim), b + "mlp.lin2.bias": rnd(W)})
    no = nout * patch ** 2
    sd.update({"encoder.neck.0.weight": rnd(neck_dim, W, 1, 1),
               "encoder.neck.1.weight": 1 + rnd(neck_dim, sd=0.1),
               "encoder.neck.1.bias": rnd(neck_dim),
               "encoder.neck.2.weight": rnd(neck_dim, neck_dim, 3, 3),
               "encoder.neck.3.weight": 1 + rnd(neck_dim, sd=0.1),
               "encoder.neck.3.bias": rnd(neck_dim),
               "out.weight": rnd(no, neck_dim, 1, 1), "out.bias": rnd(no),
               "W2": torch.eye(no).reshape(no, nout, patch, patch),
               "diam_labels": torch.tensor([30.0]), "diam_mean": torch.tensor([30.0])})
    return sd


@pytest.fixture(scope="module")
def tiny_sd():
    return cellpose_state_dict(1, **TINY)


def _input(seed, n=3, tile=32):
    x = torch.rand((n, 1, tile, tile), generator=torch.Generator().manual_seed(seed))
    return torch.cat([x, torch.zeros_like(x), torch.zeros_like(x)], 1)


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-5), (torch.bfloat16, 4e-2)])
def test_forward_matches_the_reference(tiny_sd, dtype, bar):
    x = _input(2)
    want = ref.forward(tiny_sd, x, TINY["heads"])
    net = cpsam_from_state_dict(tiny_sd, dtype)
    with torch.no_grad():
        got = net(x.to(dtype))
    assert got.dtype == dtype and got.shape == (3, 3, 32, 32)
    assert _rel_err(got, want) <= bar


def test_decomposed_bias_equals_the_bias_built_per_pair(tiny_sd):
    """Attention.bias (two einsums over the resized tables) against the
    bias built for each query (i, j) and key (k, l) by loops, for both
    table lengths."""
    net = cpsam_from_state_dict(tiny_sd, torch.float32)
    S, hd = 4, 16
    q = torch.randn((2, 4, S * S, hd), generator=torch.Generator().manual_seed(3))
    for blk in net.encoder.blocks:
        a = blk.attn
        rows = 2 * S - 1
        th = F.interpolate(a.rel_pos_h.detach().T[None], size=rows, mode="linear")[0].T
        tw = F.interpolate(a.rel_pos_w.detach().T[None], size=rows, mode="linear")[0].T
        want = torch.empty(2, 4, S * S, S * S)
        for i in range(S):
            for j in range(S):
                for k in range(S):
                    for l_ in range(S):
                        r = th[i - k + S - 1] + tw[j - l_ + S - 1]
                        want[:, :, i * S + j, k * S + l_] = q[:, :, i * S + j] @ r
        with torch.no_grad():
            got = a.bias(q, S)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pixel_shuffle_is_the_w2_readout():
    no, p = 3 * 64, 8
    y = torch.randn((2, no, 4, 4), generator=torch.Generator().manual_seed(4))
    w2 = torch.eye(no).reshape(no, 3, p, p)
    assert torch.equal(F.pixel_shuffle(y, p), F.conv_transpose2d(y, w2, stride=p))


def test_load_cpsam_reads_cellpose_names(tiny_sd, tmp_path):
    path = str(tmp_path / "cpsam.pt")
    torch.save({"module." + k: v for k, v in tiny_sd.items()}, path)
    model, tile = load_cpsam(path, dtype=torch.float32)
    assert tile == 32 and isinstance(model, cpsam.TileMaps)
    got = model.net.state_dict()
    assert set(got) == set(tiny_sd) - {"W2", "diam_labels", "diam_mean"}
    assert all(torch.equal(got[k], tiny_sd[k]) for k in got)
    assert [b.attn.rel_pos_h.shape[0] for b in model.net.encoder.blocks] == [27, 127]
    assert model.net.heads == 4
    x = _input(5, n=2)
    with torch.no_grad():
        maps = model(x[:, :1])
    y = ref.forward(tiny_sd, x, 4)
    want = torch.stack([y[:, 2], y[:, 0] / 5, y[:, 1] / 5], 1)
    assert _rel_err(maps, want) <= 1e-5
    bad = dict(tiny_sd, W2=2 * tiny_sd["W2"])
    with pytest.raises(ValueError, match="W2"):
        cpsam_from_state_dict(bad)
    with pytest.raises(ValueError, match="missing"):
        cpsam_from_state_dict({k: v for k, v in tiny_sd.items() if k != "out.bias"})


def test_published_sizes_and_counters():
    with torch.device("meta"):
        net = cpsam.CellposeSAM()
    n_params = sum(p.numel() for p in net.parameters())
    assert 300e6 < n_params < 310e6
    assert [b.attn.rel_pos_h.shape for b in net.encoder.blocks][4:6] == [(27, 64), (127, 64)]
    assert net.bias_bytes(88) == 24 * 88 * 16 * 1024 ** 2 * 4     # float32 on meta
    maps = cpsam.TileMaps(net.to(torch.bfloat16))
    assert maps.counts(88) == {"seg_tokens": 88 * 1024,
                               "seg_bias_mb": 24 * 88 * 16 * 2 * 1024 ** 2 // 2 ** 20}


def _field(seed, H, W, cull=False):
    """A u16 frame of Gaussian bodies (only in its left half with *cull*)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(120, 15, (H, W))
    yy, xx = np.mgrid[:H, :W]
    for _ in range(12):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W // 3 if cull else W)
        img += rng.uniform(800, 3000) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 60.0)
    return np.clip(img, 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("cull", [False, True])
def test_frame_maps_match_the_reference(tiny_sd, cull):
    img = _field(6, 72, 120, cull)
    model = cpsam.TileMaps(cpsam_from_state_dict(tiny_sd, torch.float32))
    got = tseg.frame_maps(img, model, tile=32, overlap=8, device="cpu")
    want, n_fwd = ref.frame_maps(img, tiny_sd, 4, 32, 8, 0.05)
    ys, xs = tseg.tile_grid(72, 120, 32, 8)
    assert (n_fwd < len(ys) * len(xs)) == cull
    assert got.shape == (3, 72, 120)
    for c in range(3):
        assert _rel_err(got[c], torch.from_numpy(want[c])) <= 1e-5


def test_frame_maps_feed_the_unet_labels_unchanged():
    """``label_frame_unet`` is ``frame_maps`` then ``labels_from_maps``:
    the same label map as the tile cut, forward and post-process run one
    after another."""
    model, tile = load_unet(GOLDEN)
    img = _field(7, 256, 320)
    tiles, keep, ys, xs = tseg.frame_tiles(img, tile, device="cpu")
    out = tseg.forward_tiles(model, tiles)
    want, _ = tseg.postprocess(out, keep, ys=ys, xs=xs, tile=tile, shape=img.shape)
    got = tseg.label_frame_unet(img, model, tile=tile, device="cpu")
    assert got.max() > 1 and np.array_equal(got, want.numpy())
    maps = tseg.frame_maps(img, model, tile, device="cpu")
    lab, _ = tseg.labels_from_maps(maps)
    assert np.array_equal(lab.numpy(), want.numpy())


def test_roi_auto_cpsam_reports_the_seg_phases(tiny_sd, tmp_path, monkeypatch, capsys):
    """``roi-auto --backend cpsam --checkpoint FILE`` through the CLI:
    under ``IP_TIMING`` the run prints the six ``seg_*`` phases and the
    three counters."""
    from PIL import Image

    ckpt = str(tmp_path / "cpsam.pt")
    torch.save(tiny_sd, ckpt)
    folder = tmp_path / "exp"
    folder.mkdir()
    for s in (1, 2):
        Image.fromarray(_field(s, 64, 96)).save(folder / f"S0{s}_1.TIF")
    monkeypatch.setenv("IP_TIMING", "1")
    rc = tcli.main(["roi-auto", str(folder), "--backend", "cpsam", "--checkpoint", ckpt,
                    "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err.splitlines()
    main = next(line for line in err if line.startswith("[IP_TIMING:seg] "))
    extra = next(line for line in err if line.startswith("[IP_TIMING+:seg] "))
    assert [kv.split("=")[0] for kv in main.split()[1:]] == list(tseg.SEG_PHASES)
    counts = dict(kv.split("=") for kv in extra.split()[1:])
    ys, xs = tseg.tile_grid(64, 96, 32, 32)   # overlap clamped to tile // 4
    assert counts == {"seg_tiles": str(2 * len(ys) * len(xs)),
                      "seg_tokens": str(2 * len(ys) * len(xs) * 16), "seg_bias_mb": "0"}


def test_cpsam_backend_needs_a_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        tauto.run_auto_drawer(str(tmp_path), tauto.AutoSegConfig(backend="cpsam"),
                              device="cpu")


@pytest.mark.cuda
def test_cuda_forward_matches_the_reference(tiny_sd):
    """On a card: the bf16 network (fused attention with the additive
    bias) against the float32 reference on the CPU, at the bf16 bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _input(8)
    want = ref.forward(tiny_sd, x, TINY["heads"])
    net = cpsam_from_state_dict(tiny_sd).cuda()
    with torch.no_grad():
        got = net(x.cuda().bfloat16()).cpu()
    assert _rel_err(got, want) <= 4e-2
