"""Port parity: the U-Net (``imageprocess_tpu_torch.models``) against the
flax module on the CPU, on the same numpy inputs and weights.

Bars, and why:
- float32 mode: logits within 5e-4 abs (logits reach ~14; the two
  backends sum the convolutions in different orders);
- bf16 mode (the default): logits within 0.25 abs, and the probability
  sign (logit > 0) equal on >= 99.5 % of pixels.  Both compute each conv
  in bf16 with float32 accumulation, so roundings of bf16 activations
  differ between XLA's and oneDNN's kernels and compound over 18 convs;
- weight mapping: exact (a reshuffle of the same float32 values)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu_torch.models.checkpoint import load_unet, params_from_flax
from imageprocess_tpu_torch.models.unet import UNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {name: os.path.join(REPO, "imageprocess_tpu", "models", "pretrained",
                            f"unet_{name}_v1") for name in ("golden", "general")}
F32_ATOL = 5e-4
BF16_ATOL = 0.25
BF16_SIGN = 0.995


def _flax_unet(features, dtype):
    from imageprocess_tpu.models.unet import UNet as FlaxUNet

    return FlaxUNet(features=features, dtype=dtype)


def _flax_params(name):
    from imageprocess_tpu.models.checkpoint import load_checkpoint

    like = jax.eval_shape(_flax_unet((16, 32, 64, 128), jnp.float32).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    return load_checkpoint(CKPTS[name], like)


def _compare(flax_params, features, x_nhwc, torch_dtype, jax_dtype, sd=None):
    want = np.asarray(_flax_unet(features, jax_dtype).apply(
        flax_params, jnp.asarray(x_nhwc)))
    model = UNet(features=features, dtype=torch_dtype)
    model.load_state_dict(sd if sd is not None else params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax_params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    err = float(np.abs(got - want).max())
    sign = float(np.mean((got[..., 0] > 0) == (want[..., 0] > 0)))
    return err, sign


def _inputs(seed, n=2, t=64):
    rng = np.random.default_rng(seed)
    # stretched-frame-like: mostly dark, some bright blobs, in [0, 1]
    x = rng.random((n, t, t, 1)).astype(np.float32) * 0.2
    yy, xx = np.mgrid[0:t, 0:t]
    for i in range(n):
        for _ in range(3):
            cy, cx, r = rng.uniform(8, t - 8, 2).tolist() + [rng.uniform(5, 12)]
            x[i, ..., 0] += 0.8 * ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    return np.clip(x, 0, 1)


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_bundled_checkpoint_matches_flax(name):
    params = _flax_params(name)
    x = _inputs(1)
    model, tile = load_unet(CKPTS[name])
    assert tile == 256 and model.features == (16, 32, 64, 128)
    err, _ = _compare(params, (16, 32, 64, 128), x, torch.float32, jnp.float32)
    assert err <= F32_ATOL, err
    # load_unet's own (default bf16) model against flax's bf16 module
    err, sign = _compare(params, (16, 32, 64, 128), x, torch.bfloat16,
                         jnp.bfloat16, sd=model.state_dict())
    assert err <= BF16_ATOL and sign >= BF16_SIGN, (err, sign)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_init_narrow_unet_matches_flax(seed):
    features = (8, 16)
    params = _flax_unet(features, jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 1)))
    x = _inputs(10 + seed, n=3, t=32)
    err, _ = _compare(params, features, x, torch.float32, jnp.float32)
    assert err <= F32_ATOL, err
    err, sign = _compare(params, features, x, torch.bfloat16, jnp.bfloat16)
    assert err <= BF16_ATOL and sign >= BF16_SIGN, (err, sign)


def _to_flax(sd, features):
    """Inverse of params_from_flax, written out from the flax naming."""
    n = len(features)
    blocks = ([f"down.{i}" for i in range(n)] + ["bottleneck"]
              + [f"dec.{i}" for i in range(n)])
    tree = {}
    for i, b in enumerate(blocks):
        blk = {}
        for j in (0, 1):
            blk[f"Conv_{j}"] = {
                "kernel": sd[f"{b}.conv{j}.weight"].numpy().transpose(2, 3, 1, 0),
                "bias": sd[f"{b}.conv{j}.bias"].numpy()}
            blk[f"GroupNorm_{j}"] = {"scale": sd[f"{b}.gn{j}.weight"].numpy(),
                                     "bias": sd[f"{b}.gn{j}.bias"].numpy()}
        tree[f"ConvBlock_{i}"] = blk
    for j in range(n):
        k = sd[f"up.{j}.weight"].numpy().transpose(2, 3, 0, 1)[::-1, ::-1]
        tree[f"ConvTranspose_{j}"] = {"kernel": k, "bias": sd[f"up.{j}.bias"].numpy()}
    tree["Conv_0"] = {"kernel": sd["head.weight"].numpy().transpose(2, 3, 1, 0),
                      "bias": sd["head.bias"].numpy()}
    return {"params": tree}


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_params_from_flax_round_trip(name):
    """npz dict and nested flax tree map to the same state_dict, and the
    state_dict maps back to the flax arrays exactly."""
    with np.load(os.path.join(CKPTS[name], "params.npz")) as data:
        npz = {k: data[k] for k in data.files}
    params = jax.tree_util.tree_map(np.asarray, _flax_params(name))
    sd_npz = params_from_flax(npz)
    sd_tree = params_from_flax(params)
    sd_inner = params_from_flax(params["params"])
    assert sorted(sd_npz) == sorted(sd_tree) == sorted(sd_inner)
    assert sorted(sd_npz) == sorted(UNet(features=(16, 32, 64, 128)).state_dict())
    for k in sd_npz:
        assert torch.equal(sd_npz[k], sd_tree[k]) and torch.equal(sd_npz[k], sd_inner[k])
    back = _to_flax(sd_npz, (16, 32, 64, 128))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_ref) == len(npz)
    for path, arr in flat_back:
        assert np.array_equal(arr, flat_ref[path]), path


def test_load_unet_errors_and_named_checkpoints(tmp_path):
    from imageprocess_tpu.segment import auto as jauto
    from imageprocess_tpu_torch.segment import auto as tauto

    with pytest.raises(FileNotFoundError):
        load_unet(str(tmp_path))
    for name in ("golden", "general"):
        assert (os.path.realpath(tauto.NAMED_UNET_CKPTS[name])
                == os.path.realpath(jauto.NAMED_UNET_CKPTS[name]))
    assert (os.path.realpath(tauto.DEFAULT_UNET_CKPT)
            == os.path.realpath(jauto.DEFAULT_UNET_CKPT))
    with pytest.raises(KeyError, match="unexpected"):
        params_from_flax({"Dense_0": {"kernel": np.zeros((2, 2))}})
