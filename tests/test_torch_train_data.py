"""Port parity: the U-Net's training data and checkpoints against the JAX
package's on the CPU.

Bars, and why:
- ``synthetic_batch`` and ``sample_crops`` (numpy copies): bit-equal for the
  same ``np.random.Generator``, also on a frame smaller than the tile
  (edge / zero padding) and through every rot90 / flip draw;
- ``frame_arrays`` and ``frame_training_arrays`` on synthcells frames: probs
  and flows bit-equal (the same numpy, the port's host rasterizer held
  equal to JAX's by ``test_torch_host.py``), the stretched image within 4
  float32 ulps of 1 (the quantile interpolation on either side);
- checkpoints: ``params_to_flax(params_from_flax(t)) == t`` bit for bit
  for both bundled checkpoints; JAX's ``load_checkpoint(path, like=...)``
  reads the port's ``save_checkpoint`` output with every leaf bit-equal,
  and so does the port's ``load_unet``.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu_torch.models import checkpoint as tck
from imageprocess_tpu_torch.models import golden as tgolden
from imageprocess_tpu_torch.models import synthcells as tsyn
from imageprocess_tpu_torch.models import train as tt
from imageprocess_tpu_torch.morphology.contours import masks_to_polygons

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = [os.path.join(REPO, "imageprocess_tpu", "models", "pretrained", f"unet_{n}_v1")
         for n in ("golden", "general")]
X_ATOL = 4 * np.finfo(np.float32).eps


def _frame(seed, H, W, domain="fluor", r_range=(6.0, 14.0)):
    return tsyn.synth_frame(np.random.default_rng(seed), H, W, domain, r_range=r_range)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("batch,tile", [(4, 32), (3, 48)])
def test_synthetic_batch_equals_jax(batch, tile):
    from imageprocess_tpu.models.train import synthetic_batch

    _assert_equal(tt.synthetic_batch(np.random.default_rng(3), batch, tile),
                  synthetic_batch(np.random.default_rng(3), batch, tile))


@pytest.mark.parametrize("domain", ["fluor", "ring"])
def test_frame_arrays_equal_jax(domain):
    from imageprocess_tpu.models.synthcells import frame_arrays

    img, labels = _frame(1, 96, 128, domain)
    got = tsyn.frame_arrays(img, labels, device="cpu")
    want = frame_arrays(img, labels)
    assert got[0].dtype == np.float32 and got[0].shape == img.shape
    assert float(np.abs(got[0] - want[0]).max()) <= X_ATOL
    _assert_equal(got[1:], want[1:])
    assert got[1].any()


def test_frame_training_arrays_equal_jax():
    from imageprocess_tpu.models.golden import frame_training_arrays

    img, labels = _frame(2, 96, 128)
    polys = [np.round(p, 1) for p in masks_to_polygons(labels, min_area=20.0)]
    assert len(polys) > 2
    got = tgolden.frame_training_arrays(img, polys, device="cpu")
    want = frame_training_arrays(img, polys)
    assert float(np.abs(got[0] - want[0]).max()) <= X_ATOL
    _assert_equal(got[1:], want[1:])
    assert got[1].any()


@pytest.mark.parametrize("shape", [(96, 128), (20, 28)], ids=["frame", "below-tile"])
def test_sample_crops_equal_jax(shape):
    from imageprocess_tpu.models.golden import sample_crops

    img, labels = _frame(4, *shape, r_range=(4.0, 8.0))
    arrays = tsyn.frame_arrays(img, labels, device="cpu")
    got = tgolden.sample_crops(np.random.default_rng(5), *arrays, 32, 16)
    want = sample_crops(np.random.default_rng(5), *arrays, 32, 16)
    _assert_equal(got, want)
    assert got[0].shape == (16, 32, 32, 1)


def test_frame_arrays_raise_on_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    img, labels = _frame(1, 32, 32)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tsyn.frame_arrays(img, labels)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tgolden.frame_training_arrays(img, [np.array([[2.5, 2.5], [9.5, 2.5], [9.5, 9.5]])])


@pytest.mark.parametrize("ckpt", CKPTS, ids=os.path.basename)
def test_params_to_flax_inverts_params_from_flax(ckpt):
    tree = tck.load_checkpoint(ckpt)
    _assert_equal([v for _, v in sorted(tck.params_to_flax(tck.params_from_flax(tree)).items())],
                  [v for _, v in sorted(tree.items())])


def _jax_params(features=(8, 16), tile=32):
    from imageprocess_tpu.models.unet import UNet

    params = jax.jit(UNet(features=features).init)(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, tile, tile, 1)))
    return jax.tree_util.tree_map(np.asarray, params)


def test_jax_load_checkpoint_reads_the_ports_checkpoint(tmp_path):
    from imageprocess_tpu.models.checkpoint import load_checkpoint

    params = _jax_params()
    model = tt.UNet(features=(8, 16))
    model.load_state_dict(tck.params_from_flax(params))
    tck.save_checkpoint(str(tmp_path), model, {"tile": 32, "steps": 3})
    got = load_checkpoint(str(tmp_path), like=params)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(params)
    assert tree_got == tree_want
    _assert_equal([np.asarray(a) for a in flat_got], flat_want)
    with open(tmp_path / "config.json", encoding="utf-8") as f:
        assert json.load(f) == {"features": [8, 16], "tile": 32, "steps": 3}


def test_load_unet_round_trip(tmp_path):
    state = tt.create_train_state(tt.TrainConfig(features=(8, 16)),
                                  torch.Generator().manual_seed(4), device="cpu")
    tck.save_checkpoint(str(tmp_path), state.model, {"tile": 64})
    model, tile = tck.load_unet(str(tmp_path))
    assert tile == 64 and model.features == (8, 16) and model.dtype == torch.bfloat16
    want = state.model.state_dict()
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name
    x = torch.rand(2, 1, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(model(x), state.model(x))


def test_load_checkpoint_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="orbax"):
        tck.load_checkpoint(str(tmp_path))


def _script():
    spec = importlib.util.spec_from_file_location(
        "train_unet_general_torch", os.path.join(REPO, "scripts", "train_unet_general_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("out", [
    os.path.join("imageprocess_tpu", "models", "pretrained", "unet_general_v1"),
    "imageprocess_tpu",
    os.path.join("imageprocess_tpu", "models", "..", "new_ckpt"),
])
def test_training_script_refuses_the_jax_package(out, monkeypatch):
    monkeypatch.chdir(REPO)
    before = sorted(os.listdir(os.path.join(REPO, "imageprocess_tpu", "models", "pretrained")))
    with pytest.raises(SystemExit, match="refusing to write"):
        _script().main([out, "--steps", "1", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(REPO, "imageprocess_tpu", "models",
                                          "pretrained"))) == before


def test_training_script_needs_an_output_directory(capsys):
    with pytest.raises(SystemExit):
        _script().parse_args([])
    assert "out" in capsys.readouterr().err
    args = _script().parse_args(["out_dir"])
    assert args.device == "cuda" and args.golden is None and args.steps == 2500
