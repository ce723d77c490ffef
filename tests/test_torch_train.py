"""Port parity: U-Net training (``imageprocess_tpu_torch.models.train``)
against the JAX package's on the CPU.

Setup: features (8, 16), tile 32, batch 4, ``synthetic_batch(default_rng(0))``,
the JAX params from ``UNet.init(PRNGKey(0))`` carried across by
``params_from_flax``, lr 3e-3.  The JAX references are computed once for
the module: one ``value_and_grad`` per dtype, three ``optax.adamw``
updates, three full f32 steps and the schedule's values.

Bars, and why:
- float32 model: loss within 1e-5 relative, every gradient tensor within
  1e-4 relative norm (measured: 0 and 5e-6);
- bf16 model (the default, what trains): loss within 1e-4 relative, the
  global gradient within 5e-2 relative norm and each tensor within 0.15
  (measured: 1.2e-5, 1.9e-2, 0.11).  Both compute each conv in bf16, and
  XLA's and oneDNN's roundings of bf16 activations differ;
- the zero-gradient biases (``train.zero_gradient_biases``:
  ``down.0.conv0/conv1`` and ``dec.1.conv0/conv1``, each before a
  GroupNorm with one channel per group at features 8) are left out of the
  gradient and parameter bars: their true gradient is zero, the computed
  one is rounding noise (relative error 1-3 against JAX in both dtypes),
  and Adam moves them by about lr per step on it, in JAX as in the port.
  They have no effect on the output;
- AdamW and the schedule fed JAX's gradients for 3 updates that cross the
  warmup: every parameter tensor within 1e-6 relative norm of
  ``optax.adamw``'s, run in float64 (``jax.enable_x64``).  optax in
  float32 rounds Adam's bias correction 1 - 0.999^t in float32 (1.3e-5
  relative off at t = 1), which moves its first update by 6.4e-6
  relative, visible on the zero-initialised biases; torch's AdamW on the
  CPU computes the correction in float64 (its fused CUDA kernel in
  float32, as optax).  The schedule within 1e-6 relative of optax's at
  every count to ``decay_steps`` + 2;
- three full f32 steps at a constant lr (JAX's own training test's
  config) against JAX's ``TrainState.apply_gradients``: loss within 1e-5
  relative, parameters within 0.1 lr, the two models' outputs on the
  batch afterwards within 1e-5 relative norm (measured: 8.7e-7, 3.1e-3
  lr, 2.8e-6).  The outputs move with the parameters' last bits: with
  the optimizer test's schedule (decay 10) the parameters stay within
  5.1e-3 lr and the outputs differ by 2.1e-5, with decay 20, 37 and 100
  by 2.6e-6 to 3.0e-6.  Adam's normalisation lets float32 rounding of
  small gradient elements move parameters by fractions of lr;
- flax's init: every kernel's std within 5 % of lecun_normal's sigma,
  pooled over 16 draws (a std over the 24 values of the head alone has a
  sampling error near 14 %), no value beyond 2 sigma, biases zero,
  GroupNorm scale one;
- the sharded step on a virtual 4-shard CPU mesh against the single-device
  step: loss within 1e-6 relative, parameters within 0.1 lr, ``step`` 1,
  the averaged gradients within 1e-4 relative norm of the single step's
  (measured: 0, 1.1e-2 lr, 1.2e-6), and the update bit-equal to one
  AdamW step from them.  In bf16 the loss within 1e-4 (measured 6.7e-5)
  and no parameter bar: Adam's first step is +-lr by each gradient
  element's sign, and the two paths round near-zero elements apart
  (measured: 2 lr).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu_torch.models import train as tt
from imageprocess_tpu_torch.models.checkpoint import params_from_flax, params_to_flax
from imageprocess_tpu_torch.parallel.runner import Mesh

FEATURES, TILE, BATCH, LR = (8, 16), 32, 4, 3e-3
DECAY_STEPS = 10          # warmup min(100, 10 // 10 + 1) = 2: 3 updates cross it
CPU = torch.device("cpu")


def _cfg(**kw):
    return tt.TrainConfig(features=FEATURES, tile=TILE, batch_size=BATCH, lr=LR, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the batch, the init, the loss and gradients per
    dtype, three optax updates, three full f32 steps, the schedule."""
    import optax
    from flax.training import train_state

    from imageprocess_tpu.models import train as jt
    from imageprocess_tpu.models.unet import UNet as FlaxUNet

    batch = jt.synthetic_batch(np.random.default_rng(0), BATCH, TILE)
    jbatch = tuple(jnp.asarray(a) for a in batch)
    # jitted: flax's eager init compiles each op on its own
    params = jax.jit(FlaxUNet(features=FEATURES).init)(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, TILE, TILE, 1)))
    vag = jax.jit(jax.value_and_grad(jt._loss_fn), static_argnums=(1, 5))
    out = {"batch": batch, "params": _np(params), "grads": {}, "loss": {}}
    models = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        models[name] = FlaxUNet(features=FEATURES, dtype=dt)
        loss, g = vag(params, models[name].apply, *jbatch, 0.5)
        out["loss"][name], out["grads"][name] = float(loss), _np(g)

    cfg = _cfg(decay_steps=DECAY_STEPS)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=LR * 0.05, peak_value=LR,
        warmup_steps=min(cfg.warmup_steps, DECAY_STEPS // 10 + 1),
        decay_steps=DECAY_STEPS, end_value=LR * 0.01)
    out["schedule"] = [float(sched(k)) for k in range(DECAY_STEPS + 3)]
    tx = optax.adamw(sched, weight_decay=cfg.weight_decay)
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

        @jax.jit
        def update(grads, opt_s, opt_p):
            upd, opt_s = tx.update(grads, opt_s, opt_p)
            return optax.apply_updates(opt_p, upd), opt_s

        opt_p = f64(out["params"])
        opt_s = tx.init(opt_p)
        for _ in range(3):
            opt_p, opt_s = update(f64(out["grads"]["float32"]), opt_s, opt_p)
        out["optax_params"] = _np(opt_p)

    m32 = models["float32"]
    st = train_state.TrainState.create(
        apply_fn=m32.apply, params=params,
        tx=optax.adamw(LR, weight_decay=cfg.weight_decay))
    out["step_losses"] = []
    for _ in range(3):  # JAX's own jitted train_step
        st, loss = jt.train_step(st, *jbatch)
        out["step_losses"].append(float(loss))
    out["step_params"], out["step_count"] = _np(st.params), int(st.step)
    out["step_output"] = np.asarray(jax.jit(m32.apply)(st.params, jbatch[0]))
    return out


def _state(ref, dtype, **cfg_kw):
    state = tt.create_train_state(_cfg(**cfg_kw), torch.Generator().manual_seed(0),
                                  device="cpu", dtype=dtype)
    state.model.load_state_dict(params_from_flax(ref["params"]))
    return state


def _loss_and_grads(ref, dtype):
    state = _state(ref, dtype)
    x, p, g = tt._batch(*ref["batch"], CPU)
    loss = tt._loss_fn(state.model, x, p, g, 0.5)
    names = [n for n, _ in state.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(state.model.parameters()))
    return (float(loss.detach()), dict(zip(names, grads)),
            set(tt.zero_gradient_biases(state.model)))


def test_zero_gradient_biases_are_the_one_channel_groups():
    model = tt.UNet(features=FEATURES)
    assert tt.zero_gradient_biases(model) == [
        "down.0.conv0.bias", "down.0.conv1.bias", "dec.1.conv0.bias", "dec.1.conv1.bias"]
    assert tt.zero_gradient_biases(tt.UNet(features=(16, 32, 64, 128))) == []


def test_loss_and_gradients_float32(ref):
    loss, grads, skip = _loss_and_grads(ref, torch.float32)
    assert abs(loss - ref["loss"]["float32"]) <= 1e-5 * abs(ref["loss"]["float32"])
    want = params_from_flax(ref["grads"]["float32"])
    assert set(grads) == set(want)
    errs = {n: _rel(g, want[n]) for n, g in grads.items() if n not in skip}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])


def test_loss_and_gradients_bfloat16(ref):
    loss, grads, skip = _loss_and_grads(ref, torch.bfloat16)
    assert abs(loss - ref["loss"]["bfloat16"]) <= 1e-4 * abs(ref["loss"]["bfloat16"])
    want = params_from_flax(ref["grads"]["bfloat16"])
    kept = [n for n in grads if n not in skip]
    num = sum(float((grads[n] - want[n]).norm() ** 2) for n in kept)
    den = sum(float(want[n].norm() ** 2) for n in kept)
    assert math.sqrt(num / den) <= 5e-2, math.sqrt(num / den)
    errs = {n: _rel(grads[n], want[n]) for n in kept}
    assert max(errs.values()) <= 0.15, max(errs.items(), key=lambda kv: kv[1])


def test_schedule_equals_optax(ref):
    lr = tt.warmup_cosine_lr(_cfg(decay_steps=DECAY_STEPS))
    for k, want in enumerate(ref["schedule"]):
        assert abs(lr(k) - want) <= 1e-6 * want, (k, lr(k), want)
    # the LambdaLR applies the value at count k to update k
    state = _state(ref, torch.float32, decay_steps=DECAY_STEPS)
    for prm in state.model.parameters():
        prm.grad = torch.zeros_like(prm)
    for k, want in enumerate(ref["schedule"]):
        assert abs(state.optimizer.param_groups[0]["lr"] - want) <= 1e-6 * want, k
        tt._apply(state)


def test_adamw_with_schedule_equals_optax(ref):
    state = _state(ref, torch.float32, decay_steps=DECAY_STEPS)
    grads = params_from_flax(ref["grads"]["float32"])
    for _ in range(3):
        for n, prm in state.model.named_parameters():
            prm.grad = grads[n].clone()
        tt._apply(state)
    want = params_from_flax(ref["optax_params"])
    errs = {n: _rel(p.detach(), want[n]) for n, p in state.model.named_parameters()}
    assert max(errs.values()) <= 1e-6, max(errs.items(), key=lambda kv: kv[1])
    assert state.step == 3


def test_three_full_float32_steps(ref):
    state = _state(ref, torch.float32)
    skip = set(tt.zero_gradient_biases(state.model))
    for want in ref["step_losses"]:
        state, loss = tt.train_step(state, *ref["batch"])
        assert loss.dim() == 0 and loss.device == CPU and not loss.requires_grad
        assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert state.step == ref["step_count"] == 3
    want = params_from_flax(ref["step_params"])
    moved = max(float((p.detach() - want[n]).abs().max())
                for n, p in state.model.named_parameters() if n not in skip)
    assert moved <= 0.1 * LR, moved / LR
    with torch.no_grad():
        out = state.model(torch.from_numpy(ref["batch"][0]).permute(0, 3, 1, 2))
    assert _rel(out.permute(0, 2, 3, 1), ref["step_output"]) <= 1e-5


def test_flax_init():
    """lecun_normal's sigma from each kernel's flax (HWIO) shape: fan_in is
    every axis but the last."""
    draws = [params_to_flax(tt.flax_init_(tt.UNet(features=FEATURES),
                                          torch.Generator().manual_seed(s)).state_dict())
             for s in range(16)]
    for key, first in draws[0].items():
        if key.endswith("['kernel']"):
            sigma = math.sqrt(1.0 / np.prod(first.shape[:-1])) / tt.TRUNC_STD
            vals = np.concatenate([d[key].ravel() for d in draws])
            assert abs(vals.std() / (sigma * tt.TRUNC_STD) - 1.0) <= 0.05, key
            assert np.abs(vals).max() <= 2.0 * sigma, key
            assert not np.array_equal(first, draws[1][key]), key
        elif key.endswith("['scale']"):
            assert (first == 1.0).all(), key
        else:
            assert (first == 0.0).all(), key


def test_init_draws_from_the_generator():
    a, b = (tt.create_train_state(_cfg(), torch.Generator().manual_seed(3), device="cpu")
            for _ in range(2))
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert a.model.dtype == torch.bfloat16 and a.scheduler is None
    assert all(p.dtype == torch.float32 for p in a.model.parameters())
    group = a.optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        LR, (0.9, 0.999), 1e-8, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sharded_step_equals_single_device_step(dtype):
    batch = tt.synthetic_batch(np.random.default_rng(1), 8, TILE)
    single, sharded = (tt.create_train_state(_cfg(), torch.Generator().manual_seed(1),
                                             device="cpu", dtype=dtype) for _ in range(2))
    single, loss1 = tt.train_step(single, *batch)
    step = tt.make_sharded_train_step(Mesh(("cpu",) * 4))
    sharded, loss = step(sharded, *batch)
    assert sharded.step == 1 and loss.dim() == 0
    assert abs(float(loss) - float(loss1)) <= {torch.float32: 1e-6,
                                               torch.bfloat16: 1e-4}[dtype] * float(loss1)
    if dtype == torch.float32:
        # bf16: Adam's first step is +-lr by the sign of each gradient element,
        # and the two paths round near-zero elements differently
        skip = set(tt.zero_gradient_biases(single.model))
        want = single.model.state_dict()
        moved = max(float((p - want[n]).abs().max())
                    for n, p in sharded.model.state_dict().items() if n not in skip)
        assert moved <= 0.1 * LR, moved / LR
        pairs = list(zip(sharded.model.parameters(), single.model.parameters()))
        num = sum(float((p.grad - q.grad).norm()) ** 2 for p, q in pairs)
        assert math.sqrt(num / sum(float(q.grad.norm()) ** 2 for _, q in pairs)) <= 1e-4
        # the update is one AdamW step from the averaged gradients
        update = tt.create_train_state(_cfg(), torch.Generator().manual_seed(1),
                                       device="cpu", dtype=dtype)
        for p, (q, _) in zip(update.model.parameters(), pairs):
            p.grad = q.grad.clone()
        update.optimizer.step()
        assert all(torch.equal(p, q) for p, (q, _) in zip(update.model.parameters(), pairs))


def test_sharded_step_replicas_follow_the_state():
    """A mesh whose second device differs from the state's ("cpu:0" is not
    "cpu"): that block runs on a replica, which takes the state's
    parameters at every step, also after a single-device step in between;
    the result is the virtual mesh's."""
    batch = tt.synthetic_batch(np.random.default_rng(2), 4, TILE)
    a, b = (tt.create_train_state(_cfg(), torch.Generator().manual_seed(2),
                                  device="cpu", dtype=torch.float32) for _ in range(2))
    step_a = tt.make_sharded_train_step(Mesh(("cpu", "cpu:0")))
    step_b = tt.make_sharded_train_step(Mesh(("cpu", "cpu")))
    skip = set(tt.zero_gradient_biases(a.model))
    for single in (False, True, False):
        if single:
            a, _ = tt.train_step(a, *batch)
            b, _ = tt.train_step(b, *batch)
            continue
        a, loss_a = step_a(a, *batch)
        b, loss_b = step_b(b, *batch)
        assert abs(float(loss_a) - float(loss_b)) <= 1e-6 * float(loss_b)
        want = b.model.state_dict()
        moved = max(float((p - want[n]).abs().max())
                    for n, p in a.model.state_dict().items() if n not in skip)
        assert moved <= 0.1 * LR, moved / LR
    assert a.step == b.step == 3


def test_train_step_decreases_loss():
    state = tt.create_train_state(_cfg(), torch.Generator().manual_seed(0), device="cpu")
    batch = tt.synthetic_batch(np.random.default_rng(0), BATCH, TILE)
    losses = []
    for _ in range(12):
        state, loss = tt.train_step(state, *batch)
        losses.append(loss)
    losses = torch.stack(losses).numpy()
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert state.step == 12


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tt.create_train_state(_cfg(), torch.Generator().manual_seed(0))
    state = tt.create_train_state(_cfg(), torch.Generator().manual_seed(0), device="cpu")
    state.device = torch.device("cuda")
    batch = tt.synthetic_batch(np.random.default_rng(0), BATCH, TILE)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tt.train_step(state, *batch)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tt.make_sharded_train_step(Mesh(("cpu",) * 2))(state, *batch)
    assert state.step == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_card_step_equals_cpu_step(dtype):
    """On a card: one step from the same parameters and batch on the card
    and on the CPU (float32 convolutions without TF32): loss within 1e-5 /
    1e-3 relative, the global gradient within 1e-4 / 5e-2 relative norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    batch = tt.synthetic_batch(np.random.default_rng(0), 8, 64)
    cfg = tt.TrainConfig(features=(16, 32), tile=64, batch_size=8)
    cpu = tt.create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    card = tt.create_train_state(cfg, torch.Generator().manual_seed(0), device="cuda",
                                 dtype=dtype)
    cpu, loss_c = tt.train_step(cpu, *batch)
    card, loss_g = tt.train_step(card, *batch)
    bars = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 5e-2)}[dtype]
    assert abs(float(loss_g) - float(loss_c)) <= bars[0] * float(loss_c)
    num = sum(float((p.grad.cpu() - q.grad).norm() ** 2)
              for p, q in zip(card.model.parameters(), cpu.model.parameters()))
    den = sum(float(q.grad.norm() ** 2) for q in cpu.model.parameters())
    assert math.sqrt(num / den) <= bars[1]
