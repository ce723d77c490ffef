"""Training step for the segmentation U-Net (port of
``imageprocess_tpu/models/train.py``).

Loss = sigmoid BCE on the cell-probability logit + Dice + ``w_grad`` x L2
on the two flow channels (Cellpose-style flow supervision), the JAX
package's ``_loss_fn`` term for term.  The optimizer is
``torch.optim.AdamW`` with ``optax.adamw``'s constants: decay decoupled
from the gradient and scaled by the learning rate, eps outside the square
root, decay on every parameter.  With ``decay_steps`` a ``LambdaLR`` gives
``optax.warmup_cosine_decay_schedule``'s value step for step: update k
applies the schedule at count k.  Parameters start from flax's
initialisers (:func:`flax_init_`), not torch's.

:func:`make_sharded_train_step` is data parallelism on the port's mesh
(``parallel.runner.Mesh``, one process): the batch splits into equal
contiguous blocks, each block's forward and backward runs on its device,
the gradients are averaged on the first device and one optimizer step
follows.  Every term of the loss is a mean over equal blocks, so this is
the gradient of the global batch's loss, as XLA's all-reduce gives it.

Zero-gradient biases: a conv bias that feeds a GroupNorm with one channel
per group (``features <= 8``: ``groups = min(8, features)``) has zero
gradient in exact arithmetic, because the norm subtracts it again.  The
computed gradient is rounding noise, and Adam normalises that noise into
a step of about +-lr.  Such a bias moves by about lr per step on noise, in
JAX as in the port, and has no effect on the output;
:func:`zero_gradient_biases` names them, and parity checks leave them out.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import no_tf32, resolve_device
from .unet import ConvBlock, UNet

#: std of the unit normal truncated to [-2, 2]: flax's ``lecun_normal``
#: divides by it so that the truncated draw has variance 1 / fan_in
TRUNC_STD = 0.87962566103423978


@dataclass
class TrainConfig:
    features: Tuple[int, ...] = (32, 64, 128, 256)
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_loss_weight: float = 0.5
    tile: int = 256          # training crop size (divisible by 2^depth)
    batch_size: int = 8
    # when set, lr follows a linear-warmup + cosine-decay schedule over
    # this many steps (a fixed lr oscillates late in small-data training)
    decay_steps: int = 0
    warmup_steps: int = 100


@dataclass
class TrainState:
    """The model, its optimizer and schedule, the device they live on and
    the count of updates applied (flax's ``TrainState.step``)."""

    model: UNet
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    device: torch.device
    step: int = 0


def flax_init_(model: UNet, generator: torch.Generator) -> UNet:
    """Initialise *model* in place as flax initialises the JAX UNet:
    every conv, transposed-conv and head kernel from ``lecun_normal`` (a
    normal truncated to [-2 sigma, 2 sigma], sigma = sqrt(1 / fan_in) /
    ``TRUNC_STD``, fan_in = kh * kw * in_features; flax's transposed
    kernel is (kh, kw, in, out) too), conv biases zero, GroupNorm scale one
    and bias zero.  Draws from *generator*, a CPU generator, in module
    order."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                c_in = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
                sigma = math.sqrt(1.0 / (c_in * w.shape[2] * w.shape[3])) / TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, sigma, -2.0 * sigma, 2.0 * sigma,
                                      generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.GroupNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
    return model


def warmup_cosine_lr(cfg: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init_value=0.05 lr,
    peak_value=lr, warmup_steps=min(warmup_steps, decay_steps // 10 + 1),
    decay_steps, end_value=0.01 lr)`` as a function of the update count,
    held at the end value after ``decay_steps``; in float32, operation for
    operation as optax computes it (float64 would differ from optax's
    values by up to 2e-6 relative near the end of a long decay)."""
    f32 = np.float32
    peak, decay = cfg.lr, cfg.decay_steps
    init, end = 0.05 * peak, 0.01 * peak
    warmup = min(cfg.warmup_steps, decay // 10 + 1)
    if decay - warmup <= 0:
        raise ValueError(f"decay_steps={decay} leaves no cosine decay after "
                         f"{warmup} warmup steps")
    alpha = end / peak

    def lr(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(count) / f32(warmup)
            return float(f32(init - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay - warmup))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay - warmup)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return lr


def create_train_state(cfg: TrainConfig, generator: torch.Generator,
                       device="cuda", dtype: torch.dtype = torch.bfloat16
                       ) -> TrainState:
    """A fresh state: ``UNet(features=cfg.features)`` computing in *dtype*
    (bf16 by default, as JAX's) over float32 parameters from
    :func:`flax_init_`, on *device*; AdamW (fused on a card) and, with
    ``cfg.decay_steps``, the warmup-cosine schedule.  Raises for a CUDA
    device without a card."""
    dev = resolve_device(device)
    model = flax_init_(UNet(features=cfg.features, dtype=dtype), generator).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay,
                            fused=dev.type == "cuda")
    sched = None
    if cfg.decay_steps:
        lr = warmup_cosine_lr(cfg)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: lr(k) / cfg.lr)
    # the parameters' device carries the index ("cuda:0"), as a mesh's do
    return TrainState(model, opt, sched, next(model.parameters()).device)


def zero_gradient_biases(model: UNet) -> List[str]:
    """state_dict names of the conv biases whose true gradient is zero:
    each feeds a GroupNorm with one channel per group (module docstring)."""
    return [f"{name}.conv{i}.bias" for name, mod in model.named_modules()
            if isinstance(mod, ConvBlock) for i in (0, 1)
            if getattr(mod, f"gn{i}").num_groups == getattr(mod, f"gn{i}").num_channels]


def _loss_fn(model: UNet, imgs: torch.Tensor, probs: torch.Tensor,
             grads_t: torch.Tensor, w_grad: float) -> torch.Tensor:
    """JAX's ``_loss_fn`` in NCHW: imgs (B, 1, T, T), probs (B, T, T),
    grads_t (B, 2, T, T)."""
    out = model(imgs)
    logit = out[:, 0]
    # optax.sigmoid_binary_cross_entropy
    bce = (-probs * F.logsigmoid(logit) - (1.0 - probs) * F.logsigmoid(-logit)).mean()
    p = torch.sigmoid(logit)
    inter = (p * probs).sum(dim=(1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (p.sum(dim=(1, 2)) + probs.sum(dim=(1, 2)) + 1.0)
    grad_l2 = ((out[:, 1:] - grads_t) ** 2).mean()
    return bce + dice.mean() + w_grad * grad_l2


def _batch(imgs, probs, grads_t, dev: torch.device):
    """JAX's layouts (numpy arrays or tensors) -> NCHW float32 on *dev*."""
    def put(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, non_blocking=True)

    return put(imgs).permute(0, 3, 1, 2), put(probs), put(grads_t).permute(0, 3, 1, 2)


def _apply(state: TrainState) -> None:
    """One optimizer update from the parameters' ``.grad``, the schedule
    advanced to the next count."""
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1


def train_step(state: TrainState, imgs, probs, grads_t, w_grad: float = 0.5
               ) -> Tuple[TrainState, torch.Tensor]:
    """One optimization step, in place. imgs: (B, T, T, 1) f32; probs:
    (B, T, T) in {0,1}; grads_t: (B, T, T, 2) flow targets (JAX's layouts,
    numpy arrays or tensors).  Returns the state and the loss as a 0-d
    tensor on the state's device (no host sync); the parameters' ``.grad``
    keep this step's gradients.  float32 convolutions run without TF32."""
    dev = resolve_device(state.device)
    x, p, g = _batch(imgs, probs, grads_t, dev)
    state.optimizer.zero_grad(set_to_none=True)
    with no_tf32():
        loss = _loss_fn(state.model, x, p, g, w_grad)
        loss.backward()
    _apply(state)
    return state, loss.detach()


def make_sharded_train_step(mesh, w_grad: float = 0.5) -> Callable:
    """The same full step with the batch split over *mesh*
    (``parallel.runner.Mesh``), pure data parallelism in one process: each
    shard's contiguous block (``shard_bounds``) runs its forward and
    backward on its device with a replica of the model (the state's own
    model on the state's device, which must be the mesh's first), every
    block enqueued before any gradient is read; the gradients and losses
    are averaged on the first device and one optimizer step follows.  Each
    replica takes the state's parameters at the start of a step, so a
    state also stepped by :func:`train_step` in between stays in sync.  A virtual mesh (one device
    repeated) runs its n block steps on the one model.  Returns
    ``step(state, imgs, probs, grads_t) -> (state, global mean loss)``."""
    from ..parallel.runner import shard_bounds

    replicas: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def step(state: TrainState, imgs, probs, grads_t):
        dev0 = resolve_device(state.device)
        if mesh.devices[0] != dev0:
            raise ValueError(f"the state lives on {dev0}, the mesh's first device "
                             f"is {mesh.devices[0]}")
        own = replicas.setdefault(state.model, {})
        with torch.no_grad():
            for dev in set(mesh.devices) - {dev0}:
                if dev not in own:
                    own[dev] = UNet(state.model.features, dtype=state.model.dtype).to(dev)
                for r, prm in zip(own[dev].parameters(), state.model.parameters()):
                    r.copy_(prm, non_blocking=True)
        blocks = []
        for dev, (lo, hi) in zip(mesh.devices, shard_bounds(mesh, len(imgs))):
            model = state.model if dev == dev0 else own[dev]
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()), no_tf32():
                x, p, g = _batch(imgs[lo:hi], probs[lo:hi], grads_t[lo:hi], dev)
                loss = _loss_fn(model, x, p, g, w_grad)
                blocks.append((loss.detach(),
                               torch.autograd.grad(loss, list(model.parameters()))))
        n = len(blocks)
        with torch.no_grad():
            for i, prm in enumerate(state.model.parameters()):
                prm.grad = sum(b[1][i].to(dev0) for b in blocks) / n
            loss = sum(b[0].to(dev0) for b in blocks) / n
        _apply(state)
        return state, loss

    return step


def synthetic_batch(rng: np.random.Generator, batch: int, tile: int):
    """Synthetic blob images + masks + flow targets for smoke training and
    the multi-device dry run (no data dependency); a copy of the JAX
    package's, equal for the same generator."""
    imgs = rng.normal(0.1, 0.05, (batch, tile, tile, 1)).astype(np.float32)
    probs = np.zeros((batch, tile, tile), np.float32)
    grads = np.zeros((batch, tile, tile, 2), np.float32)
    yy, xx = np.mgrid[0:tile, 0:tile]
    margin = min(20, tile // 4)
    r_hi = max(5, min(18, tile // 4))
    for b in range(batch):
        for _ in range(rng.integers(2, 5)):
            cy, cx = rng.integers(margin, tile - margin, 2)
            r = rng.integers(max(3, r_hi // 2), r_hi)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            blob = d2 <= r * r
            imgs[b, ..., 0] += 0.8 * np.exp(-d2 / (2.0 * r * r))
            probs[b][blob] = 1.0
            norm = np.sqrt(d2) + 1e-6
            grads[b, ..., 0] = np.where(blob, (cy - yy) / norm, grads[b, ..., 0])
            grads[b, ..., 1] = np.where(blob, (cx - xx) / norm, grads[b, ..., 1])
    return imgs, probs, grads
