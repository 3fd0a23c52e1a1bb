"""Supervised training of the learned-flow models (reference
``parallel/train.py``): RAFT's sequence loss, the optimizer, a train state
and one step.

The optimizer is the reference's optax chain, written out:
``clip_by_global_norm(clip)`` then ``adamw(lr, weight_decay)``.  What a
look-alike from ``torch.optim`` would change:

- the clip scales the gradients by ``clip / |g|`` only when the global
  norm |g| >= ``clip``, with no epsilon added to the norm
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and always scales);
- Adam's eps is added to sqrt(v_hat) after the bias corrections;
- the decoupled decay ``weight_decay * p`` is added to the Adam direction
  of every parameter, biases included, before the step size multiplies
  both (``torch.optim.AdamW``'s default decay is 0.01, and it decays
  before the Adam update);
- the k-th update takes the step size ``lr(k - 1)`` of a schedule: a
  warm-up from 0 moves no parameter on the first update, decay included.

Batches keep the reference's layout: ``img1``, ``img2`` [B, H, W, 3] and
``flow`` [B, H, W, 2] (numpy or tensors); :func:`batch_to_device` hands
the models NCHW tensors.  Unlike the reference, which ``vmap``s a
per-sample loss and takes the mean, the models run on the batch; every
loss here is a mean over equally sized samples, so the two agree.

The sharded step (``make_sharded_train_step``) waits for the port's
``torch.distributed`` slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from ..models.common import flax_init


# optax.adamw's defaults, which every caller of the reference keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(lr, weight_decay))``
    over the named parameters ``params`` (module docstring).  ``lr`` is a
    number or a schedule of the update count.  :meth:`step` reads each
    parameter's ``.grad`` (None counts as 0) and updates the parameters in
    place."""

    def __init__(self, params: Mapping[str, nn.Parameter],
                 lr: float | Callable[[int], float], weight_decay: float,
                 clip: float = 1.0):
        self.params = dict(params)
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.weight_decay = weight_decay
        self.clip = clip
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        names = list(self.params)
        ps = [self.params[k] for k in names]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        # on the device: no sync to decide; below the clip, times 1
        gs = torch._foreach_mul(gs, torch.where(
            norm < self.clip, torch.ones_like(norm), self.clip / norm))
        mu = [self.mu[k] for k in names]
        nu = [self.nu[k] for k in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, gs, alpha=1 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - B2)
        self.count += 1
        # the bias corrections in fp32, as optax computes them: 0.999 in
        # fp32 makes 1 - b2 1.3e-5 smaller than in fp64
        f32 = np.float32
        mu_hat = torch._foreach_div(mu, float(f32(1) - f32(B1) ** f32(self.count)))
        den = torch._foreach_div(nu, float(f32(1) - f32(B2) ** f32(self.count)))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        # the schedule at the count before this update, as optax's
        torch._foreach_mul_(upd, -float(self.lr(self.count - 1)))
        torch._foreach_add_(ps, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.params):
            raise ValueError("optimizer state for other parameters: "
                             f"{sorted(set(state['mu']) ^ set(self.params))[:10]}")
        self.count = int(state["count"])
        for k, p in self.params.items():
            self.mu[k] = state["mu"][k].to(p.device, p.dtype).clone()
            self.nu[k] = state["nu"][k].to(p.device, p.dtype).clone()


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` at ``decay_steps``, which counts the warm-up; in float32
    as optax computes it.  Raises, as optax does, when ``decay_steps`` does
    not exceed the warm-up."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine decay needs decay_steps ({decay_steps}) "
                         f"above warmup_steps ({warmup_steps})")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            if warmup_steps <= 0:
                return float(f32(init_value))
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = min(f32(count - warmup_steps), cos_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / cos_steps,
                                             dtype=f32))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def make_optimizer(params: Mapping[str, nn.Parameter], lr=4e-4,
                   weight_decay: float = 1e-5, clip: float = 1.0) -> AdamW:
    """The reference's ``make_optimizer``: clip 1.0, AdamW with decay
    1e-5."""
    return AdamW(params, lr, weight_decay, clip)


@dataclasses.dataclass
class TrainState:
    """A model, its optimizer and the count of steps taken (the
    reference's ``TrainState``: params, opt_state, step).  The model holds
    the parameters and is updated in place."""

    model: nn.Module
    optimizer: AdamW
    step: int = 0


def make_train_state(model: nn.Module, generator: torch.Generator,
                     lr: float = 4e-4) -> TrainState:
    """``model`` initialised as the reference's ``model.init``
    (:func:`~..models.common.flax_init`, from ``generator``) with
    :func:`make_optimizer` over all its parameters, at step 0."""
    flax_init(model, generator)
    return TrainState(model, make_optimizer(dict(model.named_parameters()), lr))


def batch_to_device(batch: Mapping, device) -> dict[str, torch.Tensor]:
    """``batch`` (``img1``, ``img2`` [B, H, W, 3], ``flow`` [B, H, W, 2],
    numpy or tensors) as fp32 NCHW tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(
                v, np.ndarray) else v).to(device, torch.float32).permute(
                    0, 3, 1, 2) for k, v in batch.items()}


def sequence_loss(flows: torch.Tensor, gt: torch.Tensor,
                  gamma: float = 0.8) -> torch.Tensor:
    """``sum_i gamma^(N-1-i) |flows[i] - gt|``'s mean, for the stacked
    flows [N, B, 2, H, W] and the ground truth [B, 2, H, W]: the mean over
    the batch of the reference's per-sample loss."""
    n = flows.shape[0]
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flows.device)
    err = (flows - gt[None]).abs().mean(dim=(1, 2, 3, 4))
    return (weights * err).sum()


def descend(state: TrainState, loss: torch.Tensor) -> TrainState:
    """One optimizer step on ``loss``: its gradients, the update, the
    count."""
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state


def train_step(state: TrainState, batch: Mapping,
               iters: int = 4) -> tuple[TrainState, torch.Tensor]:
    """The reference's ``train_step`` for RAFT: the sequence loss of the
    ``iters`` flows of ``batch`` (reference layout, moved to the model's
    device) and one optimizer step.  Returns the state and the loss."""
    model = state.model
    b = batch_to_device(batch, next(model.parameters()).device)
    loss = sequence_loss(model(b["img1"], b["img2"], iters), b["flow"])
    return descend(state, loss), loss.detach()
