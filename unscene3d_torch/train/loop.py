"""The Mask3D train step (counterpart of unscene3d_tpu/train/loop.py,
single device): AdamW with the reference's schedules, and the Trainer that
runs forward (train), criterion, backward, the AdamW update and the
BatchNorm running-statistics update.

    trainer = build_trainer(torch.bfloat16, seed=0, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    losses = trainer.train_step(batch.to("cuda"), gen)

Parameters are f32 masters, cast to the compute dtype at each call (as
flax casts them); losses, BatchNorm statistics and the optimizer state stay
f32. Gradient accumulation, data parallelism, augmentations, prefetch and
checkpoints are not ported yet.
"""

from __future__ import annotations

import math

import torch

from unscene3d_torch.inference import build_mask3d
from unscene3d_torch.losses.criterion import SetCriterion
from unscene3d_torch.losses.matcher import HungarianMatcher
from unscene3d_torch.models.sparse_modules import SparseBatchNorm
from unscene3d_torch.models.weights import init_random_
from unscene3d_torch.runtime import resolve_device


def onecycle_schedule(peak_value: float, transition_steps: int,
                      pct_start: float = 0.3, div_factor: float = 25.0,
                      final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule written out (it is not torch's
    OneCycleLR): values peak/div, peak and peak/(div * final_div) at steps
    0, int(pct_start * T) and int(T), cosine interpolation between them,
    the last value from step T on."""
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    init = peak_value / div_factor
    values = (init, init * div_factor,
              init * div_factor / (div_factor * final_div_factor))

    def schedule(count: int) -> float:
        for b0, b1, v0, v1 in zip(bounds[:-1], bounds[1:], values[:-1],
                                  values[1:]):
            if b0 <= count < b1:
                pct = (count - b0) / (b1 - b0)
                return v1 + (v0 - v1) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


class AdamW:
    """optax.adamw (scale_by_adam, add_decayed_weights, scale by -lr):

        m = (1 - b1) g + b1 m;  v = (1 - b2) g^2 + b2 v;  c = step + 1
        u = (m / (1 - b1^c)) / (sqrt(v / (1 - b2^c)) + eps) + wd * p
        p = p - lr(step) * u

    Decay applies to every parameter, as in optax. Multi-tensor updates
    (torch._foreach_*) in place."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = self.nu = None

    def init(self, params) -> None:
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads) -> None:
        b1, b2 = self.b1, self.b2
        lr = float(self.schedule(self.count))
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, sq)
        upd = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        den = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


def make_optimizer(lr: float = 1e-4, total_steps: int = 10000,
                   schedule: str = "onecycle", weight_decay: float = 1e-2,
                   gamma: float = 0.99999) -> AdamW:
    """AdamW + the reference's scheduler menu, with the numbers of
    unscene3d_tpu/train/loop.py:make_optimizer: 'onecycle' (cosine, pct_start
    0.3, div 25, final div 1e4, over max(total_steps, 10) steps),
    'exponential' (lr * gamma^step) or 'constant'."""
    if schedule == "onecycle":
        sched = onecycle_schedule(lr, max(total_steps, 10))
    elif schedule == "exponential":
        def sched(count):
            return lr * gamma ** count
    elif schedule == "constant":
        def sched(count):
            return lr
    else:
        raise ValueError(schedule)
    return AdamW(sched, weight_decay=weight_decay)


class Trainer:
    """Owns the model (f32 master params), the criterion and the optimizer
    state. The model, its batches and the generator of the point samples
    live on one device."""

    def __init__(self, model, criterion: SetCriterion, optimizer: AdamW):
        self.model = model.train()
        self.criterion = criterion
        self.optimizer = optimizer
        self._bns = [m for m in model.modules()
                     if isinstance(m, SparseBatchNorm)]
        self.optimizer.init(self.params)

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def loss_and_grads(self, batch, generator=None):
        """Forward (train) + criterion + backward. Returns (losses,
        gradients in `params` order). A parameter the loss does not reach
        gets a zero gradient: AdamW still decays it, as optax does."""
        outputs = self.model(batch, generator=generator)
        losses = self.criterion(outputs, batch)
        params = self.params
        grads = torch.autograd.grad(losses["total"], params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return {k: v.detach() for k, v in losses.items()}, grads

    def train_step(self, batch, generator=None) -> dict:
        """One step: forward, criterion, backward, AdamW, BN running stats.
        Returns the criterion's loss dict."""
        losses, grads = self.loss_and_grads(batch, generator)
        self.optimizer.step(self.params, grads)
        for bn in self._bns:
            bn.update_running_stats()
        return losses


def build_trainer(dtype=torch.float32, seed: int | None = 0,
                  backbone: str = "Res16UNet34C", lr: float = 1e-4,
                  total_steps: int = 10000, schedule: str = "onecycle",
                  weight_decay: float = 1e-2,
                  solver: str = "auction", device="cpu",
                  **model_kw) -> Trainer:
    """Mask3D(`backbone`) at conf/model/mask3d.yaml's widths with f32
    master params (seeded random unless seed is None), the set criterion of
    conf/loss/set_criterion.yaml (CE / mask BCE / dice weighted 2 / 5 / 2,
    eos 0.1, matcher costs the same) and AdamW of conf/optimizer/adamw.yaml
    (lr 1e-4, weight decay 1e-2) under the onecycle schedule. Residual
    blocks are rematerialised in the backward (models/backbone.py). The
    model and the optimizer state live on `device` ('cuda'
    needs a GPU and raises without one)."""
    model = build_mask3d(dtype, backbone=backbone, seed=None,
                         **model_kw).float()
    if seed is not None:
        init_random_(model, seed)
    model.to(resolve_device(device))
    matcher = HungarianMatcher(cost_class=2.0, cost_mask=5.0, cost_dice=2.0,
                               solver=solver)
    criterion = SetCriterion(matcher, num_classes=model.num_classes,
                             eos_coef=0.1, weight_ce=2.0, weight_mask=5.0,
                             weight_dice=2.0)
    return Trainer(model, criterion,
                   make_optimizer(lr, total_steps, schedule, weight_decay))
