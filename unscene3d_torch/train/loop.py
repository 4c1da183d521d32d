"""The Mask3D train step (counterpart of unscene3d_tpu/train/loop.py,
single device): AdamW with the reference's schedules, and the Trainer that
runs forward (train), criterion, backward, the AdamW update and the
BatchNorm running-statistics update.

    trainer = build_trainer(torch.bfloat16, seed=0, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    losses = trainer.train_step(batch.to("cuda"), gen)

Parameters are f32 masters, cast to the compute dtype at each call (as
flax casts them); losses, BatchNorm statistics and the optimizer state stay
f32. `Trainer.accum_train_step` is the JAX package's
`build_accum_train_step` (gradients averaged over micro-batches, then one
AdamW step); `Trainer.state_dict` / `load_state_dict` are the train state
that train/checkpoint.py saves.

Data parallelism (the JAX `_step_core(..., axis="data")` under
`shard_map`): a Trainer given a process group (`group`, one rank per card,
parallel/distributed.py) takes each rank's gradients on its own batch
shard with its own generator, then averages the gradients, the float
losses and every BatchNorm's updated running statistics over the ranks in
one all-reduce of one flat f32 buffer (the JAX step's `lax.pmean` of
grads, losses and `new_bs`: each shard's own batch statistics, then the
mean; there is no SyncBatchNorm, as the JAX package has none), then takes
one AdamW step. It is an explicit all-reduce and not
`DistributedDataParallel`: the gradients come from `torch.autograd.grad`,
which DDP's hooks never see. At world size 1 the step is bitwise the step
without a group. Gradient accumulation under a group raises, as the JAX
package's `Experiment` does.

With the noise-robust loss on (`weight_noise_robust` != 0, batches collated
with `build_triplane=True`) the JAX trainer asks the model for the voxel
logits of every prediction set (`return_aux_vox`, loop.py:128). The port's
criterion gathers the matched columns from the segment logits instead (the
voxel logits are an exact take of them), so the trainer does not ask for
that (L, N0, Q) stack: 4.8 GB in f32 at the batch-8 train batch.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

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

    def state_dict(self) -> dict:
        """The moments (in `params` order) and the step count."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
        self.count = int(state["count"])

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
    live on one device. `step` counts the optimizer steps taken (the JAX
    TrainState's `step`)."""

    def __init__(self, model, criterion: SetCriterion, optimizer: AdamW,
                 group=None):
        self.model = model.train()
        self.criterion = criterion
        self.optimizer = optimizer
        self._bns = [m for m in model.modules()
                     if isinstance(m, SparseBatchNorm)]
        self.optimizer.init(self.params)
        self.step = 0
        # the data-parallel process group (None: one device)
        self.group = group
        self._comm = None       # the last all-reduce: (bytes, timer)

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
        Returns the criterion's loss dict. Under a process group the
        gradients, the float losses and the BN running statistics are the
        means over the ranks before the AdamW step (`matched_q` stays the
        rank's own)."""
        losses, grads = self.loss_and_grads(batch, generator)
        for bn in self._bns:
            bn.update_running_stats()
        if self.group is not None:
            grads, losses = self._all_reduce_mean(grads, losses)
        self.optimizer.step(self.params, grads)
        self.step += 1
        return losses

    def _all_reduce_mean(self, grads, losses):
        """The ranks' mean of the gradients, the float losses and every
        BatchNorm's running mean and variance (in place), through one
        all-reduce of one flat f32 buffer: a sum, then a division by the
        world size, the JAX step's `lax.pmean`."""
        keys = [k for k, v in losses.items() if v.is_floating_point()]
        stats = [t for bn in self._bns for t in (bn.mean, bn.var)]
        parts = list(grads) + stats + [losses[k] for k in keys]
        if any(p.dtype != torch.float32 for p in parts):
            raise TypeError("the all-reduce averages f32 tensors only")
        flat = torch.cat([p.reshape(-1) for p in parts])
        timer = _Timer(flat.device)
        dist.all_reduce(flat, group=self.group)
        timer.stop()
        flat.div_(dist.get_world_size(self.group))
        self._comm = (flat.numel() * flat.element_size(), timer)
        out = [v.view_as(p) for p, v in
               zip(parts, flat.split([p.numel() for p in parts]))]
        n = len(grads)
        for t, v in zip(stats, out[n:n + len(stats)]):
            t.copy_(v)
        losses = dict(losses, **dict(zip(keys, out[n + len(stats):])))
        return out[:n], losses

    def last_all_reduce(self) -> tuple[int, float] | None:
        """(bytes, milliseconds) of the last step's all-reduce, or None
        without a group. On a GPU the time is between CUDA events around
        the collective on the current stream (it waits for the step's
        earlier work first)."""
        if self._comm is None:
            return None
        nbytes, timer = self._comm
        return nbytes, timer.ms()

    def accum_train_step(self, batches, generator=None) -> dict:
        """One optimizer step over micro-batches (the JAX package's
        `build_accum_train_step`): forward, criterion and backward of each
        micro-batch in turn, its BatchNorm running statistics updated
        before the next one runs, the gradients summed and divided by the
        count, then one AdamW step. Returns each float loss averaged over
        the micro-batches. Raises ValueError under a process group: the JAX
        package does not compose accumulation with data parallelism."""
        if self.group is not None:
            raise ValueError("gradient accumulation is not composed with "
                             "data parallelism (a process group)")
        total, per_micro = None, []
        for batch in batches:
            losses, grads = self.loss_and_grads(batch, generator)
            for bn in self._bns:
                bn.update_running_stats()
            total = grads if total is None else torch._foreach_add(total,
                                                                   grads)
            per_micro.append(losses)
        torch._foreach_div_(total, len(per_micro))
        self.optimizer.step(self.params, total)
        self.step += 1
        return {k: torch.stack([m[k] for m in per_micro]).mean(0)
                for k, v in per_micro[0].items() if v.is_floating_point()}

    def state_dict(self) -> dict:
        """The train state of train/checkpoint.py: the step, the model's
        state_dict (parameters, BatchNorm running statistics, buffers) and
        AdamW's moments and count."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Exact restore of `state_dict()`'s layout, on the model's
        device."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


class _Timer:
    """Milliseconds between construction and `stop()`: CUDA events on a
    GPU (read when `ms()` is called), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.events[1].record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.events[1].synchronize()
            return self.events[0].elapsed_time(self.events[1])
        return 1e3 * (self.t1 - self.t0)


def build_trainer(dtype=torch.float32, seed: int | None = 0,
                  backbone: str = "Res16UNet34C", lr: float = 1e-4,
                  total_steps: int = 10000, schedule: str = "onecycle",
                  weight_decay: float = 1e-2,
                  solver: str = "auction", device="cuda",
                  weight_noise_robust: float = 0.0, group=None,
                  **model_kw) -> Trainer:
    """Mask3D(`backbone`) at conf/model/mask3d.yaml's widths with f32
    master params (seeded random unless seed is None), the set criterion of
    conf/loss/set_criterion.yaml (CE / mask BCE / dice weighted 2 / 5 / 2,
    eos 0.1, matcher costs the same) and AdamW of conf/optimizer/adamw.yaml
    (lr 1e-4, weight decay 1e-2) under the onecycle schedule;
    `weight_noise_robust` weighs the tri-plane loss (its batches need
    `build_triplane=True`), `group` is the data-parallel process group
    (None: one device), `model_kw` reach Mask3D. Residual
    blocks are rematerialised in the backward (models/backbone.py). The
    model and the optimizer state live on `device`: the GPU unless the
    caller asks for 'cpu' ('cuda' raises without a GPU)."""
    model = build_mask3d(dtype, backbone=backbone, seed=None,
                         **model_kw).float()
    if seed is not None:
        init_random_(model, seed)
    model.to(resolve_device(device))
    matcher = HungarianMatcher(cost_class=2.0, cost_mask=5.0, cost_dice=2.0,
                               solver=solver)
    criterion = SetCriterion(matcher, num_classes=model.num_classes,
                             eos_coef=0.1, weight_ce=2.0, weight_mask=5.0,
                             weight_dice=2.0,
                             weight_noise_robust=weight_noise_robust)
    return Trainer(model, criterion,
                   make_optimizer(lr, total_steps, schedule, weight_decay),
                   group=group)
