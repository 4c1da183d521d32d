"""Training traffic: `Trainer.train_step` over batches collated ahead.

The traffic file gives the batch size, how many distinct batches there
are, the scene generator's arguments and how many steps the reference
follows. Set-up makes the scenes and the weights from the seed, collates
each batch with the port's collator and pins it on the host, builds the
trainer with `build_trainer(torch.float32)` and the configuration's
settings, loads the seeded weights, and takes one step on each batch
through the window's own call and feed: the first `reference_steps` of
them are what the reference follows, and together they warm every shape
the window uses. The window cycles the batches: each step copies its
pinned batch to the card and trains on it.

After the window the program is freed and the reference
(`portbench/reference/train.py`) trains from the same weights on the same
raw scenes; the compared numbers are

  loss_gap_first  |loss - reference| / |reference| of the first step
  loss_gap    the largest of those over the steps
  grad_gap    the first gradient, as AdamW's first moment holds it after
              one step, by the worst parameter: | |g| - |g_ref| | over the
              larger of |g_ref| and the median parameter's |g_ref|
  change_gap  the parameters' change after the steps, the same way, over
              the parameters whose reference gradient is at least 1e-3 of
              the median parameter's (the rest move by rounding alone)
  mask_flip_share, mask_flip_depth(_first), match_cost_gap
              the checks of the program's block masks and matchings, which
              the reference replays (`reference.train.Decisions`): rounding
              tips a readout at 0 or an auction tie, and either moves the
              losses by far more than rounding
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from portbench import scenes as scene_gen
from portbench.reference import train as reference
from portbench.work import mask3d as work

_GRAD_FLOOR = 1e-3


def make_scenes(traffic: dict, seed: int) -> list[list[dict]]:
    """traffic["batches"] lists of traffic["batch_size"] raw scenes."""
    return [[scene_gen.make_scene(**traffic["scene"],
                                  seed=scene_gen.scene_seed(seed, j, i))
             for i in range(traffic["batch_size"])]
            for j in range(traffic["batches"])]


def make_state(names_shapes, seed: int, device) -> dict:
    """Seeded weights for Mask3D(Res16UNet34C), made on the device in one
    draw: sparse conv kernels normal with std sqrt(2 / fan_out), dense
    weights normal with std sqrt(1 / fan_in), the positional encoding's
    Gaussian matrix normal(1), drawn in the order of the sorted names;
    biases zero; norms and running statistics at identity."""
    gen = torch.Generator(device=device).manual_seed(
        scene_gen.scene_seed(seed, 1_000_003))
    drawn = sorted((n, s) for n, s in names_shapes
                   if n.endswith(".kernel") or n.endswith("gauss_B")
                   or (n.endswith(".weight") and len(s) == 2))
    total = sum(int(np.prod(s)) for _, s in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n, s in drawn:
        k = int(np.prod(s))
        if n.endswith(".kernel"):
            fan = s[-1] * (s[0] if len(s) == 3 else 1)
            std = (2.0 / fan) ** 0.5
        elif n.endswith("gauss_B"):
            std = 1.0
        else:
            std = (1.0 / s[1]) ** 0.5
        out[n] = (flat[at:at + k] * std).view(s)
        at += k
    for n, s in names_shapes:
        if n not in out:
            one = n.endswith(".var") or n.endswith(".scale") or (
                n.endswith(".weight") and len(s) == 1)
            out[n] = (torch.ones if one else torch.zeros)(s, device=device)
    return out


class _recorded_masks:
    """While open, each decoder round of the program's Mask3D appends the
    block mask it computed ((B, P, Q) bool, before the all-blocked rule) to
    a new entry of `into`."""

    def __init__(self, into):
        self.into = into

    def __enter__(self):
        if self.into is None:
            return
        from unscene3d_torch.models import mask3d

        self.mod, self.orig = mask3d, mask3d._attend_level
        masks = []
        self.into.append(dict(masks=masks, match=None))
        orig = self.orig

        def attend(layers, queries, query_pos, blocked, *a, **k):
            masks.append(blocked.cpu())
            return orig(layers, queries, query_pos, blocked, *a, **k)
        mask3d._attend_level = attend

    def __exit__(self, *exc):
        if self.into is not None:
            self.mod._attend_level = self.orig


def _pin(obj):
    """A copy of a (nested) dataclass batch with its tensors pinned."""
    if isinstance(obj, torch.Tensor):
        return obj.pin_memory() if torch.cuda.is_available() else obj
    if isinstance(obj, tuple):
        return tuple(_pin(e) for e in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _pin(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(got, ref, keep=None) -> float:
    """Worst leaf of | |got| - |ref| | / max(|ref|, median |ref|)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if keep is not None:
        got, ref = got[keep], ref[keep]
    floor = statistics.median(ref.tolist())
    return float(np.max(np.abs(got - ref) / np.maximum(ref, floor)))


class TrainRun:
    unit = "scenes"

    def __init__(self, cell, seed: int, device):
        from unscene3d_torch.data.collate import FreeMaskCollator
        from unscene3d_torch.train.loop import build_trainer

        self.cell, self.seed, self.device = cell, int(seed), device
        tr, conf = cell.traffic, cell.config
        # the products as the configuration states them (f32: TF32 off)
        torch.backends.cuda.matmul.allow_tf32 = conf["train"]["tf32"]
        torch.backends.cudnn.allow_tf32 = conf["train"]["tf32"]
        t = [time.perf_counter()]
        self.opt = dict(conf["train"], **conf["data"],
                        fps_queries=conf["model"]["num_queries"])
        self.scenes = make_scenes(tr, seed)
        collator = FreeMaskCollator(voxel_size=conf["data"]["voxel_size"],
                                    fps_queries=conf["model"]["num_queries"])
        t.append(time.perf_counter())
        self.host = [_pin(collator(s)[0]) for s in self.scenes]
        t.append(time.perf_counter())
        m = conf["model"]
        self.trainer = build_trainer(
            torch.float32, seed=None, backbone=m["backbone"],
            lr=self.opt["lr"], total_steps=self.opt["total_steps"],
            schedule=self.opt["schedule"],
            weight_decay=self.opt["weight_decay"], solver=self.opt["matcher"],
            device=device)
        sd = self.trainer.model.state_dict()
        self.trainer.model.load_state_dict(
            make_state([(n, tuple(v.shape)) for n, v in sd.items()], seed,
                       device))
        t.append(time.perf_counter())
        self.gen = torch.Generator(device=device).manual_seed(
            scene_gen.scene_seed(seed, 7))
        self.i = 0
        self.finite = []
        self.batch_of_step = []
        self.marks = None
        # the first steps: the reference follows them; one step on each
        # batch warms every shape of the window
        params = self.trainer.params
        self.names = [n for n, _ in self.trainer.model.named_parameters()]
        start = [p.detach().clone() for p in params]
        self.losses, self.grad_norms, self.change_norms = [], None, None
        n_ref = tr["reference_steps"]
        self.decisions = []
        for k in range(max(n_ref, len(self.host))):
            with _recorded_masks(self.decisions if k < n_ref else None):
                losses = self._step()
            if k < n_ref:
                self.losses.append(float(losses["total"]))
                self.decisions[-1]["match"] = losses["matched_q"].cpu()
            if k == 0:
                b1 = self.trainer.optimizer.b1
                self.grad_norms = torch.stack(
                    [(m_ / (1 - b1)).norm()
                     for m_ in self.trainer.optimizer.mu]).cpu()
            if k == n_ref - 1:
                self.change_norms = torch.stack(
                    [(p.detach() - s).norm() for p, s in zip(params, start)]
                ).cpu()
                del start
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t.append(time.perf_counter())
        self.finite.clear()
        self.batch_of_step.clear()
        print("set-up: scenes %.3f s, collate %.3f s, trainer and weights "
              "%.3f s, first steps %.3f s" % tuple(
                  b - a for a, b in zip(t, t[1:])), file=sys.stderr)

    def _step(self):
        j = self.i % len(self.host)
        if self.marks:
            self.marks.mark("h2d")
        batch = self.host[j].to(self.device, non_blocking=True)
        losses = self.trainer.train_step(batch, self.gen)
        self.finite.append(torch.isfinite(losses["total"]))
        self.batch_of_step.append(j)
        self.i += 1
        return losses

    def step(self) -> int:
        """One timed unit of work; returns the scenes it trained on."""
        self._step()
        return self.cell.traffic["batch_size"]

    def failed(self) -> int:
        return int(sum(int(not bool(f)) for f in self.finite))

    # ------------------------------------------------- traced runs only
    def instrument(self, spans, marks):
        """CUDA-event spans around the backbone's forward and the
        criterion, and host marks at each phase of a step."""
        t = self.trainer
        self.marks = marks

        def backbone_pre(*_):
            marks.mark("backbone")
            spans.start("backbone")

        def backbone_post(*_):
            spans.stop("backbone")
            marks.mark("decoder")

        t.model.backbone.register_forward_pre_hook(backbone_pre)
        t.model.backbone.register_forward_hook(backbone_post)
        crit = t.criterion

        def criterion(outputs, batch):
            marks.mark("criterion")
            spans.start("criterion")
            out = crit(outputs, batch)
            spans.stop("criterion")
            marks.mark("backward")
            return out
        t.criterion = criterion
        opt_step = t.optimizer.step

        def optimizer_step(params, grads):
            marks.mark("adamw")
            opt_step(params, grads)
            marks.mark("host between steps")
        t.optimizer.step = optimizer_step

    def work(self) -> dict:
        """The work of the window's steps, for the per-layer readers."""
        per_batch = []
        for b in self.host:
            s = work.shape_summary(
                [(lv.valid, lv.nbr_idx, lv.child_idx, lv.up_idx)
                 for lv in b.graph.levels], b.scene_valid, b.seg_valid)
            per_batch.append(_named(self.cell.config["work"])(
                s, self.cell.config["model"]))
        steps = [per_batch[j] for j in self.batch_of_step]
        return dict(steps=len(steps), flops=sum(s["flops"] for s in steps),
                    conv_items=[it for s in steps for it in s["conv_items"]])

    # ------------------------------------------------- after the window
    def release(self):
        """Free the program's state before the reference runs."""
        del self.trainer, self.host
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def follow(self, tf32: bool = False, batches=None, replay=None):
        """The reference's readings over the first steps' scenes (or over
        `batches`, collated by `reference.collate_all`), with TF32 products
        where `tf32`, replaying the decisions `replay` (a list of steps'
        block masks and matchings) or recording its own."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            if batches is None:
                n = self.cell.traffic["reference_steps"]
                batches = reference.collate_all(self.scenes[:n], self.opt,
                                                self.device)
            return _named(self.cell.config["reference"])(
                make_state(_state_shapes(), self.seed, self.device),
                batches, scene_gen.scene_seed(self.seed, 7), self.device,
                self.opt, reference.Decisions(replay))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def readings(self) -> dict:
        return dict(losses=self.losses, grad_norms=self.grad_norms,
                    change_norms=self.change_norms, names=self.names)

    def check(self, ref=None) -> dict:
        """The compared numbers of the program's first steps against the
        reference's (run here unless `ref` is given)."""
        ref = self.follow(replay=self.decisions) if ref is None else ref
        return compare(self.readings(), ref)


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers of `got` against `ref` (readings with the
    parameter names), parameters matched by name."""
    at = {n: i for i, n in enumerate(got["names"])}
    order = [at[n] for n in ref["names"]]
    g_ref = np.asarray(ref["grad_norms"], np.float64)
    keep = g_ref >= _GRAD_FLOOR * statistics.median(g_ref.tolist())
    return dict(
        loss_gap_first=gap(got["losses"][0], ref["losses"][0]),
        loss_gap=max(gap(a, b) for a, b in zip(got["losses"],
                                               ref["losses"])),
        grad_gap=leaf_gap(np.asarray(got["grad_norms"])[order], g_ref),
        change_gap=leaf_gap(np.asarray(got["change_norms"])[order],
                            ref["change_norms"], keep),
        mask_flip_share=ref["decisions"].mask_flip_share,
        mask_flip_depth=ref["decisions"].flip_depth,
        mask_flip_depth_first=ref["decisions"].flip_depth_first,
        match_cost_gap=ref["decisions"].match_cost_gap)


def _named(dotted: str):
    """The function at a dotted path, as a configuration names it."""
    import importlib

    mod, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(mod), name)


def _state_shapes():
    """(name, shape) of the reference model's state, in its order."""
    from portbench.reference.model import Mask3D
    with torch.device("meta"):
        m = Mask3D()
    return [(n, tuple(t.shape)) for n, t in m.state_dict().items()]


def setup(cell, seed: int, device) -> TrainRun:
    return TrainRun(cell, seed, device)
