"""Experiment orchestration of the self-training round (the port of
unscene3d_tpu/train/experiment.py, one device per rank).

The reference's InstanceSegmentation duties (trainer/trainer.py:44-998):
epochs of train steps over prefetched collates with the onecycle schedule
stepped per step, periodic validation with class-agnostic AP (and box AP),
`checkpoints/` after every epoch and `best/` on a better AP50, resume, and
the prediction export that the next round's data set merges
(`save_for_freemask`). Metrics go to the `logging` config group's loggers.

    exp = Experiment(cfg, model, criterion, train_ds, val_ds, test_ds,
                     collator, eval_collator, device="cuda")
    trainer = exp.fit(seed=42, checkpoint=None)
    results = exp.test(save_for_freemask=True)

Left out, as what the TPU needed and the port does not:
  * the master pad plan and its probes (`_pads`, `_pads_locked`,
    `static_shapes`, `pad_rebuilds`, `_spill_floors`, the collates' `pads`
    argument): the port compiles nothing, and its kernels take any row
    count, so each batch is collated at its own size;
  * the mesh, `stack_shards` and `global_batch_from_local`: each rank
    (parallel/distributed.py) loads, collates and feeds its own shard;
  * `jax.random` keys: one torch.Generator on the device, seeded from the
    seed of `fit`, draws the point samples of every step;
  * `enable_compilation_cache` (the entry point calls
    `initialize_from_env`);
  * the eval-collator swap on `win_levels` (experiment.py:306-319): the
    window engine is the TPU's; without an eval collator, a collator with
    crops or merges gets a plain one for eval, since eval scores whole
    scenes.
Also unlike the JAX package, `fit` draws no example batch (the JAX
package collates one to initialise its state; the port's model holds its
seeded random weights from construction, `general.seed`), and the scene
loads of a prefetched epoch run in index order, with the collator's own
draws (`prepare`: MergeCollator's merge, restarted from the seed of `fit`
by `reseed`), so one seed gives the same augmentation and merge draws
whatever the number of worker threads.

Data parallelism. Under a process group of N ranks (the entry point forms
it, one rank per card) each step takes `data.batch_size / N` scenes on
every rank; a batch that does not divide raises ValueError, as does
gradient accumulation. Every rank draws the same global scene ids from the
shared sampler, N lists of one shard each, and keeps its own
(`local_slice`), as experiment.py:561-577 of the JAX package does; the
trainer averages the gradients, losses and BatchNorm statistics
(train/loop.py). Unlike the JAX package, whose single process collates all
shards with one data set and one collator (`collate_shards`, one draw
order), each rank draws its augmentations, its collator's draws and its
point samples from its own seed, `rank_seed(seed, rank)`: rank 0 keeps
the seed itself, so a run of one rank is the single-device run bitwise,
and the ranks' draws differ from the JAX package's. Only rank 0 logs,
writes `checkpoints/` and `best/`, and runs the periodic validation (the
JAX package evaluates on one device too); the other ranks wait at a
barrier, under the process group's timeout (distributed.py:TIMEOUT).
`fit_stats` gains the all-reduce's bytes and milliseconds per step.

`data.prefetch_processes > 0` collates the evaluation's scenes in a pool of
spawned processes (`CollatePool`, the JAX package's), which never touch the
GPU. `general.save_visualizations` writes each evaluated scene's PLY layers
and HTML viewer under `<save_dir>/visualizations` (eval/visualize.py).
`general.backbone_checkpoint` raises NotImplementedError (the JAX package
never reads it). A target label outside the model's classes raises
ValueError before the step (the JAX package's loss turns it into NaN, and
on the card it would be an out-of-bounds device gather).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import dataclasses
import json
import multiprocessing
import os
import queue
import threading
import time

import numpy as np
import torch

from unscene3d_torch import native as native_lib
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.eval.device_post import to_host
from unscene3d_torch.eval.instance_eval import evaluate_instances
from unscene3d_torch.eval.postprocess import SegmentVote
from unscene3d_torch.eval.visualize import save_scene_visualization
from unscene3d_torch.inference import Predictor
from unscene3d_torch.models.weights import init_random_
from unscene3d_torch.parallel import distributed as dp
from unscene3d_torch.parallel.mesh import replicate
from unscene3d_torch.runtime import resolve_device
from unscene3d_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                              restore_partial,
                                              save_checkpoint)
from unscene3d_torch.train.loop import Trainer, make_optimizer


class CSVLogger:
    """CSV metrics logger (reference pytorch_lightning CSVLogger analog).
    Rewrites the file with a widened header when new metric names appear
    (per-loss/per-aux scalars only show up after the first train epoch)."""

    def __init__(self, save_dir: str, name: str = "metrics"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{name}.csv")
        self._fieldnames: list = []
        self._rows: list = []

    def log(self, row: dict):
        row = {k: (float(v) if hasattr(v, "item") else v) for k, v in row.items()}
        self._rows.append(row)
        new = [k for k in row if k not in self._fieldnames]
        if new:
            self._fieldnames = sorted(set(self._fieldnames) | set(row))
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            w.writeheader()
            w.writerows(self._rows)


class JSONLLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, save_dir: str, name: str = "metrics"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{name}.jsonl")

    def log(self, row: dict):
        row = {k: (float(v) if hasattr(v, "item") else v) for k, v in row.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


class MultiLogger:
    def __init__(self, loggers: list):
        self.loggers = list(loggers)

    def log(self, row: dict):
        for lg in self.loggers:
            lg.log(row)


def _logger_kinds():
    from unscene3d_torch.utils.loggers import (NeptuneLogger,
                                               TensorBoardLogger, WandbLogger)

    return {"csv": CSVLogger, "jsonl": JSONLLogger, "wandb": WandbLogger,
            "neptune": NeptuneLogger, "tensorboard": TensorBoardLogger}


def build_loggers(cfg) -> MultiLogger:
    """Instantiate the `logging` config group (conf/logging/*.yaml; each
    entry maps onto a backend by `name`, CSV where the name is unknown).
    Rank 0 alone logs: the other ranks of a process group get no
    logger."""
    if not dp.is_main():
        return MultiLogger([])
    entries = []
    try:
        entries = list(cfg.logging.loggers)
    except AttributeError:
        pass
    kinds = _logger_kinds()
    loggers = []
    for e in entries:
        kind = str(e.get("name", "csv")).lower()
        loggers.append(kinds.get(kind, CSVLogger)(
            str(e.get("save_dir", cfg.general.save_dir))))
    if not loggers:
        loggers = [CSVLogger(cfg.general.save_dir)]
    return MultiLogger(loggers)


def map_tensors(obj, fn, kind=torch.Tensor):
    """`obj` (a batch: dataclasses and tuples of tensors) with `fn` applied
    to every tensor (every instance of `kind`)."""
    if isinstance(obj, kind):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(map_tensors(v, fn, kind) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn, kind)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def tree_bytes(obj) -> int:
    """Bytes of every tensor in `obj` (the JAX package's `tree_bytes`)."""
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t

    map_tensors(obj, add)
    return total[0]


def _collate_worker_init():
    """Initializer of a CollatePool process: no GPU is visible to it (the
    collate is numpy and C++; a CUDA call would fail rather than open a
    second context on the card), torch on one thread, and the native
    library loaded from the build the parent made."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    native_lib.load()


def _collate_in_worker(collator, scenes):
    """A collate in a CollatePool process: the batch's tensors travel back
    as numpy arrays (plain pickles, no shared-memory handles)."""
    batch, meta = collator(scenes)
    return map_tensors(batch, torch.Tensor.numpy), meta


class CollatePool:
    """Eval collation in spawned processes (unscene3d_tpu/train/
    experiment.py:CollatePool, `data.prefetch_processes`): the collate runs
    outside the interpreter's lock, as the reference's DataLoader worker
    processes do. The parent builds the native library before the workers
    start; they load it and never initialise CUDA."""

    def __init__(self, num_procs: int):
        native_lib.load()
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=max(1, int(num_procs)),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_collate_worker_init)

    def collate(self, collator, scenes):
        """(SceneBatch of CPU tensors, CollateMeta) of `collator(scenes)`."""
        batch, meta = self.pool.submit(_collate_in_worker, collator,
                                       scenes).result()
        return map_tensors(batch, torch.from_numpy, np.ndarray), meta

    def shutdown(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


class _PrefetchError:
    """Sentinel carrying a worker exception to the consuming thread."""

    def __init__(self, exc):
        self.exc = exc


class Prefetcher:
    """Multi-worker thread prefetch of collated batches (the role of the
    reference's DataLoader worker processes, conf/data/indoor.yaml:24).

    For each index i, `load_fn(i)` runs in index order, one at a time (the
    data set's reads and its augmentation draws from one RandomState), then
    `build_fn(loaded)` (collation: numpy and the native library, which
    release the GIL) runs on `num_workers` threads at once. Batches are
    emitted strictly in index order. A worker's exception is raised in the
    consuming thread. Device copies are the consumer's."""

    def __init__(self, load_fn, build_fn, num_batches: int, depth: int = 2,
                 num_workers: int = 1):
        self.q = queue.Queue(maxsize=max(depth, num_workers))
        self.n = num_batches
        num_workers = max(1, min(int(num_workers), max(num_batches, 1)))
        next_i = iter(range(num_batches))
        draw_lock = threading.Lock()
        turn_cv = threading.Condition()
        turn = [0]                # next index whose load may run
        done: dict = {}
        done_cv = threading.Condition()
        max_pending = max(depth, num_workers) + 1
        needed = [0]              # next index the emitter will consume
        failure = []

        @contextlib.contextmanager
        def in_turn(i):
            with turn_cv:
                turn_cv.wait_for(lambda: turn[0] == i)
            try:
                yield
            finally:
                with turn_cv:
                    turn[0] = i + 1
                    turn_cv.notify_all()

        def worker():
            while True:
                with draw_lock:
                    i = next(next_i, None)
                if i is None:
                    return
                try:
                    with in_turn(i):
                        loaded = load_fn(i)
                    batch = build_fn(loaded)
                except BaseException as e:  # handed to the consumer
                    with done_cv:
                        failure.append(e)
                        done_cv.notify_all()
                    return
                with done_cv:
                    # backpressure, but never block the batch the emitter
                    # waits on (fast workers could fill the buffer past it)
                    done_cv.wait_for(
                        lambda: len(done) < max_pending or i == needed[0]
                        or failure)
                    done[i] = batch
                    done_cv.notify_all()

        def emitter():
            for i in range(num_batches):
                with done_cv:
                    done_cv.wait_for(lambda: i in done or failure)
                    if i not in done:
                        self.q.put(_PrefetchError(failure[0]))
                        return
                    batch = done.pop(i)
                    needed[0] = i + 1
                    done_cv.notify_all()
                self.q.put(batch)

        self.threads = [threading.Thread(target=worker, daemon=True)
                        for _ in range(num_workers)]
        self.threads.append(threading.Thread(target=emitter, daemon=True))
        for t in self.threads:
            t.start()

    def __iter__(self):
        for _ in range(self.n):
            item = self.q.get()
            if isinstance(item, _PrefetchError):
                raise RuntimeError("prefetch worker failed") from item.exc
            yield item


class _EpochSampler:
    """Sequential consumption of per-epoch shuffles: the dataset is traversed
    exactly once per `len(dataset)` draws, like the reference's shuffled
    DataLoader."""

    def __init__(self, n: int, rng: np.random.RandomState):
        self.n = n
        self.rng = rng
        self._order = None
        self._idx = 0

    def next(self, k: int) -> list[int]:
        out = []
        for _ in range(k):
            if self._order is None or self._idx >= self.n:
                self._order = self.rng.permutation(self.n)
                self._idx = 0
            out.append(int(self._order[self._idx]))
            self._idx += 1
        return out


class Experiment:
    """One self-training run of `cfg` on `device` ('cuda' unless the
    caller asks for 'cpu'; 'cuda' raises without a GPU). The model gets
    seeded random weights from `general.seed` and trains as f32 masters
    (its `dtype` is the compute dtype). `fit_stats` and `eval_stats` hold
    the last run's host-clock times, `last_results` the last evaluation's
    metrics."""

    def __init__(self, cfg, model, criterion, train_dataset,
                 validation_dataset, test_dataset,
                 collator: FreeMaskCollator,
                 eval_collator: FreeMaskCollator | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.general.get("backbone_checkpoint"):
            raise NotImplementedError(
                "general.backbone_checkpoint: the JAX package never reads "
                "it, and the port does not either")
        self.model = model
        self.criterion = criterion
        self.train_dataset = train_dataset
        self.validation_dataset = validation_dataset
        self.test_dataset = test_dataset
        self.collator = collator
        if eval_collator is None and collator.alters_scenes:
            # eval scores whole scenes: a crop or a merge would be held to
            # the whole scene's GT
            eval_collator = FreeMaskCollator(
                voxel_size=collator.voxel_size,
                num_levels=collator.num_levels,
                fine_buckets=collator.fine_buckets,
                csr_levels=collator.csr_levels,
                brick_levels=collator.brick_levels)
        self.eval_collator = eval_collator or collator
        # the model reads host FPS seeds for its queries
        for c in (self.collator, self.eval_collator):
            c.fps_queries = int(model.num_queries)
        self.save_dir = cfg.general.save_dir
        self.logger = build_loggers(cfg)

        self.batch_size = int(cfg.data.batch_size)
        self.rank, self.world = dp.rank(), dp.world_size()
        if self.batch_size % self.world:
            raise ValueError(f"data.batch_size={self.batch_size} does not "
                             f"divide by the {self.world} ranks")
        self.shard_scenes = self.batch_size // self.world
        group = dp.group()
        self.num_workers = int(cfg.data.get("num_workers", 1) or 1)
        # > 0: evaluation collates in that many spawned processes
        self.prefetch_processes = int(cfg.data.get("prefetch_processes", 0)
                                      or 0)
        self._collate_pool = None
        # eval re-collates the same scenes every validation epoch: keep
        # collated host batches up to eval_cache_gb and device batches up
        # to eval_cache_device_gb (0 disables either)
        self.eval_cache_gb = float(cfg.data.get("eval_cache_gb", 4.0) or 0.0)
        self._eval_cache: dict = {}
        self._eval_cache_bytes = 0
        self._cache_lock = threading.Lock()
        self.eval_cache_device_gb = float(
            cfg.data.get("eval_cache_device_gb", 2.0) or 0.0)
        self._eval_dev_cache: dict = {}
        self._eval_dev_cache_bytes = 0
        self.accum_steps = int(cfg.general.get("accumulate_grad_batches", 1))
        if self.accum_steps > 1 and group is not None:
            raise ValueError(
                "accumulate_grad_batches > 1 is not composed with data "
                "parallelism: lower data.batch_size or run one rank")
        if self.rank:
            # the rank's own augmentation draws
            train_dataset.reseed(dp.rank_seed(train_dataset.seed, self.rank))
        steps_per_epoch = max(len(train_dataset) // self.batch_size, 1)
        total_steps = steps_per_epoch * int(cfg.trainer.max_epochs)
        self.steps_per_epoch = steps_per_epoch
        sched_cfg = cfg.scheduler.get("scheduler", {}) if "scheduler" in cfg else {}
        opt = make_optimizer(
            lr=float(cfg.optimizer.lr), total_steps=total_steps,
            schedule=str(sched_cfg.get("name", "onecycle")),
            gamma=float(sched_cfg.get("gamma", 0.99999)),
            weight_decay=float(cfg.optimizer.get("weight_decay", 1e-2)),
        )
        init_random_(model.float(), int(cfg.general.seed))
        model.to(self.device)
        self.trainer = Trainer(model, criterion, opt, group=group)
        self.fit_stats: dict = {}
        self.eval_stats: dict = {}
        self.last_results: dict | None = None

    # --------------------------------------------------------------- batches
    def _draw_step_ids(self, sampler: _EpochSampler) -> list[list[int]]:
        """One step's scene ids: one list, or one per micro-batch under
        gradient accumulation; under a process group the global draw of
        one list per rank, of which this rank keeps its own."""
        if self.accum_steps > 1:
            per_micro = max(self.batch_size // self.accum_steps, 1)
            return [sampler.next(per_micro) for _ in range(self.accum_steps)]
        return dp.local_slice([sampler.next(self.shard_scenes)
                               for _ in range(self.world)])

    def _load_scenes(self, step_ids: list[list[int]]) -> list[list[dict]]:
        """One step's scenes, through the collator's draws (`prepare`):
        the prefetcher runs this in index order."""
        return [self.collator.prepare([self.train_dataset[i] for i in ids])
                for ids in step_ids]

    def _collate_step(self, scene_lists: list[list[dict]]) -> list:
        """Host batches (pinned when they go to a GPU) of one step; raises
        ValueError on a target label outside [0, num_classes)."""
        batches = [self.collator.collate(scenes)[0]
                   for scenes in scene_lists]
        num_classes = int(self.model.num_classes)
        for b in batches:
            if b.target is None:
                continue
            lab = b.target.labels[b.target.valid]
            if len(lab) and (int(lab.min()) < 0
                             or int(lab.max()) >= num_classes):
                raise ValueError(
                    f"target labels span [{int(lab.min())}, "
                    f"{int(lab.max())}], outside the model's {num_classes} "
                    "classes (general.num_targets): check the data set's "
                    "label_offset and filter_out_classes")
        if self.device.type == "cuda":
            batches = [map_tensors(b, torch.Tensor.pin_memory)
                       for b in batches]
        return batches

    # ----------------------------------------------------------------- train
    def fit(self, max_epochs: int | None = None, seed: int = 42,
            resume: bool = False, checkpoint: str | None = None) -> Trainer:
        """Train from the model's weights (or `checkpoint`'s, shape-tolerant,
        or with `resume` the exact state of `checkpoints/`) for the epochs
        left of `max_epochs` (default trainer.max_epochs); returns the
        trainer. Under a process group every rank restores the same files,
        `replicate` asserts the ranks' states equal, and rank 0 alone logs,
        saves and validates while the others wait at the epoch's end."""
        cfg = self.cfg
        max_epochs = int(cfg.trainer.max_epochs) if max_epochs is None else max_epochs
        main = self.rank == 0
        # the scene-id stream is every rank's; the draws are the rank's own
        rng_np = np.random.RandomState(seed)
        own_seed = dp.rank_seed(seed, self.rank)
        gen = torch.Generator(device=self.device).manual_seed(own_seed)
        self.collator.reseed(own_seed)
        trainer = self.trainer
        ckpt_dir = os.path.join(self.save_dir, "checkpoints")
        if checkpoint:
            restore_partial(checkpoint, trainer, verbose=main)
            if main:
                print(f"[exp] partial-restored from {checkpoint}")
        elif resume and latest_step(ckpt_dir) is not None:
            restore_checkpoint(ckpt_dir, trainer)
            if main:
                print(f"[exp] resumed from step {trainer.step}")
        if trainer.group is not None:
            replicate(trainer)
        best_ap = -1.0
        check_every = int(cfg.trainer.get("check_val_every_n_epoch", 50))
        start_epoch = trainer.step // self.steps_per_epoch
        stats = self.fit_stats = {"step_ms": [], "wait_ms": [],
                                  "epoch_s": [], "checkpoint_s": [],
                                  "allreduce_ms": [], "allreduce_bytes": []}

        sampler = _EpochSampler(len(self.train_dataset), rng_np)
        for epoch in range(start_epoch, max_epochs):
            t0 = time.time()
            losses = None
            epoch_ids = [self._draw_step_ids(sampler)
                         for _ in range(self.steps_per_epoch)]
            batches = iter(Prefetcher(
                lambda i: self._load_scenes(epoch_ids[i]),
                self._collate_step, self.steps_per_epoch,
                num_workers=self.num_workers))
            for _ in range(self.steps_per_epoch):
                t_wait = time.perf_counter()
                host = next(batches)
                t_step = time.perf_counter()
                micro = [b.to(self.device, non_blocking=True) for b in host]
                if len(micro) > 1:
                    losses = trainer.accum_train_step(micro, gen)
                else:
                    losses = trainer.train_step(micro[0], gen)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_end = time.perf_counter()
                stats["wait_ms"].append(1e3 * (t_step - t_wait))
                stats["step_ms"].append(1e3 * (t_end - t_step))
                comm = trainer.last_all_reduce()
                if comm is not None:
                    stats["allreduce_bytes"].append(comm[0])
                    stats["allreduce_ms"].append(comm[1])
            dt = time.time() - t0
            stats["epoch_s"].append(dt)
            if not main:
                # rank 0 logs, saves and validates; the step's state is
                # every rank's
                dp.barrier()
                continue
            total = float(losses["total"])
            print(f"[epoch {epoch}] loss={total:.4f} "
                  f"({dt:.1f}s, {self.steps_per_epoch} steps)")
            row = {"epoch": epoch, "loss_total": total, "epoch_seconds": dt}
            # per-loss / per-aux-layer scalars (reference trainer.py:149-162)
            for k, v in losses.items():
                if k in ("total", "matched_q"):
                    continue
                v = v.detach().cpu().numpy()
                if v.ndim == 0:
                    row[f"train_{k}"] = float(v)
                else:
                    row[f"train_{k}"] = float(v[-1])
                    for i in range(v.shape[0] - 1):
                        row[f"train_{k}_aux{i}"] = float(v[i])
            self.logger.log(row)
            t_ck = time.perf_counter()
            save_checkpoint(ckpt_dir, trainer)
            stats["checkpoint_s"].append(time.perf_counter() - t_ck)

            if (epoch + 1) % check_every == 0 or epoch == max_epochs - 1:
                results = self.evaluate(self.validation_dataset)
                ap50 = results["all_ap_50%"]
                row = {"epoch": epoch, "val_mean_ap": results["all_ap"],
                       "val_mean_ap_50": ap50,
                       "val_mean_ap_25": results["all_ap_25%"]}
                # per-class AP table (reference trainer.py:785-918)
                for label, aps in results.get("classes", {}).items():
                    row[f"val_{label}_ap"] = aps["ap"]
                    row[f"val_{label}_ap_50"] = aps["ap50%"]
                    row[f"val_{label}_ap_25"] = aps["ap25%"]
                # head/common/tail frequency-split means on scannet200-style
                # label spaces (reference trainer.py:855-903)
                from unscene3d_torch.data.scannet_constants import (
                    COMMON_CATS_SCANNET_200, HEAD_CATS_SCANNET_200,
                    TAIL_CATS_SCANNET_200)

                splits = {"head": HEAD_CATS_SCANNET_200,
                          "common": COMMON_CATS_SCANNET_200,
                          "tail": TAIL_CATS_SCANNET_200}
                for split_name, cats in splits.items():
                    vals = [aps["ap"] for label, aps in
                            results.get("classes", {}).items() if label in cats]
                    if vals:
                        row[f"val_mean_{split_name}_ap"] = float(np.nanmean(vals))
                for key in ("val_box_ap_25", "val_box_ap_50"):
                    if key in results:
                        row[key] = results[key]
                self.logger.log(row)
                print(f"[val] AP={results['all_ap']:.3f} AP50={ap50:.3f} "
                      f"AP25={results['all_ap_25%']:.3f}")
                if ap50 > best_ap:
                    best_ap = ap50
                    save_checkpoint(os.path.join(self.save_dir, "best"),
                                    trainer)
            dp.barrier()
        return trainer

    # ------------------------------------------------------------------ eval
    def _eval_load(self, dataset, i: int):
        return (id(dataset), i), dataset[i]

    def _eval_collate(self, loaded):
        """(key, host batch or None when the device cache holds it, meta,
        scene)."""
        key, scene = loaded
        with self._cache_lock:
            dev = self._eval_dev_cache.get(key)
            cached = self._eval_cache.get(key)
        if dev is not None:
            return key, None, dev[1], scene
        if cached is not None:
            return (key,) + cached + (scene,)
        if self._collate_pool is not None:
            batch, meta = self._collate_pool.collate(self.eval_collator,
                                                     [scene])
        else:
            batch, meta = self.eval_collator([scene])
        if self.device.type == "cuda":
            batch = map_tensors(batch, torch.Tensor.pin_memory)
        if self.eval_cache_gb:
            nb = tree_bytes(batch)
            with self._cache_lock:
                if self._eval_cache_bytes + nb <= self.eval_cache_gb * 1e9:
                    self._eval_cache[key] = (batch, meta)
                    self._eval_cache_bytes += nb
        return key, batch, meta, scene

    def _to_device_cached(self, key, host, meta):
        """The device batch of `key`: from the device cache, else copied
        (and kept while the byte budget allows)."""
        dev = self._eval_dev_cache.get(key)
        if dev is not None:
            return dev[0]
        batch = host.to(self.device, non_blocking=True)
        if self.eval_cache_device_gb:
            nb = tree_bytes(batch)
            if (self._eval_dev_cache_bytes + nb
                    <= self.eval_cache_device_gb * 1e9):
                with self._cache_lock:
                    self._eval_dev_cache[key] = (batch, meta)
                    self._eval_dev_cache_bytes += nb
        return batch

    def close(self):
        """Stop the collate processes, if any."""
        if self._collate_pool is not None:
            self._collate_pool.shutdown()
            self._collate_pool = None

    def release_eval_cache(self):
        """Drop both eval caches (the device batches with them)."""
        with self._cache_lock:
            self._eval_cache.clear()
            self._eval_dev_cache.clear()
            self._eval_cache_bytes = self._eval_dev_cache_bytes = 0

    def evaluate(self, dataset, save_for_freemask: bool = False,
                 max_scenes: int | None = None, with_boxes: bool = True) -> dict:
        """Class-agnostic AP (and box AP) of the model on `dataset`, one
        scene per forward. The collate of scene i+1 runs in the prefetch
        threads while scene i's forward runs, and a 2-thread pool runs the
        host tails: `Predictor.pack` -> `to_host` -> `Predictor.tail` over
        the scene's memoised `SegmentVote`, or `Predictor.post` (the host
        route with the DBSCAN split) under `general.use_dbscan`. With
        `data.prefetch_processes` > 0 the collates run in a CollatePool
        (started at the first evaluation, stopped by `close`)."""
        cfg = self.cfg
        use_dbscan = bool(cfg.general.get("use_dbscan", False))
        g = cfg.general
        predictor = Predictor(
            self.model, self.device, use_dbscan=use_dbscan,
            dbscan_eps=float(g.get("dbscan_eps", 0.95)),
            dbscan_min_points=int(g.get("dbscan_min_points", 1)),
            eval_on_segments=bool(g.eval_on_segments),
            topk_per_image=int(g.topk_per_image),
            filter_instances=bool(g.filter_out_instances),
            iou_threshold=float(g.iou_threshold),
            scores_threshold=float(g.scores_threshold),
            separate_instances=bool(g.separate_instances))
        n = len(dataset) if max_scenes is None else min(max_scenes, len(dataset))
        num_workers = int(cfg.data.get("num_workers", 2) or 2)
        if self.prefetch_processes and self._collate_pool is None:
            self._collate_pool = CollatePool(self.prefetch_processes)
        num_workers = min(max(num_workers, self.prefetch_processes), 4)
        preds, gts, bbox_preds, bbox_gt = {}, {}, {}, {}
        t0 = time.perf_counter()
        wait_s = forward_s = 0.0
        post_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        try:
            prefetch = iter(Prefetcher(
                lambda i: self._eval_load(dataset, i), self._eval_collate, n,
                depth=2, num_workers=num_workers))
            futures = []
            for _ in range(n):
                tw = time.perf_counter()
                key, host, meta, scene = next(prefetch)
                tf = time.perf_counter()
                batch = self._to_device_cached(key, host, meta)
                out = self.model(batch)
                payload = ((out, batch) if use_dbscan
                           else to_host(predictor.pack(out, batch)))
                forward_s += time.perf_counter() - tf
                wait_s += tf - tw
                futures.append(post_pool.submit(
                    self._eval_postprocess_scene, predictor, payload, meta,
                    scene, save_for_freemask, with_boxes))
                del out
            t_tails = time.perf_counter()
            tail_parts = np.zeros(3)
            for fut in futures:
                name, pred, gt, bp, bg, times = fut.result()
                tail_parts += times
                preds[name] = pred
                gts[name] = gt
                if bp is not None:
                    bbox_preds[name] = bp
                    bbox_gt[name] = bg
        finally:
            post_pool.shutdown(wait=True, cancel_futures=True)
            self.model.train()
        t_ap = time.perf_counter()
        # reference: benchmark.evaluate(dataset='freemask') keeps the
        # scannet min_region_sizes=[100] (evaluate_semantic_instance.py:74)
        results = evaluate_instances(
            preds, gts,
            min_region_size=int(cfg.general.get("eval_min_region_size", 100)))
        if with_boxes and bbox_preds:
            # VOC box AP at IoU .25/.5 (reference trainer/trainer.py:791-796)
            from unscene3d_torch.eval.box_eval import eval_det

            for th, key in ((0.25, "val_box_ap_25"), (0.5, "val_box_ap_50")):
                _, ap = eval_det(bbox_preds, bbox_gt, ovthresh=th)
                results[key] = float(np.mean(list(ap.values()))) if ap else 0.0
        t_end = time.perf_counter()
        # host clock: the main thread's waits on the prefetcher, its forward
        # + device pack + copy back, its wait for the tails left after the
        # last forward, and the AP computation; the tails' own parts summed
        # over the pool's threads
        self.eval_stats = {"scenes": n, "seconds": t_end - t0,
                           "prefetch_wait_s": wait_s,
                           "forward_and_pack_s": forward_s,
                           "tails_wait_s": t_ap - t_tails,
                           "ap_s": t_end - t_ap,
                           "tail_post_s": tail_parts[0],
                           "tail_boxes_s": tail_parts[1],
                           "tail_exports_s": tail_parts[2]}
        self.last_results = results
        return results

    def _seg_vote(self, meta):
        """The scene's SegmentVote, memoised on its (cached) meta."""
        if not bool(self.cfg.general.eval_on_segments):
            return None
        sv = getattr(meta, "_seg_vote0", None)
        if sv is None:
            sv = SegmentVote(meta.inverse_maps[0], meta.original_segments[0])
            meta._seg_vote0 = sv
        return sv

    def _eval_postprocess_scene(self, predictor, payload, meta, scene,
                                save_for_freemask, with_boxes):
        """One scene's host tail: `Predictor.tail` over the packed outputs
        (`payload`) and the scene's SegmentVote, or under use_dbscan
        `Predictor.post` over `payload` = (outputs, device batch); then the
        GT ids, boxes and the exports. Returns (name, pred, gt ids, pred
        boxes, GT boxes, seconds of the post, the boxes and the exports)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        if predictor.use_dbscan:
            p = predictor.post(*payload, meta)
        else:
            p = predictor.tail(payload, meta, self._seg_vote(meta))
        name = meta.scene_names[0]
        # classes: head index 1 == 'foreground' (valid class id 1)
        pred = {"masks": p["masks"], "classes": p["classes"],
                "scores": p["scores"]}
        gt = self._gt_ids(scene)
        t1 = time.perf_counter()
        bp = bg = None
        if with_boxes:
            from unscene3d_torch.eval.box_eval import boxes_from_masks

            coords = meta.full_res_coords[0]
            bp = boxes_from_masks(
                coords, p["masks"], p["classes"], p["scores"])
            gt_masks = np.asarray(scene["masks"], bool)
            bg = boxes_from_masks(
                coords, gt_masks, np.ones(gt_masks.shape[1], np.int64))
        t2 = time.perf_counter()
        if bool(cfg.general.get("export", False)):
            # ScanNet-benchmark submission format (reference
            # trainer/trainer.py:168-187)
            from unscene3d_torch.eval.benchmark_export import export_predictions

            export_predictions(
                os.path.join(self.save_dir, "eval_output"), name,
                p["masks"].astype(bool), p["classes"], p["scores"],
                score_threshold=float(
                    cfg.general.get("export_threshold", 0.0)))
        if save_for_freemask:
            out_dir = os.path.join(self.save_dir, "freemasks")
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"{name}_cloud.npy"),
                    meta.full_res_coords[0])
            np.save(os.path.join(out_dir, f"{name}_masks.npy"),
                    p["masks"].astype(bool))
        if bool(cfg.general.get("save_visualizations", False)):
            # colored-PLY export in place of the reference's pyviz3d
            # scenes (trainer/trainer.py:197-357)
            save_scene_visualization(
                os.path.join(self.save_dir, "visualizations"), name,
                meta.full_res_coords[0],
                colors=np.asarray(scene.get("colors"))
                if scene.get("colors") is not None else None,
                segments=meta.original_segments[0],
                masks=p["masks"].astype(bool))
        times = np.array([t1 - t0, t2 - t1, time.perf_counter() - t2])
        return name, pred, gt, bp, bg, times

    @staticmethod
    def _gt_ids(scene: dict) -> np.ndarray:
        """Encode GT per-point ids as sem*1000 + inst + 1 (freemask sem=1)."""
        if "instances" in scene:
            inst = np.asarray(scene["instances"])
            return np.where(inst >= 0, 1000 + inst + 1, 0)
        masks = np.asarray(scene["masks"], bool)
        gt = np.zeros(masks.shape[0], np.int64)
        for k in range(masks.shape[1]):
            gt[masks[:, k]] = 1000 + k + 1
        return gt

    def test(self, checkpoint: str | None = None,
             save_for_freemask: bool = False) -> dict:
        """Exact restore of `checkpoint` (default `best/`, else
        `checkpoints/`), evaluation on the test set (exporting the
        predictions with `save_for_freemask`), then both eval caches
        released."""
        ckpt = checkpoint or os.path.join(self.save_dir, "best")
        if latest_step(ckpt) is None:
            ckpt = os.path.join(self.save_dir, "checkpoints")
        restore_checkpoint(ckpt, self.trainer)
        try:
            results = self.evaluate(self.test_dataset,
                                    save_for_freemask=save_for_freemask)
        finally:
            self.release_eval_cache()
        print(json.dumps(results, indent=2, default=float))
        return results
