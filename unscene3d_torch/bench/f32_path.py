"""End-to-end times of the f32 configuration, the default of every entry
point (`build_mask3d`, `build_trainer`): the bench scene's warm eval
forward through `inference.Predictor` and the batch-8 train step through
`train.loop.build_trainer(torch.float32)`.

    python3 -m unscene3d_torch.bench.f32_path

The scenes, weights and seeds are chip_smoke.py's (bench.py's headline
inference scene, its batch-8 train batch): run it in two checkouts in turns
to compare them on one card. Forward: CUDA events, median of 5 after one
warm-up. Train step: host clock after a synchronise, one warm-up step, the
median of 3. Prints one line per number and, last, one JSON object.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from unscene3d_torch.bench.timing import device_ms
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.inference import Predictor, build_mask3d
from unscene3d_torch.runtime import resolve_device
from unscene3d_torch.train.loop import build_trainer

BENCH_SCENE = dict(num_points=250_000, num_objects=12, extent=8.0, seed=0)
TRAIN_SCENE = dict(num_points=125_000, num_objects=12, extent=8.0)
TRAIN_BATCH = 8
TRAIN_STEPS = 3


def run(device="cuda", bench=BENCH_SCENE, train=TRAIN_SCENE,
        train_batch=TRAIN_BATCH, steps=TRAIN_STEPS, voxel=0.02) -> dict:
    """Name -> number (milliseconds, scenes/s, GiB); see the top."""
    dev = resolve_device(device)
    out = {}
    pred = Predictor(build_mask3d(torch.float32, seed=0), dev,
                     voxel_size=voxel)
    batch, _ = pred.collator([make_scene(**bench)])
    batch = batch.to(dev)
    out["forward_ms"] = device_ms(lambda: pred.model(batch), dev, reps=5,
                                  warmup=1)
    del pred, batch
    scenes = [make_scene(**train, seed=100 + i) for i in range(train_batch)]
    tbatch, _ = FreeMaskCollator(voxel_size=voxel, fps_queries=100)(scenes)
    tbatch = tbatch.to(dev)
    trainer = build_trainer(torch.float32, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        trainer.train_step(tbatch, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    out["step_first_ms"] = times[0]
    out["step_ms"] = statistics.median(times[1:])
    out["scenes_per_s"] = 1e3 * train_batch / out["step_ms"]
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def main() -> int:
    from unscene3d_torch.runtime import gpu_name_and_power_limit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = run()
    card = gpu_name_and_power_limit().splitlines()[0]
    for name, v in numbers.items():
        print(f"{name:16s} {v:.4f}")
    print(card)
    print(json.dumps({"card": card, **numbers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
