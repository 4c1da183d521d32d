"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds each
against its plain twin at main-path shapes, drives the eval path through
`unscene3d_torch.inference` on the bench scene and the train path through
`unscene3d_torch.train.loop` on bench.py's batch-8 train batch, and checks
card-vs-CPU parity of both on a mid-size scene.

    python3 chip_smoke.py

Needs one NVIDIA GPU and nvcc; exits nonzero without them. Phases print one
line each; the line before the last is a JSON object of per-kernel numbers
measured in this run, and the last line is the contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()

# bench scene: bench.py's headline inference cell
BENCH_SCENE = dict(num_points=250_000, num_objects=12, extent=8.0)
# train batch: bench.py's train row (8 x ~116k voxels, bf16)
TRAIN_SCENE = dict(num_points=125_000, num_objects=12, extent=8.0)
TRAIN_BATCH = 8
TRAIN_STEPS = 5          # timed, after one warm-up step
VOXEL = 0.02
# tolerances relative to max|twin|: f32 differs by summation order only.
# Kernel and twin both sum bf16 inputs in f32 and round once, so a bf16
# output may differ by one ulp where the f32 sums straddle a rounding
# boundary; 8e-3 is just above one ulp at the top of max|twin|'s binade
# (2^-7 of its lower power of two)
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# dW (kernel 5) is f32 in both dtypes, summed over up to ~1M rows in another
# order than the twin's GEMM: f32 FMA reads <= 6e-6; the bf16 tensor cores'
# f32 accumulation is not IEEE round-to-nearest and reads up to 9.4e-5
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-4}
# card (kernels) vs CPU (twins) on the whole f32 slice, relative to max|ref|:
# 23 residual blocks and 12 attention rounds compound the f32 reordering
SLICE_TOL = 1e-3
# the f32 train step, card vs CPU with the samples, block masks and matching
# replayed: losses relative to their max; each gradient relative to its
# tensor's max plus GRAD_FLOOR of the largest gradient of the model
TRAIN_LOSS_TOL = 1e-4
GRAD_TOL, GRAD_FLOOR = 1e-3, 1e-4
KERNELS = {   # name -> (source, TPU kernel it replaces)
    "conv3_fwd": ("unscene3d_torch/csrc/conv3.cu",
                  "unscene3d_tpu/ops/window_conv.py:398"),
    "k_apply_gemm": ("unscene3d_torch/csrc/k_apply.cu",
                     "unscene3d_tpu/ops/window_gather.py:159"),
    "k_apply_sum": ("unscene3d_torch/csrc/k_apply.cu",
                    "unscene3d_tpu/ops/window_gather.py:159"),
    "segment_sum": ("unscene3d_torch/csrc/segment_sum.cu",
                    "unscene3d_tpu/ops/segment_pool.py:28"),
    "conv3_bwd": ("unscene3d_torch/csrc/conv3_bwd.cu",
                  "unscene3d_tpu/ops/window_conv.py:621"),
    "conv3_dw": ("unscene3d_torch/csrc/conv3_bwd.cu",
                 "unscene3d_tpu/ops/window_conv.py:548"),
}
# launches per eval forward of Mask3D(Res16UNet34C): 1 stem + 23 blocks x 2
# k3 convs; 4 down2 + 4 up2; 4 coordinate + 4 mask-feature pools; 1 pool
PER_FORWARD = {"conv3_fwd": 47, "k_apply_gemm": 8, "k_apply_sum": 8,
               "segment_sum": 1, "conv3_bwd": 0, "conv3_dw": 0}
# launches per train step (remat on): k3 forward 47 + 46 recomputed in the
# 23 blocks' backward; dx of every k3 conv but the stem (its input features
# need no gradient) and dW of all 47; k2 convs 8 forward + 8 dx; the same 8
# pools and 1 segment sum (the pooled readout is under a stopped gradient)
PER_TRAIN_STEP = {"conv3_fwd": 93, "conv3_bwd": 46, "conv3_dw": 47,
                  "k_apply_gemm": 16, "k_apply_sum": 8, "segment_sum": 1}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def counters():
    from unscene3d_torch.ops.conv3 import conv3_bwd, conv3_dw, conv3_fwd
    from unscene3d_torch.ops.k_apply import k_apply_gemm, k_apply_sum
    from unscene3d_torch.ops.segment_pool import segment_sum

    return {"conv3_fwd": conv3_fwd, "k_apply_gemm": k_apply_gemm,
            "k_apply_sum": k_apply_sum, "segment_sum": segment_sum,
            "conv3_bwd": conv3_bwd, "conv3_dw": conv3_dw}


def phase_device():
    from unscene3d_torch.runtime import cuda_device, gpu_name_and_power_limit

    dev = cuda_device(0)
    card = gpu_name_and_power_limit().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return dev, card


def phase_build():
    from unscene3d_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"build: {time.perf_counter() - t0:.1f}s (nvcc ran: "
        f"{_build.build_seconds is not None}) sources="
        f"{[s.split('/')[-1] for s in _build.sources()]}")
    for ln in regs:
        log(f"  ptxas {ln}")


def _compare(name, dtype, kernel, twin, tol=None):
    """Run kernel twice (bitwise equal), compare with the twin, time both."""
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {dtype}: two runs differ")
    ref = twin()
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-6)
    tol = KERNEL_TOL[dtype] if tol is None else tol
    ms, plain_ms = cuda_ms(kernel), cuda_ms(twin)
    log(f"  {name:44s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
        f"max_rel_err={err / scale:.3e} (tol {tol:g}) ms={ms:.3f} "
        f"plain_ms={plain_ms:.3f}")
    if not err <= tol * scale:
        raise AssertionError(f"{name} {dtype}: error {err} > {tol} * {scale}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_kernels(dev, batch):
    from unscene3d_torch.ops.conv3 import conv3_fwd, conv3_fwd_plain
    from unscene3d_torch.ops.k_apply import k_apply, k_apply_plain
    from unscene3d_torch.ops.segment_pool import segment_sum, segment_sum_plain

    L = [lv.to(dev) for lv in batch.graph.levels]
    log("kernels vs plain twins at the bench scene's shapes "
        f"(rows per level {[lv.num_padded for lv in L]})")
    g = torch.Generator().manual_seed(0)
    res = {k: {} for k in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for lv, cin, cout, epi in ((0, 3, 32, False), (0, 128, 96, True),
                                   (3, 384, 256, False)):
            lvl = L[lv]
            n = lvl.num_padded
            x = torch.randn(n, cin, generator=g).to(dev, dtype)
            w = (torch.randn(27, cin, cout, generator=g)
                 / cin ** 0.5).to(dev, dtype)
            kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(dev),
                      shift=torch.randn(cout, generator=g).to(dev), relu=True)
            if epi:
                kw["residual"] = torch.randn(n, cout, generator=g).to(dev,
                                                                      dtype)
            res["conv3_fwd"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_fwd L{lv} {cin}->{cout}"
                + (" +scale/shift+res+relu" if epi else " +scale/shift+relu"),
                dtype,
                lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw),
                lambda: conv3_fwd_plain(x, w, lvl.nbr_idx, lvl.valid, **kw))
        # k2 down conv L0 -> L1 (conv1p1s2, 32 -> 32)
        x = torch.randn(L[0].num_padded, 32, generator=g).to(dev, dtype)
        w = (torch.randn(8, 32, 32, generator=g) / 32 ** 0.5).to(dev, dtype)
        res["k_apply_gemm"][("down", dtype)] = _compare(
            "k_apply_gemm down2 L0->L1 32->32", dtype,
            lambda: k_apply(x, L[1].child_idx, w, L[1].valid),
            lambda: k_apply_plain(x, L[1].child_idx, w, L[1].valid))
        # k2 transposed up conv L1 -> L0 (convtr7p2s2, 96 -> 96)
        table = L[0].up_idx
        xu = torch.randn(L[1].num_padded, 96, generator=g).to(dev, dtype)
        wu = (torch.randn(8, 96, 96, generator=g) / 96 ** 0.5).to(dev, dtype)
        res["k_apply_gemm"][("up", dtype)] = _compare(
            "k_apply_gemm up2 L1->L0 96->96", dtype,
            lambda: k_apply(xu, table, wu, L[0].valid),
            lambda: k_apply_plain(xu, table, wu, L[0].valid))
        # 8-child pool sums: coordinates (C=3) and mask features (C=128)
        for c in (3, 128):
            xp = torch.randn(L[0].num_padded, c, generator=g).to(dev, dtype)
            res["k_apply_sum"][(c, dtype)] = _compare(
                f"k_apply_sum pool L0->L1 C={c}", dtype,
                lambda: k_apply(xp, L[1].child_idx, None, L[1].valid),
                lambda: k_apply_plain(xp, L[1].child_idx, None, L[1].valid))
        # segment mean-pool sum (204800, 128) -> (320, 128)
        S = batch.batch_size * batch.num_segments_padded
        seg_flat = (L[0].coords[:, 0].long() * batch.num_segments_padded
                    + batch.point2segment.to(dev).long())
        xs = torch.randn(L[0].num_padded, 128, generator=g).to(dev, dtype)
        order, offsets = batch.seg_order.to(dev), batch.seg_offsets.to(dev)
        res["segment_sum"][dtype] = _compare(
            f"segment_sum ({L[0].num_padded},128)->({S},128)", dtype,
            lambda: segment_sum(xs, seg_flat, S, L[0].valid, order=order,
                                offsets=offsets),
            lambda: segment_sum_plain(xs, seg_flat, S, L[0].valid))
    return res


def phase_slice(dev):
    """The main path: seeded random weights through the inference entry
    point, bf16 for three scenes end to end, f32 for one. The launch counts
    are read around exactly these requests; warm timings come after."""
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.inference import Predictor, build_mask3d, postprocess

    scenes = [make_scene(**BENCH_SCENE, seed=s) for s in range(3)]
    preds = {dt: Predictor(build_mask3d(dt, seed=0), dev, voxel_size=VOXEL)
             for dt in (torch.bfloat16, torch.float32)}
    requests = [(torch.bfloat16, 0), (torch.bfloat16, 1),
                (torch.bfloat16, 2), (torch.float32, 0)]

    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    served = []
    for dt, i in requests:
        p = preds[dt]
        t0 = time.perf_counter()
        batch, meta = p.collator([scenes[i]])
        t1 = time.perf_counter()
        batch = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = p.model(batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        inst = postprocess(out, meta)
        t4 = time.perf_counter()
        for key in ("pred_logits", "pred_masks_seg", "pred_masks_vox"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"{key} not finite ({dt}, scene {i})")
        if out["pred_logits"].shape != (13, 1, 100, 3):
            raise AssertionError(f"pred_logits {out['pred_logits'].shape}")
        if inst["masks"].shape != (len(scenes[i]["xyz"]), 100):
            raise AssertionError(f"instance masks {inst['masks'].shape}")
        served.append((dt, i, batch, meta, inst, (t0, t1, t2, t3, t4)))
    launches = {k: fn.launches for k, fn in cnt.items()}
    log(f"main path: {len(requests)} requests, launches {launches}")
    for k, per in PER_FORWARD.items():
        if launches[k] != per * len(requests):
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} per forward x {len(requests)}")

    for dt, i, batch, meta, inst, (t0, t1, t2, t3, t4) in served:
        model = preds[dt].model
        warm = cuda_ms(lambda: model(batch), reps=5, warmup=1)
        log(f"scene {i} {str(dt)[6:]}: voxels={meta.num_voxels[0]} "
            f"collate={1e3 * (t1 - t0):.0f}ms h2d={1e3 * (t2 - t1):.0f}ms "
            f"forward(first)={1e3 * (t3 - t2):.1f}ms "
            f"forward(warm, median of 5)={warm:.1f}ms "
            f"post={1e3 * (t4 - t3):.0f}ms e2e={1e3 * (t4 - t0):.0f}ms "
            f"instances={len(inst['scores'])} "
            f"top score={float(np.max(inst['scores'], initial=0)):.4f}")
    return launches, preds, served


def _traced(fn, activities, reps=3):
    """Run fn reps times under torch.profiler. Returns (device-side rows
    (ms per call, name, launches per call), busy ms per call, window ms per
    call), the window timed by CUDA events around the same traced calls."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=activities) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    # device-side events only (kernels, memcpy/memset): an aten op's own
    # device time would count its kernels a second time
    rows = sorted(((e.self_device_time_total / 1e3 / reps, e.key,
                    e.count // reps) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    return rows, sum(r[0] for r in rows), start.elapsed_time(end) / reps


def phase_profile(preds, served):
    """Where a warm bf16 forward spends device time: backbone vs the whole
    forward (CUDA events), and device time by kernel (torch.profiler). The
    idle share is read inside one traced window: busy device time against
    the CUDA-event time of the same traced forwards. It is read twice, with
    host and device tracing and with device tracing alone; the untraced
    forward shows what the tracing itself costs."""
    from torch.profiler import ProfilerActivity

    _, _, batch, _, _, _ = served[0]
    model = preds[torch.bfloat16].model
    bb_ms = cuda_ms(torch.no_grad()(
        lambda: model.backbone(batch.features, batch.graph)),
        reps=5, warmup=1)
    fwd_ms = cuda_ms(lambda: model(batch), reps=5, warmup=1)
    log(f"profile bf16: forward={fwd_ms:.1f}ms backbone={bb_ms:.1f}ms "
        f"decoder+heads={fwd_ms - bb_ms:.1f}ms (untraced)")
    table = None
    for label, acts in (("host+device", [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]),
                        ("device only", [ProfilerActivity.CUDA])):
        rows, busy, window = _traced(lambda: model(batch), acts)
        if not rows:
            log(f"profile ({label}): no device time in the trace "
                "(not measured)")
            continue
        log(f"profile ({label} tracing): device busy {busy:.1f}ms of a "
            f"{window:.1f}ms traced forward, idle share "
            f"{1 - busy / window:.1%}; {sum(r[2] for r in rows)} device "
            f"ops per forward")
        table = table or (rows, busy)
    if table is not None:
        rows, busy = table
        for ms, name, n in rows[:12]:
            log(f"  {ms:8.2f}ms {100 * ms / busy:5.1f}%  x{n:<4d} "
                f"{name[:90]}")


def phase_parity(dev, model32):
    """Card (kernels) vs CPU (twins), same weights, f32, mid-size scene."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene

    scene = make_scene(num_points=30_000, num_objects=6, extent=4.0, seed=7)
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fine_buckets=True,
                                   fps_queries=100)([scene])
    out_gpu = model32(batch.to(dev))
    model_cpu = model32.to("cpu")
    out_cpu = model_cpu(batch)
    model32.to(dev)
    for key in ("pred_logits", "pred_masks_seg", "pred_masks_vox"):
        a, b = out_gpu[key].float().cpu(), out_cpu[key].float()
        err = (a - b).abs().max().item()
        scale = max(b.abs().max().item(), 1e-6)
        log(f"  parity {key}: max_abs_err={err:.3e} "
            f"max_rel_err={err / scale:.3e} (tol {SLICE_TOL:g})")
        if not err <= SLICE_TOL * scale:
            raise AssertionError(f"card vs CPU {key}: {err} > "
                                 f"{SLICE_TOL} * {scale}")
    log(f"parity scene: voxels={meta.num_voxels[0]}")


def train_batch():
    """bench.py's train batch: 8 x make_scene(125k points, 12 objects, 8 m),
    voxel 0.02, with instance targets, host FPS seeds for 100 queries."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene

    t0 = time.perf_counter()
    scenes = [make_scene(**TRAIN_SCENE, seed=100 + i)
              for i in range(TRAIN_BATCH)]
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fps_queries=100)(scenes)
    log(f"train batch collate: {time.perf_counter() - t0:.1f}s, voxels "
        f"{meta.num_voxels} (rows per level "
        f"{[lv.num_padded for lv in batch.graph.levels]}), targets "
        f"{tuple(batch.target.labels.shape)}")
    return batch


def phase_train_kernels(dev, batch):
    """Kernels 4 and 5 against their twins at the train batch's shapes."""
    from unscene3d_torch.ops.conv3 import (conv3_bwd, conv3_bwd_plain,
                                           conv3_dw, conv3_dw_plain)

    L = [lv.to(dev) for lv in batch.graph.levels]
    log("backward kernels vs plain twins at the train batch's shapes")
    g = torch.Generator().manual_seed(1)
    res = {"conv3_bwd": {}, "conv3_dw": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for lv, cin, cout in ((0, 3, 32), (0, 128, 96), (3, 384, 256)):
            lvl = L[lv]
            n = lvl.num_padded
            x = torch.randn(n, cin, generator=g).to(dev, dtype)
            w = (torch.randn(27, cin, cout, generator=g)
                 / cin ** 0.5).to(dev, dtype)
            gm = (torch.randn(n, cout, generator=g).to(dev)
                  * lvl.valid[:, None]).to(dtype)
            args = (x, gm, w, lvl.nbr_idx, lvl.valid)
            res["conv3_bwd"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_bwd (dx + dW) L{lv} {cin}->{cout}, dx", dtype,
                lambda: conv3_bwd(*args)[0],
                lambda: conv3_bwd_plain(*args)[0])
            res["conv3_dw"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_dw L{lv} {cin}->{cout} (f32 out)", dtype,
                lambda: conv3_dw(x, gm, lvl.nbr_idx),
                lambda: conv3_dw_plain(x, gm, lvl.nbr_idx),
                tol=DW_TOL[dtype])
            del x, w, gm, args
    return res


def phase_train(dev, batch):
    """The train path: build_trainer(bf16) on the 8-scene batch, one warm-up
    step and TRAIN_STEPS timed ones, launch counts read around exactly
    these steps."""
    from unscene3d_torch.train.loop import build_trainer

    t0 = time.perf_counter()
    trainer = build_trainer(torch.bfloat16, seed=0, device=dev)
    n_params = sum(p.numel() for p in trainer.params)
    log(f"train: build_trainer(bf16) {time.perf_counter() - t0:.1f}s, "
        f"{n_params / 1e6:.2f}M f32 master params")
    before = [p.detach().clone() for p in trainer.params]
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    times = []
    for step in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        losses = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        for key in ("loss_ce", "loss_mask", "loss_dice", "total"):
            if not torch.isfinite(losses[key]).all():
                raise AssertionError(f"train step {step}: {key} not finite")
        log(f"  step {step}: {times[-1]:.1f}ms total="
            f"{losses['total'].item():.4f} final set ce="
            f"{losses['loss_ce'][-1].item():.4f} mask="
            f"{losses['loss_mask'][-1].item():.4f} dice="
            f"{losses['loss_dice'][-1].item():.4f} num_masks="
            f"{int(losses['num_masks'].item())}")
    launches = {k: fn.launches for k, fn in cnt.items()}
    peak = torch.cuda.max_memory_allocated()
    n_steps = 1 + TRAIN_STEPS
    log(f"train path: {n_steps} steps, launches {launches}")
    for k, per in PER_TRAIN_STEP.items():
        if launches[k] != per * n_steps:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} per train step x {n_steps}")
    # only the backbone's final k1 projection sits outside Mask3D's loss:
    # its zero-initialised bias gets no gradient and no decay
    unchanged = [n for a, (n, p) in zip(before,
                                        trainer.model.named_parameters())
                 if torch.equal(a, p)]
    if any(not n.startswith("backbone.final.") for n in unchanged):
        raise AssertionError(f"params unchanged after {n_steps} steps: "
                             f"{unchanged}")
    warm = statistics.median(times[1:])
    log(f"train bf16, batch {TRAIN_BATCH}: first step {times[0]:.1f}ms, "
        f"warm median of {TRAIN_STEPS} {warm:.1f}ms "
        f"(min {min(times[1:]):.1f}, max {max(times[1:]):.1f}) = "
        f"{1e3 * TRAIN_BATCH / warm:.2f} scenes/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; {len(before) - len(unchanged)} of "
        f"{len(before)} params changed (unchanged: {unchanged})")
    return launches, trainer, gen


def phase_train_profile(trainer, batch, gen):
    """One more bf16 step split by part (CUDA events on the stream: forward,
    matcher, criterion, backward, AdamW + BN update), then a step under
    torch.profiler (device tracing) for the idle share and the kernels."""
    from torch.profiler import ProfilerActivity

    model, crit = trainer.model, trainer.criterion
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    out = model(batch, generator=gen)
    ev[1].record()
    crit.matcher(out["pred_logits"].detach(), out["pred_masks_seg"].detach(),
                 batch.target, batch.seg_valid)
    ev[2].record()
    losses = crit(out, batch)
    ev[3].record()
    grads = torch.autograd.grad(losses["total"], trainer.params,
                                allow_unused=True)
    ev[4].record()
    trainer.optimizer.step(trainer.params,
                           [torch.zeros_like(p) if gr is None else gr
                            for p, gr in zip(trainer.params, grads)])
    for bn in trainer._bns:
        bn.update_running_stats()
    ev[5].record()
    ev[5].synchronize()
    parts = ("forward", "matcher", "criterion (matcher + losses)",
             "backward", "AdamW + BN stats")
    log("train step parts (CUDA events): " + ", ".join(
        f"{name} {ev[i].elapsed_time(ev[i + 1]):.1f}ms"
        for i, name in enumerate(parts)))
    del out, losses, grads
    rows, busy, window = _traced(lambda: trainer.train_step(batch, gen),
                                 [ProfilerActivity.CUDA], reps=1)
    if not rows:
        log("train profile: no device time in the trace (not measured)")
        return
    log(f"train profile (device tracing): device busy {busy:.1f}ms of a "
        f"{window:.1f}ms traced step, idle share {1 - busy / window:.1%}; "
        f"{sum(r[2] for r in rows)} device ops per step")
    for ms, name, n in rows[:12]:
        log(f"  {ms:8.2f}ms {100 * ms / busy:5.1f}%  x{n:<4d} {name[:90]}")


class _Pinned:
    """A matcher that answers with given indices; what its own matcher would
    have answered is kept in `own`."""

    def __init__(self, matcher, matched):
        self.matcher, self.matched, self.own = matcher, matched, None

    def __call__(self, *args):
        self.own = self.matcher(*args)
        return self.matched


def _relative(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


def phase_train_parity(dev):
    """One f32 train step of the same seeded trainer on the card (kernels)
    and on the CPU (twins), on a ~30k-voxel scene: losses, every gradient,
    the updated params and BN running stats.

    The step takes discrete decisions: the point samples (top-k), the
    decoder's block masks (sigmoid(readout) < 0.5), the matching and every
    ReLU's sign. At random weights a last-bit difference flips some of them
    (on the CPU alone, a 5e-7 relative weight perturbation moves a backbone
    kernel's gradient by 14% of its max through ReLU flips, and a 5e-6 one
    the late prediction sets' logits by up to 28%). So the CPU step
    replays the card's decisions, in call order, and the comparison holds
    the arithmetic of the kernels rather than the thresholds. The CPU's own
    auction is reported against the card's."""
    import dataclasses

    import unscene3d_torch.models.mask3d as m3d
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.train.loop import build_trainer

    scene = make_scene(num_points=30_000, num_objects=6, extent=4.0, seed=7)
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fps_queries=100)([scene])
    relu, sample_level, attend_level = (torch.relu, m3d._sample_level,
                                        m3d._attend_level)
    decisions = {"relu": [], "sample": [], "blocked": []}
    replay = {}

    def record_relu(x):
        decisions["relu"].append((x > 0).cpu())
        return relu(x)

    def record_sample(*args, **kw):
        out = sample_level(*args, **kw)
        decisions["sample"].append(tuple(t.cpu() for t in out))
        return out

    def record_attend(layers, queries, query_pos, blocked, *rest):
        decisions["blocked"].append(blocked.cpu())
        return attend_level(layers, queries, query_pos, blocked, *rest)

    def replayed(kind, like=None):
        got = next(replay[kind])
        if like is not None and got.shape != like.shape:
            raise AssertionError(f"{kind} replay out of step")
        return got

    def replay_relu(x):
        return x * replayed("relu", x).to(x.dtype)

    def replay_attend(layers, queries, query_pos, blocked, *rest):
        return attend_level(layers, queries, query_pos,
                            replayed("blocked", blocked), *rest)

    res = {}
    try:
        for name in ("cuda", "cpu"):
            t0 = time.perf_counter()
            on_card = name == "cuda"
            tr = build_trainer(torch.float32, seed=0,
                               device=dev if on_card else "cpu")
            b = batch.to(dev) if on_card else batch
            if on_card:
                torch.relu = record_relu
                m3d._sample_level = record_sample
                m3d._attend_level = record_attend
            else:
                replay.update((k, iter(v)) for k, v in decisions.items())
                torch.relu = replay_relu
                m3d._sample_level = lambda *a, **k: replayed("sample")
                m3d._attend_level = replay_attend
                tr.criterion = dataclasses.replace(
                    tr.criterion, matcher=_Pinned(
                        tr.criterion.matcher, res["cuda"][0]["matched_q"]))
            losses, grads = tr.loss_and_grads(
                b, torch.Generator().manual_seed(0))
            torch.relu = relu
            tr.optimizer.step(tr.params, grads)
            for bn in tr._bns:
                bn.update_running_stats()
            torch.cuda.synchronize()
            res[name] = ({k: v.cpu() for k, v in losses.items()},
                         [gr.cpu() for gr in grads],
                         {k: v.cpu() for k, v in tr.model.state_dict().items()})
            log(f"  train parity {name} step: {time.perf_counter() - t0:.1f}s "
                f"total={losses['total'].item():.6f}")
    finally:
        torch.relu = relu
        m3d._sample_level, m3d._attend_level = sample_level, attend_level
    if any(next(it, None) is not None for it in replay.values()):
        raise AssertionError("the CPU step took fewer decisions than the card")
    log(f"  replayed decisions: {len(decisions['relu'])} ReLUs, "
        f"{len(decisions['sample'])} samples, "
        f"{len(decisions['blocked'])} block masks")
    (lg, gg, sg), (lc, gc, sc) = res["cuda"], res["cpu"]
    agree = (tr.criterion.matcher.own == lg["matched_q"]).float().mean().item()
    log(f"  CPU auction vs card auction on the same step: {agree:.1%} of "
        "matched indices equal")
    worst = {k: _relative(lg[k], lc[k])
             for k in ("loss_ce", "loss_mask", "loss_dice", "total")}
    # each gradient against its tensor's max, plus a floor for gradients
    # that are zero in exact arithmetic (the keys' biases: softmax ignores a
    # shift shared by all keys), where both sides hold rounding noise
    g_floor = GRAD_FLOOR * max(b.abs().max().item() for b in gc)
    g_err, g_name = max(
        ((a - b).abs().max().item() / (b.abs().max().item() + g_floor), n)
        for a, b, (n, _) in zip(gg, gc, tr.model.named_parameters()))
    # Adam's first update is ~lr * sign(g): a gradient at rounding-noise
    # level may flip, so params agree to two first-step learning rates
    p_tol = 2 * 1e-4 / 25 + 1e-6
    p_err, p_name = max(((sg[k] - sc[k]).abs().max().item(), k)
                        for k in sc)
    log(f"  train parity (f32, {meta.num_voxels[0]} voxels, samples, block "
        f"masks and matching replayed): loss rel errs "
        f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())} (tol "
        f"{TRAIN_LOSS_TOL:g}); worst gradient {g_name} {g_err:.2e} of its "
        f"tensor's max + {GRAD_FLOOR:g} of the largest (tol {GRAD_TOL:g}); "
        f"params + BN stats max abs diff {p_err:.2e} at {p_name} (tol "
        f"{p_tol:.1e})")
    if not max(worst.values()) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"train parity losses: rel errs {worst}")
    if not g_err <= GRAD_TOL:
        raise AssertionError(f"train parity grads: {g_name} rel err {g_err}")
    if not p_err <= p_tol:
        raise AssertionError(f"train parity params/BN stats: {p_name} "
                             f"{p_err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev, card = phase_device()
    phase_build()
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene

    t0 = time.perf_counter()
    batch, _ = FreeMaskCollator(voxel_size=VOXEL, fine_buckets=True,
                                fps_queries=100)(
        [make_scene(**BENCH_SCENE, seed=0)])
    log(f"bench scene collate: {time.perf_counter() - t0:.2f}s")
    res = phase_kernels(dev, batch)
    launches_eval, preds, served = phase_slice(dev)
    phase_profile(preds, served)
    phase_parity(dev, preds[torch.float32].model)
    del preds, served, batch
    torch.cuda.empty_cache()

    tbatch = train_batch()
    res.update(phase_train_kernels(dev, tbatch))
    tbatch = tbatch.to(dev)
    launches_train, trainer, gen = phase_train(dev, tbatch)
    phase_train_profile(trainer, tbatch, gen)
    del trainer, tbatch
    torch.cuda.empty_cache()
    phase_train_parity(dev)

    main_case = {"conv3_fwd": (0, 128, 96, torch.bfloat16),
                 "k_apply_gemm": ("up", torch.bfloat16),
                 "k_apply_sum": (128, torch.float32),
                 "segment_sum": torch.float32,
                 "conv3_bwd": (0, 128, 96, torch.bfloat16),
                 "conv3_dw": (0, 128, 96, torch.bfloat16)}
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        m = res[name][main_case[name]]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches_eval[name] + launches_train[name],
            launches_eval=launches_eval[name],
            launches_train=launches_train[name],
            max_abs_err=max(r["max_abs_err"] for r in res[name].values()),
            ms=m["ms"], plain_ms=m["plain_ms"]))
    log(f"total {time.perf_counter() - T_START:.1f}s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
