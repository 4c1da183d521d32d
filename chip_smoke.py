"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds each
against its plain twin at main-path shapes, drives the eval path through
`unscene3d_torch.inference` on the bench scene and the train path through
`unscene3d_torch.train.loop` on bench.py's batch-8 train batch, both in the
default configuration (kernels 1-5) and with `csr_levels=(0, 1, 2)` (kernel
6 at those levels), the batch-8 train step also in f32 (the trainer's
default dtype), the brick conv engine (kernel 7) on the bench scene's
level 0, the two prototype entry points `unscene3d_torch.bench.proto_*`
(kernels 8 and 9) at that level, and the pseudo-mask half: the batched NCut
row (64 scenes x 400 segments x 96 features) and the bench scene through
`unscene3d_torch.pseudo.pipeline`; it checks card-vs-CPU parity on a
mid-size scene and on 8 NCut scenes, and reports whether two train steps
from the same state are bitwise equal (a printed finding). It also builds
the native host library (`unscene3d_torch/native`, g++) that the collator's
k3 maps and FPS seeds go through, asserts that it served every collate of
the main path, and times each request by stage: collate (voxelize, k3 maps,
FPS, the rest), transfer, forward, the device post-processing, the
device-to-host copy and the host's segment-space tail, beside the
full-resolution host route on the same forward (held to the reference's
contract) and one request through the DBSCAN route. Last, it runs a
self-training round through `unscene3d_torch.main_instance_segmentation`
(round 1, the export, round 2 with the merge; f32, batch 8, on scenes of
the train batch's size written in the reference's npy layout) and asserts
a bitwise checkpoint restore, every export found and the kernels' launches.
Then the pseudo masks as the paper makes them (`modality=both`): DINO
ViT-S/8 and CSC features from seeded random checkpoints on 2 bench scenes
with 75 frames each, timed by stage, and `python -m
unscene3d_torch.pseudo_masks_main` on a ScanNet-layout directory written
here (meshes, JPEG frames), asserting the segmentator's calls and the
CSC forward's launches. Last, the training options: the noise-robust
tri-plane loss on the train batch (kernel 3 at the tri-plane shapes, f32
and bf16 steps beside the plain ones, the loss's own device time, steps
bitwise repeatable with it and with dropout, card-vs-CPU parity of the
loss), then the loss, dropout, pre-norm, the Mix3D merge collator and the
eval collate pool through the entry point's functions, and one bench
forward per decoder mode group (level embeddings + np features + max
pooling + max_sample_size, learned queries, random queries). Then
supervised training (`phase_supervised`): scripts/scannet/scannet_val.sh's
overrides through the entry point on SemanticSegmentationDataset (8 + 2
bench-scene-sized scenes with multi-class targets, 3 f32 steps of batch 8,
one validation with save_visualizations, kernels 1-5's launches), and the
three evaluation CLIs (`phase_eval_clis`: eval_freemask_gt_performance,
eval_3duis_performance with the port's HDBSCAN, eval_cutler_projection on
the card and on the CPU, per-frame ids equal). After the
self-training round, data parallelism (`phase_train_dp`): the f32 step over
NCCL at world size 1 bitwise the plain step, two ranks on the one card over
gloo (4 of the train batch's scenes each) bitwise the mean-of-shards
oracle computed on the card, with each rank's launches of kernels 1-5, its
step and wait times and the all-reduce's time and bytes; and, only where
the machine has two cards or more, the same over NCCL on two cards and the
entry point on two cards, at f32 tolerance. Kernel 1 and 4's dx walk each
level in its row order (ops/conv3.py:row_order): each of their cases also
runs in the rows' own order (bitwise equal, both timed), beside every
level's products over its valid pairs and its order's build time.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase kernels      # kernels 1-5, the f32 step
    python3 chip_smoke.py --phase train_dp     # that phase alone
    python3 chip_smoke.py --phase supervised   # or eval_clis: that phase alone

Needs one NVIDIA GPU and nvcc; exits nonzero without them. Phases print one
line each; the line before the last is a JSON object of per-kernel numbers
measured in this run (`bound_ms` computed from this run's inputs against
the H100's published peaks), and the last line is the contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import re
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
CSR_LEVELS = (0, 1, 2)   # the csr012 variant of benchmarks/profile_fwd.py
CSR_TRAIN_STEPS = 3      # timed csr_levels steps, after one warm-up step
F32_TRAIN_STEPS = 3      # timed f32 steps, after one warm-up step
# published peaks of one H100 SXM (dense): bytes/s of HBM3 and FLOP/s by
# the type of the products (bf16 tensor cores; f32 outside them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
# device-post route vs host route on one forward, the reference's contract
# (tests/test_eval.py:99): masks and classes equal, scores to rtol 1e-5 (f32
# sigmoid sums on the device, f64 on the host)
ROUTE_RTOL = 1e-5
# native library calls per single-scene collate: the k3 map of each of the
# 5 levels, one FPS
NATIVE_PER_COLLATE = {"build_neighbor_map_padded": 5,
                      "furthest_point_sample": 1}
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
    "csr_conv3": ("unscene3d_torch/csrc/csr_conv.cu",
                  "unscene3d_tpu/ops/csr_conv.py:150"),
    "brick_conv3": ("unscene3d_torch/csrc/brick_conv.cu",
                    "unscene3d_tpu/ops/brick_engine.py:176"),
    "brick_conv_proto": ("unscene3d_torch/csrc/proto_brick.cu",
                         "benchmarks/proto_brick_pallas.py:150"),
    "win_decompose": ("unscene3d_torch/csrc/win_decompose.cu",
                      "benchmarks/proto_win_decompose.py:30"),
}
# launches per eval forward of Mask3D(Res16UNet34C): 1 stem + 23 blocks x 2
# k3 convs; 4 down2 + 4 up2; 4 coordinate + 4 mask-feature pools; 1 pool
PER_FORWARD = {"conv3_fwd": 47, "k_apply_gemm": 8, "k_apply_sum": 8,
               "segment_sum": 1, "conv3_bwd": 0, "conv3_dw": 0,
               "csr_conv3": 0, "brick_conv3": 0, "brick_conv_proto": 0,
               "win_decompose": 0}
# with csr_levels=(0, 1, 2): the stem and the 22 block convs of levels 0-2
# go through kernel 6, the 24 of levels 3 and 4 through kernel 1
PER_FORWARD_CSR = dict(PER_FORWARD, conv3_fwd=24, csr_conv3=23)
# launches per train step (remat on): k3 forward 47 + 46 recomputed in the
# 23 blocks' backward; dx of every k3 conv but the stem (its input features
# need no gradient) and dW of all 47; k2 convs 8 forward + 8 dx; the same 8
# pools and 1 segment sum (the pooled readout is under a stopped gradient)
PER_TRAIN_STEP = {"conv3_fwd": 93, "conv3_bwd": 46, "conv3_dw": 47,
                  "k_apply_gemm": 16, "k_apply_sum": 8, "segment_sum": 1,
                  "csr_conv3": 0, "brick_conv3": 0, "brick_conv_proto": 0,
                  "win_decompose": 0}
# with csr_levels=(0, 1, 2): kernel 6 runs 23 forward + 22 recomputed + 22
# dx (none for the stem); kernel 1 24 + 24 recomputed, kernel 4 at the 24
# convs of levels 3 and 4; kernel 5 their 24 dW and the 23 of the CSR levels
PER_TRAIN_STEP_CSR = dict(PER_TRAIN_STEP, conv3_fwd=48, conv3_bwd=24,
                          conv3_dw=47, csr_conv3=67)
# the CSC feature extractor (the backbone alone, multires mode): the 47 k3
# convs and the 8 k2 convs; no pools, no segment sum
PER_CSC_FORWARD = dict(PER_FORWARD, k_apply_sum=0, segment_sum=0)
# the self-training round (phase_self_train): scenes of the train batch's
# size, the same ones for train and validation; the overrides of
# scripts/unsupervised/train_unscene3d.sh and of the export in
# scripts/mask3d_DINO_CSC_self_train.sh
SELF_TRAIN_SCENES = 8
SELF_TRAIN_ROUND = [
    "general.experiment_name=DINO_CSC_self_train",
    "general.project_name=unscene3d", "general.eval_on_segments=true",
    "general.train_on_segments=true", "general.num_targets=3",
    "data.batch_size=8", "data.test_batch_size=1",
    "data/collation_functions=freemask_voxelize_collate",
    "data/datasets=freemask", "general.resume=True"]
SELF_TRAIN_EXPORT = [
    "general.train_mode=false", "general.experiment_name=DINO_CSC_self_train",
    "general.save_for_freemask=true", "general.filter_out_instances=true",
    "general.eval_on_segments=true", "general.num_targets=3",
    "data/datasets=freemask"]
# phase_train_dp: ranks on the one card (gloo), each with 8 / DP_RANKS of
# the train batch's scenes; on two cards (NCCL) the state after a step
# against the mean-of-shards oracle, relative to each tensor's max (the
# same kernels on another card of the same kind: f32 summation order)
DP_RANKS = 2
DP_CARDS_TOL = 1e-4
# the noise-robust tri-plane loss (phase_train_noise_robust): kernel 3 runs
# the mask-feature pool, the target and the prediction projections (all
# three planes in one call each), the per-scene loss sums, and in the
# backward the segment-to-voxel spread of the prediction's gradient
PER_TRAIN_STEP_NR = dict(PER_TRAIN_STEP, segment_sum=5)
NR_STEPS = 3             # timed noise-robust steps per dtype, after a warm-up
# loss_noise_robust on the parity scene, relative: the card's f32 loss
# against the same math in f64 (NR_EXACT_TOL), and the card's against the
# CPU twin's (NR_LOSS_TOL). The BCE's log(1 - p) scales one ulp of p by
# 1 / (1 - p), and 1 - p gets small there, so an f32 evaluation may sit
# far from the f64 value; the CPU twin's sits farther than the card's
# (_noise_robust_parity prints both). The gradient to the segment logits,
# relative to its max, is held to f32 summation order
NR_EXACT_TOL, NR_LOSS_TOL, NR_GRAD_TOL = 1e-5, 1e-4, 1e-5
# phase_train_options: the training options of the round, over the overrides
# of scripts/unsupervised/train_unscene3d.sh
TRAIN_OPTIONS = ["loss.weight_noise_robust=1.0", "model.dropout=0.1",
                 "model.pre_norm=true",
                 "data/collation_functions=voxelize_collate_merge",
                 "data.prefetch_processes=2"]
# the decoder's other query and pooling modes, one eval forward each on the
# bench scene at full width
MODE_GROUPS = {
    "level_embed+np_features+max_scatter+max_sample_size": dict(
        use_level_embed=True, use_np_features=True, scatter_type="max",
        max_sample_size=True),
    "learned_queries": dict(non_parametric_queries=False),
    "random_query_both+random_normal": dict(
        non_parametric_queries=False, random_query_both=True,
        random_normal=True),
}
# measured plain steps and round numbers, filled by the phases that take
# them: name -> (warm ms, peak bytes) or (scenes/s through fit, eval s a
# scene)
STEP_STATS = {}
# the pseudo masks as the paper makes them (phase_pseudo_both): DINO
# ViT-S/8 at stride 4 on ScanNet's 480 x 640 frames x downsample_ratio 0.4
# (conf/pseudo/default.yaml) and CSC res_2 features, 2 scenes of the bench
# scene's size, 75 frames each (a ~1,500-frame scan at frame_skip 20), NCut
# with conf/pseudo/default.yaml's freemask values
PSEUDO_BOTH_SCENES = 2
PSEUDO_FRAMES = 75
FRAME = (192, 256)
FREEMASK = dict(affinity_tau=0.6, max_number_of_instances=20,
                similarity_metric="cos", max_extent_ratio=0.8,
                min_segment_size=4, separation_mode="max")
# one frame's DINO features, card vs CPU, relative to max|CPU|: 10 blocks of
# f32 products summed in another order
DINO_TOL = 1e-4
# the ScanNet-layout run of the entry point (phase_pseudo_main): 2 meshes
# of 300 x 300 vertices (8 m at 2.7 cm), 4 JPEG frames each
MAIN_MESH = dict(grid=300, spacing=0.027, num_objects=12)
MAIN_FRAMES = 4
# supervised Mask3D training (phase_supervised): the overrides of
# scripts/scannet/scannet_val.sh through the entry point, on bench-scene-
# sized scenes in the Mask3D npy layout whose instances carry ScanNet20
# class indices 0..17 (scannet.yaml filters 0 and 1, wall and floor; its
# label_offset 0 leaves room for 0..17 in the 19-way head), 3 f32 steps of
# batch 8 and one validation with save_visualizations
SCANNET_VAL = ["general.experiment_name=scannet_val",
               "general.eval_on_segments=true",
               "general.train_on_segments=true",
               "general.project_name=mask3d", "data/datasets=scannet",
               "general.num_targets=19", "data.num_labels=20",
               "general.resume=True"]
SUPERVISED_SCENES = {"train": 8, "validation": 2}
SUPERVISED_CLASSES = tuple(range(18))
SUPERVISED_STEPS = 3
# the evaluation CLIs (phase_eval_clis): 2 meshes of phase_pseudo_main's
# size, pseudo masks from their GT, CutLER-style id maps of 480 x 640 from
# EVAL_FRAMES poses each
EVAL_FRAMES = 8
MASK_IMAGE = (480, 640)
# the pseudo row of bench.py: scenes x segments x features
PSEUDO_ROW = dict(batch_scenes=64, num_segments=400)
EIGH_SCENES = 16         # scenes of the row timed with the exact solver
NCUT_PARITY_SCENES = 8   # card-vs-CPU NCut scenes (f32)
# planted-object recovery of cholinv against eigh, the reference's own
# acceptance criterion (tests/test_ncut_solver_agreement.py): within 0.10
RECOVERY_TOL = 0.10
# the brick route (phase_brick_route, phase_brick_train, phase_brick_entry,
# phase_brick_parity): the JAX collator's `brick_levels` at levels 0 and 1
# for the bench scene, level 0 for the train batch
BRICK_LEVELS = (0, 1)
BRICK_TRAIN_LEVELS = (0,)
BRICK_PARITY_LEVELS = (1,)
# the brick route's bf16 outputs against the gather route's bf16 ones, as a
# multiple of the gather route's own bf16-vs-f32 spread per output (two
# routes through the same f32 math that round to bf16 at other points;
# tests/test_torch_mask3d.py's BF16_FACTOR)
BRICK_BF16_FACTOR = 2.0
# phase_resunet: the MinkUNet / ResNet families with ScanNet's 20 classes
RESUNET_CLASSES = 20
# phase_lseg: ScanNet's 480 x 640 frames x 0.4 (conf/pseudo/default.yaml's
# downsample_ratio; both divisible by 32) and the JAX LSegNet's default
# size; the tiny configuration card vs CPU relative to max|CPU| (f32
# products summed in another order)
LSEG_FRAMES = ((192, 256), (256, 320))
LSEG_TOL = 1e-4
# phase_renderers: card vs CPU relative to max|CPU|: the nearest render's
# sums in another order (kernel 3 against index_add_) RENDER_TOL; the
# interpolating render INTERP_TOL, set from its reading of 1.68e-5 on an
# NVIDIA H100 80GB HBM3 at 700 W (its source is not yet known: the weights
# sqrt(3) - |pos - corner| cancel near a far corner, and w / (1e-4 + sum w)
# scales a weight's last bit by up to 1 / sum w where the sum is small)
RENDER_TOL, INTERP_TOL = 1e-5, 1e-4


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2,
            spin: bool = False) -> float:
    """Median milliseconds of fn on the current stream (CUDA events); spin:
    each run queued behind a spin kernel, so that a kernel's time holds no
    host issue time (bench/timing.py)."""
    from unscene3d_torch.bench.timing import device_ms

    return device_ms(fn, "cuda", reps, warmup, spin)


def counters():
    from unscene3d_torch.ops.brick_engine import brick_conv3
    from unscene3d_torch.ops.conv3 import conv3_bwd, conv3_dw, conv3_fwd
    from unscene3d_torch.ops.csr_conv import csr_conv3_fwd
    from unscene3d_torch.ops.k_apply import k_apply_gemm, k_apply_sum
    from unscene3d_torch.ops.proto_brick import proto_brick_conv
    from unscene3d_torch.ops.segment_pool import segment_sum
    from unscene3d_torch.ops.win_decompose import win_conv_variant

    return {"conv3_fwd": conv3_fwd, "k_apply_gemm": k_apply_gemm,
            "k_apply_sum": k_apply_sum, "segment_sum": segment_sum,
            "conv3_bwd": conv3_bwd, "conv3_dw": conv3_dw,
            "csr_conv3": csr_conv3_fwd, "brick_conv3": brick_conv3,
            "brick_conv_proto": proto_brick_conv,
            "win_decompose": win_conv_variant}


def reset_counters():
    cnt = counters()
    for fn in (*cnt.values(), *_order_builders()):
        fn.launches = 0
    return cnt


def _order_builders():
    from unscene3d_torch.ops.conv3 import row_order_keys, row_order_tally

    return row_order_keys, row_order_tally


def order_launches():
    """The row order's key and tally kernel launches since the last reset:
    one each an order built on the card (ops/conv3.py:row_order)."""
    return {fn.__name__: fn.launches for fn in _order_builders()}


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped): each input read once, each
    output written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def hits(table) -> int:
    """Entries of a neighbour / child / parent map that are no miss (misses
    point at the map's largest row)."""
    return int((table != table.max()).sum().item())


def distinct_rows(table) -> int:
    """Rows a map points at, each counted once, misses (the map's largest
    row) left out: the rows a gather over the map must read at least once."""
    return int(torch.unique(table[table != table.max()]).numel())


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
    from unscene3d_torch import native
    from unscene3d_torch.ops import _build

    t0 = time.perf_counter()
    path = native.build()
    native.load()
    log(f"native host library: {time.perf_counter() - t0:.1f}s "
        f"({path.split('/')[-1]}, g++ {' '.join(native.FLAGS)})")
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f}s (nvcc ran: "
        f"{_build.build_seconds is not None}) sources="
        f"{[s.split('/')[-1] for s in _build.sources()]}")
    # ptxas -v per kernel: "Compiling entry function '<mangled>'", then its
    # spill and register lines; every kernel keeps its values in registers
    entry, spills = "", []
    for ln in _build.build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "registers" in ln or "spill" in ln:
            log(f"  ptxas {entry}: {ln.split(':', 1)[-1].strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m and m.groups() != ("0", "0"):
                spills.append(entry)
    if spills:
        raise AssertionError(f"ptxas spills registers in {spills}")


def _compare(name, dtype, kernel, twin, tol=None, work=None, library=None,
             other=None, equal_rows=None, other_rows=None,
             twin_bitwise=False):
    """Run kernel twice (bitwise equal), compare with the twin (bitwise
    where twin_bitwise: the same f32 adds in the same order), time both.
    work = (bytes moved, FLOPs done, dtype of the products) gives the bound:
    the larger of bytes over the card's memory rate and FLOPs over its peak
    rate for that type (FLOPs may be a dict by dtype, whose times add). library: one PyTorch call computing the same
    function, timed only. other = (name, fn): another kernel of the port
    that computes the same function, held to the same tolerance and
    timed (on the rows of other_rows only where given: kernel 9's `full`
    lacks the spilled pairs); equal_rows: a row mask on which the two must
    be bitwise equal."""
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {dtype}: two runs differ")
    ref = twin()
    if twin_bitwise and not torch.equal(got, ref):
        raise AssertionError(f"{name} {dtype}: not bitwise its twin")
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-6)
    tol = KERNEL_TOL[dtype] if tol is None else tol
    ms, plain_ms = cuda_ms(kernel, spin=True), cuda_ms(twin, spin=True)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=None,
               bound_by=None, library_ms=None)
    extra = ""
    if work is not None:
        moved, flops, kind = work
        by_bytes = 1e3 * moved / PEAK_BYTES
        if isinstance(flops, dict):     # operations of more than one type
            by_ops = sum(1e3 * f / PEAK_FLOPS[k] for k, f in flops.items())
            flops = sum(flops.values())
        else:
            by_ops = 1e3 * flops / PEAK_FLOPS[kind]
        out["bound_ms"] = max(by_bytes, by_ops)
        out["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        extra += (f" bound_ms={out['bound_ms']:.4f} ({out['bound_by']}: "
                  f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    if library is not None:
        out["library_ms"] = cuda_ms(library, spin=True)
        extra += f" library_ms={out['library_ms']:.3f}"
    if other is not None:
        other_name, other_fn = other
        alt = other_fn()
        held = slice(None) if other_rows is None else other_rows
        other_err = (got[held].float() - alt[held].float()).abs().max().item()
        out["other_ms"] = cuda_ms(other_fn, spin=True)
        extra += (f" vs {other_name}: max_rel_err={other_err / scale:.3e} "
                  f"{other_name}_ms={out['other_ms']:.3f} (ratio "
                  f"{ms / out['other_ms']:.3f})")
        if not other_err <= tol * scale:
            raise AssertionError(f"{name} {dtype} vs {other_name}: error "
                                 f"{other_err} > {tol} * {scale}")
        if equal_rows is not None:
            if not torch.equal(got[equal_rows], alt[equal_rows]):
                raise AssertionError(f"{name} {dtype}: not bitwise "
                                     f"{other_name} on the masked rows")
            extra += f" bitwise {other_name} on valid rows"
    if twin_bitwise:
        extra += " bitwise its twin"
    log(f"  {name:44s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
        f"max_rel_err={err / scale:.3e} (tol {tol:g}) ms={ms:.3f} "
        f"plain_ms={plain_ms:.3f}{extra}")
    if not err <= tol * scale:
        raise AssertionError(f"{name} {dtype}: error {err} > {tol} * {scale}")
    return out


def _dense_ratio(order):
    """The products a launch in `order` computes over the valid pairs'."""
    return 32 * order.live_groups.item() / max(order.pairs.item(), 1)


def _own_order(nbr_idx):
    """The rows of nbr_idx in their own order (the identity), with the key
    and the tally kernels' tally."""
    from unscene3d_torch.ops.conv3 import (RowOrder, row_order_keys,
                                           row_order_tally)

    keys = row_order_keys(nbr_idx)
    order = torch.arange(nbr_idx.shape[1], dtype=torch.int32,
                         device=nbr_idx.device)
    return RowOrder(order, keys, *row_order_tally(keys).unbind())


def _order_beside(name, dtype, launch, nbr_idx, order):
    """launch(order) (kernel 1 or 4's dx over nbr_idx in its row order)
    against launch(identity) (the rows in the level's own order): bitwise
    equal; both spin-timed, in turns (order, identity, identity, order),
    with each order's products over the valid pairs'."""
    ident = _own_order(nbr_idx)
    got, base = launch(order), launch(ident)
    torch.cuda.synchronize()
    if not torch.equal(got, base):
        raise AssertionError(f"{name} {dtype}: not bitwise in the row order")
    t = [cuda_ms(lambda: launch(o), spin=True)
         for o in (order, ident, ident, order)]
    out = dict(ordered_ms=(t[0] + t[3]) / 2, identity_ms=(t[1] + t[2]) / 2,
               ordered_ratio=_dense_ratio(order),
               identity_ratio=_dense_ratio(ident))
    log(f"  {name:44s} {str(dtype)[6:]:8s} row order ms="
        f"{out['ordered_ms']:.3f} (products / pairs "
        f"{out['ordered_ratio']:.3f}) own order ms={out['identity_ms']:.3f} "
        f"({out['identity_ratio']:.3f}), bitwise equal")
    return out


def phase_order_ratios(batch, what):
    """Each level's row order built on the card (ops/conv3.py:row_order)
    against the plain twins on the host over the same map: the order, the
    sorted masks and the tally equal (torch.equal), and the own order's
    tally too; each level's products over the valid pairs' in its own row
    order and in its row order, the order's build time (keys, sort, tally;
    spin-timed), and the key and tally kernels' launches."""
    from unscene3d_torch.ops.conv3 import (row_order, row_order_keys,
                                           row_order_keys_plain,
                                           row_order_tally,
                                           row_order_tally_plain)

    total = 0.0
    for lv, level in enumerate(batch.graph.levels):
        nbr = level.nbr_idx.to("cuda")
        row_order_keys.launches = row_order_tally.launches = 0
        own, by_mask = _own_order(nbr), row_order(nbr)
        launches = order_launches()
        if set(launches.values()) != {2}:
            raise AssertionError(f"{what} L{lv}: two row orders launched "
                                 f"{launches}")
        keys = row_order_keys_plain(nbr.cpu())
        srt, order = torch.sort(keys, stable=True)
        for got, want, part in (
                (by_mask.order, order.int(), "order"),
                (by_mask.keys, srt, "sorted masks"),
                (torch.stack([by_mask.live_groups, by_mask.pairs]),
                 row_order_tally_plain(srt), "tally"),
                (own.keys, keys, "masks"),
                (torch.stack([own.live_groups, own.pairs]),
                 row_order_tally_plain(keys), "own order's tally")):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{what} L{lv}: the card's row order "
                                     f"{part} differs from the twins'")
        ms = cuda_ms(lambda: row_order(nbr), spin=True)
        total += ms
        log(f"  {what} L{lv}: {level.num_padded} rows, "
            f"{by_mask.pairs.item()} valid pairs, products / pairs "
            f"{_dense_ratio(own):.3f} in the level's order, "
            f"{_dense_ratio(by_mask):.3f} in its row order; built in "
            f"{ms:.3f} ms; equal to the twins, launches {launches} for "
            f"two orders")
    log(f"  {what}: the five row orders {total:.3f} ms")


def _compare_pool(name, fine, coarse, c, dtype, g, dev):
    """Kernel 2's 8-child sum (avg_pool2) from `fine` to `coarse` on a
    random (fine rows, c) input, bitwise its twin. The library call: one
    embedding_bag sum over each row's 8 children with the miss row as
    padding_idx (no out-row mask)."""
    from unscene3d_torch.ops.k_apply import k_apply, k_apply_plain

    x = torch.randn(fine.num_padded, c, generator=g).to(dev, dtype)
    table, valid = coarse.child_idx, coarse.valid
    bags = table.t().contiguous()
    read = hits(table)
    return _compare(
        f"k_apply_sum pool {name} C={c}", dtype,
        lambda: k_apply(x, table, None, valid),
        lambda: k_apply_plain(x, table, None, valid),
        # bytes: the table, the flags, the rows it points at (padding rows
        # and the miss row are never read) and the output
        work=(nbytes(table, valid)
              + (read + coarse.num_padded) * c * x.element_size(),
              read * c, torch.float32),
        library=lambda: torch.nn.functional.embedding_bag(
            bags, x, mode="sum", padding_idx=fine.num_padded - 1),
        twin_bitwise=True)


def _compare_segment_sum(name, batch, dtype, g, dev):
    """Kernel 3 on a random (N_0, 128) input over the batch's segments (its
    host order and pieces), as Mask3D.forward's mask-feature pool calls it.
    The library call: one index_add_ of all rows into S + 1 segments, the
    last one collecting the invalid rows (atomics: not deterministic, so
    nothing in the port calls it on the card)."""
    from unscene3d_torch.ops.segment_pool import segment_sum, segment_sum_plain

    lvl = batch.graph.levels[0].to(dev)
    S = batch.batch_size * batch.num_segments_padded
    seg_flat = (lvl.coords[:, 0].long() * batch.num_segments_padded
                + batch.point2segment.to(dev).long())
    xs = torch.randn(lvl.num_padded, 128, generator=g).to(dev, dtype)
    order, pieces = batch.seg_order.to(dev), batch.seg_pieces.to(dev)
    walk = dict(order=order, offsets=batch.seg_offsets.to(dev), pieces=pieces)
    dump = torch.where(lvl.valid, seg_flat, S)
    pooled = torch.zeros(S + 1, 128, dtype=dtype, device=dev)
    return _compare(
        f"segment_sum {name} ({lvl.num_padded},128)->({S},128)", dtype,
        lambda: segment_sum(xs, seg_flat, S, lvl.valid, **walk),
        lambda: segment_sum_plain(xs, seg_flat, S, lvl.valid),
        # bytes: the rows of the order (invalid rows and ids out of range
        # are absent and never read), the order, the pieces and the output
        work=(nbytes(order, pieces)
              + (order.numel() + S) * 128 * xs.element_size(),
              order.numel() * 128, torch.float32),
        library=lambda: pooled.zero_().index_add_(0, dump, xs))


def phase_kernels(dev, batch, csr_batch):
    """Kernels 1-3 against their twins at the bench scene's shapes (kernel
    2's pool at each of its four instances); kernel 1 at level 0 also
    against kernel 6 on the same inputs over the pair tables of csr_batch
    (the same scene collated with csr_levels), bitwise on valid rows in
    both dtypes."""
    from unscene3d_torch.ops.conv3 import (conv3_fwd, conv3_fwd_plain,
                                           level_order)
    from unscene3d_torch.ops.csr_conv import csr_conv3_fwd
    from unscene3d_torch.ops.k_apply import k_apply, k_apply_plain

    L = [lv.to(dev) for lv in batch.graph.levels]
    csr = {lv: level.csr.to(dev) for lv, level in
           enumerate(csr_batch.graph.levels) if level.csr is not None}
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
            k6 = None
            if lv in csr:
                k6 = ("csr_conv3", lambda: csr_conv3_fwd(x, w, csr[lv],
                                                         lvl.valid, **kw))
            order = level_order(lvl)
            name = f"conv3_fwd L{lv} {cin}->{cout}"
            res["conv3_fwd"][(lv, cin, cout, dtype)] = _compare(
                name + (" +scale/shift+res+relu" if epi
                        else " +scale/shift+relu"),
                dtype,
                lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw,
                                  order=order),
                lambda: conv3_fwd_plain(x, w, lvl.nbr_idx, lvl.valid, **kw),
                work=(nbytes(x, w, lvl.nbr_idx, lvl.valid, kw["scale"],
                             kw["shift"], kw.get("residual"))
                      + n * cout * x.element_size(),
                      2 * hits(lvl.nbr_idx) * cin * cout, dtype),
                other=k6, equal_rows=lvl.valid)
            res["conv3_fwd"][(lv, cin, cout, dtype)].update(_order_beside(
                name, dtype, lambda o: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid,
                                                 **kw, order=o),
                lvl.nbr_idx, order))
        # k2 down conv L0 -> L1 (conv1p1s2, 32 -> 32)
        x = torch.randn(L[0].num_padded, 32, generator=g).to(dev, dtype)
        w = (torch.randn(8, 32, 32, generator=g) / 32 ** 0.5).to(dev, dtype)
        res["k_apply_gemm"][("down", dtype)] = _compare(
            "k_apply_gemm down2 L0->L1 32->32", dtype,
            lambda: k_apply(x, L[1].child_idx, w, L[1].valid),
            lambda: k_apply_plain(x, L[1].child_idx, w, L[1].valid),
            work=(nbytes(x, w, L[1].child_idx, L[1].valid)
                  + L[1].num_padded * 32 * x.element_size(),
                  2 * hits(L[1].child_idx) * 32 * 32, dtype))
        # k2 transposed up conv L1 -> L0 (convtr7p2s2, 96 -> 96)
        table = L[0].up_idx
        xu = torch.randn(L[1].num_padded, 96, generator=g).to(dev, dtype)
        wu = (torch.randn(8, 96, 96, generator=g) / 96 ** 0.5).to(dev, dtype)
        res["k_apply_gemm"][("up", dtype)] = _compare(
            "k_apply_gemm up2 L1->L0 96->96", dtype,
            lambda: k_apply(xu, table, wu, L[0].valid),
            lambda: k_apply_plain(xu, table, wu, L[0].valid),
            work=(nbytes(xu, wu, table, L[0].valid)
                  + L[0].num_padded * 96 * xu.element_size(),
                  2 * hits(table) * 96 * 96, dtype))
        # the 8-child pool sums at every main-path instance: coordinates
        # (C=3, always f32) and mask features (C=128, model dtype)
        for lv in range(4):
            for c in (3, 128) if dtype == torch.float32 else (128,):
                res["k_apply_sum"][("bench", lv, c, dtype)] = _compare_pool(
                    f"L{lv}->L{lv + 1}", L[lv], L[lv + 1], c, dtype, g, dev)
        res["segment_sum"][("bench", dtype)] = _compare_segment_sum(
            "bench", batch, dtype, g, dev)
    return res


def _route_contract(dev_inst, host_inst, what):
    """The device-post route against the host route on one forward: masks
    and classes equal, scores within ROUTE_RTOL. A difference is printed
    entry by entry (a near tie in the f32 top-k or score sort would show
    here) before the phase fails."""
    same_shape = dev_inst["masks"].shape == host_inst["masks"].shape
    masks_eq = same_shape and np.array_equal(dev_inst["masks"],
                                             host_inst["masks"])
    classes_eq = np.array_equal(dev_inst["classes"], host_inst["classes"])
    scores_ok = (len(dev_inst["scores"]) == len(host_inst["scores"])
                 and np.allclose(dev_inst["scores"], host_inst["scores"],
                                 rtol=ROUTE_RTOL, atol=0))
    if masks_eq and classes_eq and scores_ok:
        err = np.max(np.abs(dev_inst["scores"] - host_inst["scores"])
                     / np.maximum(np.abs(host_inst["scores"]), 1e-30),
                     initial=0.0)
        return float(err)
    for k in range(min(len(dev_inst["scores"]), len(host_inst["scores"]))):
        row = (dev_inst["classes"][k], host_inst["classes"][k],
               dev_inst["scores"][k], host_inst["scores"][k])
        differs = (row[0] != row[1] or not np.isclose(
            row[2], row[3], rtol=ROUTE_RTOL, atol=0) or (same_shape and (
                dev_inst["masks"][:, k] != host_inst["masks"][:, k]).any()))
        if differs:
            log(f"  route mismatch {what}, instance {k}: class {row[0]} / "
                f"{row[1]}, score {row[2]!r} / {row[3]!r}")
    raise AssertionError(f"{what}: device-post route differs from the host "
                         f"route (masks {masks_eq}, classes {classes_eq}, "
                         f"scores {scores_ok})")


def phase_slice(dev):
    """The main path: seeded random weights through the inference entry
    point, bf16 for three scenes end to end, f32 for one, each served
    through the device-post route and timed by stage; the host route runs
    on the same forward and is held to the contract. The launch counts and
    the native library's calls are read around exactly these requests; one
    DBSCAN request and the warm timings come after."""
    from unscene3d_torch import native
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.eval.device_post import to_host
    from unscene3d_torch.inference import Predictor, build_mask3d, postprocess

    scenes = [make_scene(**BENCH_SCENE, seed=s) for s in range(3)]
    preds = {dt: Predictor(build_mask3d(dt, seed=0), dev, voxel_size=VOXEL)
             for dt in (torch.bfloat16, torch.float32)}
    requests = [(torch.bfloat16, 0), (torch.bfloat16, 1),
                (torch.bfloat16, 2), (torch.float32, 0)]

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    cnt = reset_counters()
    native.reset_calls()
    served = []
    for dt, i in requests:
        p = preds[dt]
        sec0 = native.seconds()
        t0 = time.perf_counter()
        batch, meta = p.collator([scenes[i]])
        t1 = time.perf_counter()
        batch = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = p.model(batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ev0.record()
        post = p.pack(out, batch)
        ev1.record()
        ev1.synchronize()
        t4 = time.perf_counter()
        host = to_host(post)
        t5 = time.perf_counter()
        inst = p.tail(host, meta)
        t6 = time.perf_counter()
        ref = postprocess(out, meta)
        t7 = time.perf_counter()
        # the timed stages are the entry point's route
        whole = p.post(out, batch, meta)
        if not all(np.array_equal(whole[k], inst[k]) for k in inst):
            raise AssertionError(f"Predictor.post differs from its stages "
                                 f"({dt}, scene {i})")
        sec = {k: v - sec0[k] for k, v in native.seconds().items()}
        for key in ("pred_logits", "pred_masks_seg", "pred_masks_vox"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"{key} not finite ({dt}, scene {i})")
        if out["pred_logits"].shape != (13, 1, 100, 3):
            raise AssertionError(f"pred_logits {out['pred_logits'].shape}")
        if inst["masks"].shape != (len(scenes[i]["xyz"]), 100):
            raise AssertionError(f"instance masks {inst['masks'].shape}")
        score_err = _route_contract(inst, ref, f"{str(dt)[6:]} scene {i}")
        split = dict(
            collate=t1 - t0, voxelize=p.collator.timings["voxelize"],
            k3_maps=sec["build_neighbor_map_padded"],
            fps=sec["furthest_point_sample"], h2d=t2 - t1, forward=t3 - t2,
            device_post_ms=ev0.elapsed_time(ev1), d2h=t5 - t4,
            d2h_bytes=nbytes(*post.values()), tail=t6 - t5,
            e2e=t6 - t0, host_route=t7 - t6, score_err=score_err)
        served.append((dt, i, batch, meta, inst, split))
        del out, ref, post, whole
    launches = {k: fn.launches for k, fn in cnt.items()}
    calls = native.calls()
    log(f"main path: {len(requests)} requests, launches {launches}, native "
        f"host library calls {calls}")
    for k, per in PER_FORWARD.items():
        if launches[k] != per * len(requests):
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} per forward x {len(requests)}")
    for k, per in NATIVE_PER_COLLATE.items():
        if calls[k] != per * len(requests):
            raise AssertionError(f"native {k}: {calls[k]} calls, expected "
                                 f"{per} per collate x {len(requests)}: a "
                                 f"numpy twin served the card path")

    for dt, i, batch, meta, inst, sp in served:
        model = preds[dt].model
        warm = cuda_ms(lambda: model(batch), reps=5, warmup=1)
        out = model(batch)
        warm_post = cuda_ms(lambda: preds[dt].pack(out, batch), reps=10,
                            warmup=2)
        del out
        ms = {k: 1e3 * v for k, v in sp.items()
              if k not in ("device_post_ms", "d2h_bytes", "score_err")}
        log(f"scene {i} {str(dt)[6:]}: voxels={meta.num_voxels[0]} "
            f"collate={ms['collate']:.1f}ms (voxelize {ms['voxelize']:.1f}, "
            f"k3 maps {ms['k3_maps']:.1f}, FPS {ms['fps']:.1f}, rest "
            f"{ms['collate'] - ms['voxelize'] - ms['k3_maps'] - ms['fps']:.1f}"
            f") h2d={ms['h2d']:.1f}ms forward(first)={ms['forward']:.1f}ms "
            f"forward(warm, median of 5)={warm:.1f}ms device post="
            f"{sp['device_post_ms']:.3f}ms (first, CUDA events; warm median "
            f"of 10 {warm_post:.3f}ms) d2h={ms['d2h']:.2f}ms "
            f"({sp['d2h_bytes']} bytes) host tail={ms['tail']:.1f}ms "
            f"e2e={ms['e2e']:.1f}ms; host route on the same forward "
            f"{ms['host_route']:.1f}ms, equal masks and classes, scores "
            f"max rel err {sp['score_err']:.2e} (rtol {ROUTE_RTOL:g}); "
            f"instances={len(inst['scores'])} non-empty="
            f"{int(inst['masks'].any(0).sum())} top score="
            f"{float(np.max(inst['scores'], initial=0)):.4f}")
    phase_dbscan(dev, preds[torch.bfloat16].model, scenes[0], served[0][4])
    return launches, preds, served


def phase_dbscan(dev, model, scene, plain_inst):
    """One bf16 request of bench scene 0 through Predictor(use_dbscan=True):
    the host route with each query split into its DBSCAN clusters
    (eps 0.95, min_points 1, conf/config_base_instance_segmentation.yaml).
    Every query with a positive voxel yields at least one cluster, so the
    instances are at least the plain route's non-empty masks."""
    from unscene3d_torch.inference import Predictor

    p = Predictor(model, dev, voxel_size=VOXEL, use_dbscan=True)
    t0 = time.perf_counter()
    out, batch, meta = p.run(scene)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    inst = p.post(out, batch, meta)
    t2 = time.perf_counter()
    plain = int(plain_inst["masks"].any(0).sum())
    log(f"DBSCAN request, scene 0 bf16: collate+h2d+forward "
        f"{1e3 * (t1 - t0):.1f}ms, post (d2h of the voxel logits, DBSCAN "
        f"split, full-resolution tail) {1e3 * (t2 - t1):.1f}ms, e2e "
        f"{1e3 * (t2 - t0):.1f}ms; instances {len(inst['scores'])} against "
        f"{plain} non-empty masks of the plain route")
    if inst["masks"].shape[0] != len(scene["xyz"]):
        raise AssertionError(f"DBSCAN masks {inst['masks'].shape}")
    if len(inst["scores"]) < plain:
        raise AssertionError(f"DBSCAN route: {len(inst['scores'])} instances "
                             f"< {plain} non-empty masks of the plain route")


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


# kernels of the port summed by body in a trace: name substring -> label
KERNEL_FAMILIES = {"gather_gemm": "gather-GEMM (kernels 1, 2 weighted, 4 dx)",
                   "csr_conv": "kernel 6 (forward and dx)",
                   "dw_": "dW (kernel 5, with its range sum)"}


def _family_shares(rows, busy, what):
    """One line: each family's device ms, share of the busy time and
    launches per traced call."""
    parts = []
    for key, label in KERNEL_FAMILIES.items():
        hit = [r for r in rows if key in r[1]]
        ms = sum(r[0] for r in hit)
        parts.append(f"{label} {ms:.2f}ms {100 * ms / busy:.1f}% "
                     f"x{sum(r[2] for r in hit)}")
    log(f"  by body, per {what}: " + "; ".join(parts))


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
        _family_shares(rows, busy, "forward")


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


def train_batch(csr_levels=()):
    """bench.py's train batch: 8 x make_scene(125k points, 12 objects, 8 m),
    voxel 0.02, with instance targets, host FPS seeds for 100 queries."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene

    t0 = time.perf_counter()
    scenes = [make_scene(**TRAIN_SCENE, seed=100 + i)
              for i in range(TRAIN_BATCH)]
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fps_queries=100,
                                   csr_levels=csr_levels)(scenes)
    log(f"train batch collate (csr_levels={csr_levels}): "
        f"{time.perf_counter() - t0:.1f}s, voxels "
        f"{meta.num_voxels} (rows per level "
        f"{[lv.num_padded for lv in batch.graph.levels]}), targets "
        f"{tuple(batch.target.labels.shape)}")
    return batch


def phase_train_kernels(dev, batch, csr_batch):
    """Kernels 4 and 5 against their twins at the train batch's shapes; at
    level 0 kernel 4's dx also against kernel 6 as dx on the same inputs,
    over the pair tables of csr_batch (the same batch collated with
    csr_levels), bitwise on valid rows in both dtypes; kernel 2's pool
    L0->L1 and kernel 3 at the train batch's level 0."""
    from unscene3d_torch.ops.conv3 import (conv3_bwd, conv3_bwd_plain,
                                           conv3_dw, conv3_dw_plain,
                                           flip_transpose, level_order)
    from unscene3d_torch.ops.csr_conv import csr_conv3_fwd

    L = [lv.to(dev) for lv in batch.graph.levels]
    csr = {lv: level.csr.to(dev) for lv, level in
           enumerate(csr_batch.graph.levels) if level.csr is not None}
    log("backward kernels vs plain twins at the train batch's shapes")
    g = torch.Generator().manual_seed(1)
    res = {"conv3_bwd": {}, "conv3_dw": {}, "k_apply_sum": {},
           "segment_sum": {}}
    for dtype in (torch.float32, torch.bfloat16):
        res["k_apply_sum"][("train", 0, 128, dtype)] = _compare_pool(
            "train L0->L1", L[0], L[1], 128, dtype, g, dev)
        res["segment_sum"][("train", dtype)] = _compare_segment_sum(
            "train", batch, dtype, g, dev)
        for lv, cin, cout in ((0, 3, 32), (0, 128, 96), (3, 384, 256)):
            lvl = L[lv]
            n = lvl.num_padded
            x = torch.randn(n, cin, generator=g).to(dev, dtype)
            w = (torch.randn(27, cin, cout, generator=g)
                 / cin ** 0.5).to(dev, dtype)
            gm = (torch.randn(n, cout, generator=g).to(dev)
                  * lvl.valid[:, None]).to(dtype)
            args = (x, gm, w, lvl.nbr_idx, lvl.valid)
            order = level_order(lvl)
            pairs = hits(lvl.nbr_idx)
            k6 = None
            if lv in csr:
                k6 = ("csr_conv3 as dx", lambda: csr_conv3_fwd(
                    gm, flip_transpose(w), csr[lv], lvl.valid))
            res["conv3_bwd"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_bwd (dx + dW) L{lv} {cin}->{cout}, dx", dtype,
                lambda: conv3_bwd(*args, order=order)[0],
                lambda: conv3_bwd_plain(*args)[0],
                work=(nbytes(x, x, gm, w, w, lvl.nbr_idx, lvl.valid),
                      4 * pairs * cin * cout, dtype),
                other=k6, equal_rows=lvl.valid)
            res["conv3_bwd"][(lv, cin, cout, dtype)].update(_order_beside(
                f"conv3_bwd L{lv} {cin}->{cout}, dx + dW", dtype,
                lambda o: conv3_bwd(*args, order=o)[0], lvl.nbr_idx, order))
            res["conv3_dw"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_dw L{lv} {cin}->{cout} (f32 out)", dtype,
                lambda: conv3_dw(x, gm, lvl.nbr_idx),
                lambda: conv3_dw_plain(x, gm, lvl.nbr_idx),
                tol=DW_TOL[dtype],
                work=(nbytes(x, gm, lvl.nbr_idx) + 27 * cin * cout * 4,
                      2 * pairs * cin * cout, dtype))
            del x, w, gm, args, k6, order
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
    cnt = reset_counters()
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
    log(f"train path: {n_steps} steps, launches {launches}, row order "
        f"launches {order_launches()}")
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
    STEP_STATS["bf16"] = (warm, peak)
    return launches, trainer, gen


def phase_train_repeat(dev, trainer, batch, label="bf16"):
    """Whole-step bitwise repeatability of training: two
    Trainer.train_step calls from the same state (params, AdamW moments and
    count, BN running stats), the same batch and a generator seeded alike;
    every gradient and every tensor of the state after the step compared
    bitwise; they must be equal, as the reference's steps are. Where they
    differ, one more pair of steps under
    torch.use_deterministic_algorithms(True, warn_only=True) first names
    the ops that have no deterministic implementation and says whether that
    setting makes the steps equal, at what cost. The kernels' own
    repeatability is asserted one by one in the kernel phases."""
    import warnings

    model, opt = trainer.model, trainer.optimizer
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    moments = ([m.clone() for m in opt.mu], [v.clone() for v in opt.nu],
               opt.count)
    step_of = type(trainer).loss_and_grads

    def one_step():
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(state[k])
            for dst, src in zip(opt.mu + opt.nu, moments[0] + moments[1]):
                dst.copy_(src)
        opt.count = moments[2]
        grads = []

        def recorded(self, b, generator=None):
            losses, gr = step_of(self, b, generator)
            grads.extend(g.clone() for g in gr)
            return losses, gr

        trainer.loss_and_grads = recorded.__get__(trainer)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch,
                               torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            del trainer.loss_and_grads
        after = {k: v.detach().clone() for k, v in model.state_dict().items()}
        return grads, after, ms

    def differing(a, b):
        names = [n for n, _ in model.named_parameters()]
        out = [f"grad {n}" for n, x, y in zip(names, a[0], b[0])
               if not torch.equal(x, y)]
        return out + [k for k in a[1] if not torch.equal(a[1][k], b[1][k])]

    first, second = one_step(), one_step()
    diff = differing(first, second)
    verdict = "bitwise EQUAL" if not diff else "DIFFERENT"
    log(f"train step repeatability ({label}, batch {TRAIN_BATCH}, same state, "
        f"batch and generator seed): {verdict}"
        f" ({len(first[0])} gradients, {len(first[1])} state tensors; "
        f"steps {first[2]:.1f} / {second[2]:.1f} ms)"
        + (f"; {len(diff)} differ, first {diff[:6]}" if diff else ""))
    result = {"equal": not diff, "differ": diff}
    if diff:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                det = one_step(), one_step()
        finally:
            torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message).split(" does not have")[0][:160]
                      for w in caught if "determinis" in str(w.message)})
        det_diff = differing(*det)
        log(f"  under use_deterministic_algorithms(warn_only): steps "
            f"{'bitwise EQUAL' if not det_diff else 'still DIFFERENT'} "
            f"({len(det_diff)} differ), {det[0][2]:.1f} / {det[1][2]:.1f} ms; "
            f"ops without a deterministic implementation: {ops}")
        result.update(ops=ops, deterministic_equal=not det_diff)
        raise AssertionError(f"two train steps from the same state differ: "
                             f"{result}")
    return result


def _timed_steps(trainer, batch, gen, n_steps, per_step, what):
    """n_steps train steps (the first a warm-up), each with finite losses;
    the launch counts read around exactly these steps must be per_step
    times n_steps. Returns (ms of each step, launches, peak device
    bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cnt = reset_counters()
    times = []
    for step in range(n_steps):
        t0 = time.perf_counter()
        losses = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        for key in ("loss_ce", "loss_mask", "loss_dice", "total"):
            if not torch.isfinite(losses[key]).all():
                raise AssertionError(f"{what} train step {step}: {key} not "
                                     "finite")
        log(f"  {what} step {step}: {times[-1]:.1f}ms total="
            f"{losses['total'].item():.4f}")
    launches = {k: fn.launches for k, fn in cnt.items()}
    log(f"{what} train path: {n_steps} steps, launches {launches}, row "
        f"order launches {order_launches()}")
    for k, per in per_step.items():
        if launches[k] != per * n_steps:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} per {what} train step x {n_steps}")
    return times, launches, torch.cuda.max_memory_allocated()


def _trace_step(trainer, batch, gen, what):
    """One more train step under torch.profiler (device tracing): busy
    time, idle share, the top kernels and the port's kernels by body."""
    from torch.profiler import ProfilerActivity

    rows, busy, window = _traced(lambda: trainer.train_step(batch, gen),
                                 [ProfilerActivity.CUDA], reps=1)
    if not rows:
        log(f"{what} train profile: no device time in the trace (not "
            "measured)")
        return
    log(f"{what} train profile (device tracing): device busy {busy:.1f}ms "
        f"of a {window:.1f}ms traced step, idle share "
        f"{1 - busy / window:.1%}; {sum(r[2] for r in rows)} device ops per "
        "step")
    for ms, name, n in rows[:12]:
        log(f"  {ms:8.2f}ms {100 * ms / busy:5.1f}%  x{n:<4d} {name[:90]}")
    _family_shares(rows, busy, f"{what} train step")


def phase_train_profile(trainer, batch, gen):
    """One more bf16 step split by part (CUDA events on the stream: forward,
    matcher, criterion, backward, AdamW + BN update), then a step under
    torch.profiler (device tracing) for the idle share and the kernels."""
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
    _trace_step(trainer, batch, gen, "bf16")

def phase_csr_kernels(dev, batch, tbatch):
    """Kernel 6 against its twin and against kernel 1 on the same inputs
    (the same function; bitwise on valid rows in both dtypes, since the two
    share the ring main loop and its tile), at the shapes the csr_levels
    paths give it: the bench scene's levels for the forward, the train
    batch's level 0 for dx (kernel 6 over gm with flip-transposed
    weights). There kernel 5, the
    csr_levels dW, is held against csr_dw (the reference's dW over the
    pairs, plain torch) and both are timed."""
    from unscene3d_torch.ops.conv3 import (conv3_dw, conv3_fwd,
                                           flip_transpose, level_order)
    from unscene3d_torch.ops.csr_conv import (csr_conv3_fwd,
                                              csr_conv3_fwd_plain, csr_dw)

    L = [lv.to(dev) for lv in batch.graph.levels]
    dw_vs_csr = {}   # dtype -> (csr_dw ms, kernel 5 ms) on the same data
    log("kernel 6 vs its twin and vs kernel 1 at the csr_levels bench "
        f"scene's shapes (rows per level {[lv.num_padded for lv in L]}, "
        f"pairs {[lv.csr.num_pairs if lv.csr else None for lv in L]})")
    g = torch.Generator().manual_seed(2)
    res = {}

    def work(x, w, lvl, cout, *epi):
        csr = lvl.csr
        return (nbytes(x, w, csr.pair_in, csr.pair_out, csr.tile_start,
                       lvl.valid, *epi)
                + x.shape[0] * cout * x.element_size(),
                2 * (csr.num_pairs + int(lvl.valid.sum().item()))
                * x.shape[1] * cout, x.dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for lv, cin, cout, epi in ((0, 128, 96, True), (0, 3, 32, False),
                                   (2, 128, 128, False)):
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
            res[(lv, cin, cout, dtype)] = _compare(
                f"csr_conv3 L{lv} {cin}->{cout}"
                + (" +scale/shift+res+relu" if epi else " +scale/shift+relu"),
                dtype,
                lambda: csr_conv3_fwd(x, w, lvl.csr, lvl.valid, **kw),
                lambda: csr_conv3_fwd_plain(x, w, lvl.csr, lvl.valid, **kw),
                work=work(x, w, lvl, cout, kw["scale"], kw["shift"],
                          kw.get("residual")),
                other=("conv3_fwd", lambda: conv3_fwd(
                    x, w, lvl.nbr_idx, lvl.valid, **kw,
                    order=level_order(lvl))),
                equal_rows=lvl.valid)
        # the backward at the train batch's level 0, 128 -> 96
        lvl = tbatch.graph.levels[0].to(dev)
        n, cin, cout = lvl.num_padded, 128, 96
        x = torch.randn(n, cin, generator=g).to(dev, dtype)
        w = (torch.randn(27, cin, cout, generator=g)
             / cin ** 0.5).to(dev, dtype)
        gm = (torch.randn(n, cout, generator=g).to(dev)
              * lvl.valid[:, None]).to(dtype)
        wf = flip_transpose(w)
        res[("dx", dtype)] = _compare(
            f"csr_conv3 as dx, train L0 {cin}->{cout}", dtype,
            lambda: csr_conv3_fwd(gm, wf, lvl.csr, lvl.valid),
            lambda: csr_conv3_fwd_plain(gm, wf, lvl.csr, lvl.valid),
            work=work(gm, wf, lvl, cin),
            other=("conv3_fwd", lambda: conv3_fwd(
                gm, wf, lvl.nbr_idx, lvl.valid, order=level_order(lvl))),
            equal_rows=lvl.valid)
        dw, dw5 = csr_dw(x, gm, lvl.csr), conv3_dw(x, gm, lvl.nbr_idx)
        err = (dw - dw5).abs().max().item() / dw5.abs().max().item()
        dw_ms = cuda_ms(lambda: csr_dw(x, gm, lvl.csr), reps=5)
        k5_ms = cuda_ms(lambda: conv3_dw(x, gm, lvl.nbr_idx), reps=5)
        log(f"  csr_dw (plain torch) train L0 {cin}->{cout} "
            f"{str(dtype)[6:]:8s} vs conv3_dw (kernel 5): max_rel_err="
            f"{err:.3e} (tol {DW_TOL[dtype]:g}) csr_dw_ms={dw_ms:.3f} "
            f"conv3_dw_ms={k5_ms:.3f}")
        if not err <= DW_TOL[dtype]:
            raise AssertionError(f"csr_dw vs conv3_dw {dtype}: {err}")
        dw_vs_csr[dtype] = (dw_ms, k5_ms)
        del x, w, gm, wf, dw, dw5, lvl
        torch.cuda.empty_cache()
    return res, dw_vs_csr


def dense_tflops(nb, cin, cout, ms):
    """The dense brick conv's work (every window row of every brick, 27
    offsets) over ms, as achieved TFLOP/s."""
    flops = 2 * nb * 784 * 27 * cin * cout
    return f"{flops / 1e12:.3f} TFLOP dense, {flops / ms / 1e9:.1f} TFLOP/s"


def phase_brick(dev, batch):
    """Kernel 7 at the bench scene's level-0 brick graph: against its twin
    with the whole epilogue; disassemble(brick_conv3(assemble(x))) against
    kernel 1 (the same function); then the engine's own path, a two-conv
    chain with halo_exchange between, against two launches of kernel 1. The
    launch count is read around exactly that chain. The library call is one
    dense conv3d over the halo'd 10^3 bricks (the products only: no
    epilogue, no occupancy mask)."""
    from unscene3d_torch.ops import brick_engine as be
    from unscene3d_torch.ops.conv3 import conv3_fwd, level_order

    lvl = batch.graph.levels[0]
    t0 = time.perf_counter()
    bg = be.build_brick_graph(lvl.coords.numpy(), lvl.valid.numpy()).to(dev)
    lvl = lvl.to(dev)
    occ = bg.occ
    win = slice(be.WIN_LO, be.WIN_LO + be.WIN_N)
    pairs = sum(int((occ[:, win] & occ[:, be.WIN_LO + d:be.WIN_LO + d
                                       + be.WIN_N]).sum().item())
                for d in be.K3_DELTAS)
    # the bytes on the basis of the FLOPs: the whole output and asm_idx, g
    # at the occupied cells an occupied window cell reads, the residual at
    # the occupied window cells
    g_rows = int((be.window_reach(occ) & occ).sum().item())
    res_rows = int(occ[:, win].sum().item())
    tiles = occ[:, win].reshape(bg.nb_pad, -1, 112).any(-1)
    strips = occ[:, win].reshape(bg.nb_pad, -1, 16).any(-1)
    log(f"kernel 7 at the bench scene's L0 brick graph: {bg.nb_pad} bricks "
        f"(built in {time.perf_counter() - t0:.2f}s), "
        f"{occ.float().mean().item():.1%} of the cells occupied, {pairs} "
        f"occupied (cell, neighbour) pairs; {1 - tiles.float().mean().item():.1%}"
        f" of the 112-row tiles and {1 - strips.float().mean().item():.1%} of "
        "the 16-row strips hold no occupied cell (kernel 7 skips them)")
    g = torch.Generator().manual_seed(3)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for c in (32, 96):
            x = (torch.randn(lvl.num_padded, c, generator=g).to(dev)
                 * lvl.valid[:, None]).to(dtype)
            w = (torch.randn(27, c, c, generator=g) / c ** 0.5).to(dev, dtype)
            gb = be.assemble(x, bg)
            kw = dict(scale=torch.rand(c, generator=g).add(0.5).to(dev),
                      offset=torch.randn(c, generator=g).to(dev),
                      residual=be.assemble(
                          (torch.randn(lvl.num_padded, c, generator=g).to(dev)
                           * lvl.valid[:, None]).to(dtype), bg), relu=True)
            dense = gb[:, :1000].view(bg.nb_pad, 10, 10, 10, c).permute(
                0, 4, 1, 2, 3)       # NCDHW view of channels-last bricks
            w5 = w.view(3, 3, 3, c, c).permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            res[(c, dtype)] = _compare(
                f"brick_conv3 L0 {c}->{c} +scale/offset+res+relu", dtype,
                lambda: be.brick_conv3(gb, w, bg, **kw),
                lambda: be.brick_conv3_plain(gb, w, bg, kw["scale"],
                                             kw["offset"], kw["residual"],
                                             True),
                work=(nbytes(w, bg.asm_idx, kw["scale"], kw["offset"], gb)
                      + (g_rows + res_rows) * c * gb.element_size(),
                      2 * pairs * c * c, dtype),
                library=lambda: torch.nn.functional.conv3d(dense, w5))
            log(f"    {dense_tflops(bg.nb_pad, c, c, res[(c, dtype)]['ms'])}, "
                f"the same dense work through conv3d "
                f"{dense_tflops(bg.nb_pad, c, c, res[(c, dtype)]['library_ms'])}")
            flat = be.disassemble(be.brick_conv3(gb, w, bg), bg, lvl)
            ref = conv3_fwd(x, w, lvl.nbr_idx, lvl.valid,
                            order=level_order(lvl))
            err = (flat.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            eng_ms = cuda_ms(lambda: be.disassemble(
                be.brick_conv3(be.assemble(x, bg), w, bg), bg, lvl), reps=5)
            k1_ms = cuda_ms(lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid,
                                              order=level_order(lvl)),
                            reps=5)
            log(f"  disassemble(brick_conv3(assemble(x))) {c}->{c} "
                f"{str(dtype)[6:]:8s} vs conv3_fwd: max_rel_err="
                f"{err / scale:.3e} (tol {KERNEL_TOL[dtype]:g}) "
                f"engine_ms={eng_ms:.3f} conv3_fwd_ms={k1_ms:.3f}")
            if not err <= KERNEL_TOL[dtype] * scale:
                raise AssertionError(f"brick engine vs kernel 1 {c} {dtype}: "
                                     f"{err} > {KERNEL_TOL[dtype]} * {scale}")
            del gb, kw, dense, flat, ref
            torch.cuda.empty_cache()

    # the engine's path: conv, halo exchange, conv (bf16 and f32, 32 wide)
    cnt = reset_counters()
    chains = []
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(lvl.num_padded, 32, generator=g).to(dev)
             * lvl.valid[:, None]).to(dtype)
        w1, w2 = ((torch.randn(27, 32, 32, generator=g) / 32 ** 0.5).to(
            dev, dtype) for _ in range(2))
        t0 = time.perf_counter()
        g1 = be.halo_exchange(be.brick_conv3(be.assemble(x, bg), w1, bg), bg)
        y2 = be.disassemble(be.brick_conv3(g1, w2, bg), bg, lvl)
        torch.cuda.synchronize()
        chains.append((dtype, x, w1, w2, y2, 1e3 * (time.perf_counter() - t0)))
    launches = {k: fn.launches for k, fn in cnt.items()}
    log(f"brick path: 2 chains of 2 convs, launches {launches}")
    if launches["brick_conv3"] != 4 or any(
            v for k, v in launches.items() if k != "brick_conv3"):
        raise AssertionError(f"brick path launches {launches}")
    for dtype, x, w1, w2, y2, ms in chains:
        order = level_order(lvl)
        ref = conv3_fwd(conv3_fwd(x, w1, lvl.nbr_idx, lvl.valid, order=order),
                        w2, lvl.nbr_idx, lvl.valid, order=order)
        if not torch.isfinite(y2).all() or y2.shape != ref.shape:
            raise AssertionError(f"brick chain {dtype}: bad output")
        err = (y2.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        # two convs: the second reads the first one's rounded output
        tol = 2 * KERNEL_TOL[dtype]
        log(f"  chain conv-halo-conv 32->32->32 {str(dtype)[6:]:8s} vs two "
            f"conv3_fwd: max_rel_err={err / scale:.3e} (tol {tol:g}) "
            f"first run {ms:.1f}ms")
        if not err <= tol * scale:
            raise AssertionError(f"brick chain {dtype}: {err} > {tol} * "
                                 f"{scale}")
    return res, launches


def phase_slice_csr(dev, scene, preds):
    """The eval path with csr_levels=(0, 1, 2): the bench scene through
    Predictor(build_mask3d(bf16), csr_levels=...), launch counts read around
    exactly this request; then the warm forward beside the default
    configuration's on the same scene, and the f32 forward with csr_levels
    against the f32 forward of the default configuration on the parity
    scene (same weights, both on the card). The request is served through
    the device-post route, its collate through the native library."""
    from unscene3d_torch import native
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.inference import Predictor, build_mask3d

    p = Predictor(build_mask3d(torch.bfloat16, seed=0), dev, voxel_size=VOXEL,
                  csr_levels=CSR_LEVELS)
    cnt = reset_counters()
    native.reset_calls()
    t0 = time.perf_counter()
    batch, meta = p.collator([scene])
    t1 = time.perf_counter()
    batch = batch.to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = p.model(batch)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    inst = p.post(out, batch, meta)
    t4 = time.perf_counter()
    launches = {k: fn.launches for k, fn in cnt.items()}
    calls = native.calls()
    log(f"csr_levels={CSR_LEVELS} eval path: 1 request, launches {launches}"
        f", native host library calls {calls}")
    for k, per in NATIVE_PER_COLLATE.items():
        if calls[k] != per:
            raise AssertionError(f"csr_levels collate: native {k} called "
                                 f"{calls[k]} times, expected {per}")
    for k, per in PER_FORWARD_CSR.items():
        if launches[k] != per:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} per csr_levels forward")
    for key in ("pred_logits", "pred_masks_seg", "pred_masks_vox"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"csr_levels {key} not finite")
    if (out["pred_logits"].shape != (13, 1, 100, 3)
            or inst["masks"].shape != (len(scene["xyz"]), 100)):
        raise AssertionError("csr_levels eval path: bad output shapes")
    warm = cuda_ms(lambda: p.model(batch), reps=5, warmup=1)
    base_batch = preds[torch.bfloat16].collator([scene])[0].to(dev)
    base = cuda_ms(lambda: preds[torch.bfloat16].model(base_batch), reps=5,
                   warmup=1)
    warm2 = cuda_ms(lambda: p.model(batch), reps=5, warmup=1)
    log(f"scene 0 bf16 csr_levels={CSR_LEVELS}: voxels={meta.num_voxels[0]} "
        f"collate={1e3 * (t1 - t0):.0f}ms h2d={1e3 * (t2 - t1):.0f}ms "
        f"forward(first)={1e3 * (t3 - t2):.1f}ms forward(warm, median of 5)="
        f"{warm:.1f}ms, again {warm2:.1f}ms; default configuration between "
        f"them {base:.1f}ms; post={1e3 * (t4 - t3):.0f}ms "
        f"e2e={1e3 * (t4 - t0):.0f}ms instances={len(inst['scores'])}")
    del p, batch, base_batch, out

    small = make_scene(num_points=30_000, num_objects=6, extent=4.0, seed=7)
    model32 = preds[torch.float32].model
    ref = model32(preds[torch.float32].collator([small])[0].to(dev))
    got = Predictor(model32, dev, voxel_size=VOXEL,
                    csr_levels=CSR_LEVELS).run(small)[0]
    for key in ("pred_logits", "pred_masks_seg", "pred_masks_vox"):
        a, b = got[key].float(), ref[key].float()
        if key == "pred_masks_vox":   # level 0 is padded to other row counts
            n = min(a.shape[0], b.shape[0])
            a, b = a[:n], b[:n]
        err = (a - b).abs().max().item()
        scale = max(b.abs().max().item(), 1e-6)
        log(f"  csr_levels vs default, f32, parity scene {key}: "
            f"max_rel_err={err / scale:.3e} (tol {SLICE_TOL:g})")
        if not err <= SLICE_TOL * scale:
            raise AssertionError(f"csr_levels vs default {key}: {err} > "
                                 f"{SLICE_TOL} * {scale}")
    return launches


def phase_train_csr(dev, batch):
    """The train path with csr_levels=(0, 1, 2): build_trainer(bf16) on the
    8-scene batch collated with those levels, one warm-up step and
    CSR_TRAIN_STEPS timed ones, launch counts read around exactly these
    steps; its bitwise repeatability (phase_train_repeat); then one more
    step with CUDA events around every dW of the CSR levels (kernel 5) for
    its share of the step, and one traced step for the device time by
    kernel."""
    from unscene3d_torch.ops import conv_ops
    from unscene3d_torch.train.loop import build_trainer

    trainer = build_trainer(torch.bfloat16, seed=0, device=dev)
    before = [p.detach().clone() for p in trainer.params]
    gen = torch.Generator(device=dev).manual_seed(0)
    n_steps = 1 + CSR_TRAIN_STEPS
    times, launches, peak = _timed_steps(trainer, batch, gen, n_steps,
                                         PER_TRAIN_STEP_CSR, "csr_levels")
    unchanged = [n for a, (n, p) in zip(before,
                                        trainer.model.named_parameters())
                 if torch.equal(a, p)]
    if unchanged != ["backbone.final.bias"]:
        raise AssertionError(f"csr_levels: params unchanged after {n_steps} "
                             f"steps: {unchanged}")
    phase_train_repeat(dev, trainer, batch, f"bf16, csr_levels={CSR_LEVELS}")
    events = []
    plain_dw = conv_ops.conv3_dw

    def timed_dw(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = plain_dw(*args)
        end.record()
        events.append((start, end))
        return out

    conv_ops.conv3_dw = timed_dw
    try:
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        conv_ops.conv3_dw = plain_dw
    if len(events) != PER_FORWARD_CSR["csr_conv3"]:
        raise AssertionError(f"{len(events)} dW of the CSR levels in a step, "
                             f"expected {PER_FORWARD_CSR['csr_conv3']}")
    dw_ms = sum(a.elapsed_time(b) for a, b in events)
    warm = statistics.median(times[1:])
    log(f"train bf16, batch {TRAIN_BATCH}, csr_levels={CSR_LEVELS}: first "
        f"step {times[0]:.1f}ms, warm median of {CSR_TRAIN_STEPS} "
        f"{warm:.1f}ms (min {min(times[1:]):.1f}, max {max(times[1:]):.1f}) "
        f"= {1e3 * TRAIN_BATCH / warm:.2f} scenes/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; dW of the CSR levels (kernel 5) "
        f"{len(events)} calls, {dw_ms:.1f}ms of a {step_ms:.1f}ms step "
        f"({dw_ms / step_ms:.1%})")
    _trace_step(trainer, batch, gen, "csr_levels")
    return launches


def phase_train_f32(dev, batch):
    """The train path in build_trainer's default dtype, f32 (kernels 1, 2,
    4 and 5 in f32; the FMA tile of the ring main loop): the batch-8 train
    batch, one warm-up step and F32_TRAIN_STEPS timed ones, launch counts
    read around exactly these steps; two steps from one state bitwise equal
    (phase_train_repeat); one traced step for the device time by kernel
    body."""
    from unscene3d_torch.train.loop import build_trainer

    t_phase = time.perf_counter()
    trainer = build_trainer(torch.float32, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    times, launches, peak = _timed_steps(trainer, batch, gen,
                                         1 + F32_TRAIN_STEPS, PER_TRAIN_STEP,
                                         "f32")
    warm = statistics.median(times[1:])
    log(f"train f32, batch {TRAIN_BATCH}: first step {times[0]:.1f}ms, warm "
        f"median of {F32_TRAIN_STEPS} {warm:.1f}ms (min {min(times[1:]):.1f},"
        f" max {max(times[1:]):.1f}) = {1e3 * TRAIN_BATCH / warm:.2f} "
        f"scenes/s; peak device memory {peak / 2**30:.2f} GiB")
    phase_train_repeat(dev, trainer, batch, "f32")
    _trace_step(trainer, batch, gen, "f32")
    STEP_STATS["f32"] = (warm, peak)
    log(f"phase train_f32: {time.perf_counter() - t_phase:.1f}s")
    return launches, warm


def phase_proto(dev):
    """The two prototype entry points at full size (the bench scene's level
    0), their launch counts read around exactly those two calls; then each
    variant of kernel 9 and kernel 8 against its twin with its bound, `full`
    bitwise kernel 1 (no epilogue, timed beside it) on the valid rows
    without a spilled pair and, plus the spilled pairs' products, within
    tolerance of it on every valid row, kernel 8 against kernel 7 without an
    epilogue on the occupied cells, and cuDNN's conv3d on the same bricks as
    kernel 8's library call."""
    from unscene3d_torch.bench import proto_brick, proto_win_decompose
    from unscene3d_torch.ops import brick_engine as be
    from unscene3d_torch.ops.conv3 import conv3_fwd, row_order
    from unscene3d_torch.ops.proto_brick import (proto_brick_conv,
                                                 proto_brick_conv_plain)
    from unscene3d_torch.ops.win_decompose import (VARIANTS, spill_products,
                                                   win_conv_variant,
                                                   win_conv_variant_plain)

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    wcase = proto_win_decompose.build_case(dev)
    bcase = proto_brick.build_case(dev, log=log)
    log(f"prototype cases built in {time.perf_counter() - t0:.1f}s")
    cnt = reset_counters()
    split = proto_win_decompose.run(dev, case=wcase, harness=True, log=log)
    brick = proto_brick.run(dev, case=bcase, log=log)
    launches = {k: fn.launches for k, fn in cnt.items()}
    log(f"prototype paths: launches {launches}")
    want = {"win_decompose": len(VARIANTS) * 12, "brick_conv_proto": 9,
            "conv3_fwd": 12 + 9}
    for k, n in launches.items():
        if n != want.get(k, 0):
            raise AssertionError(f"prototype paths: {k} launched {n} times, "
                                 f"expected {want.get(k, 0)}")
    ms = split["ms"]
    log(f"kernel 9 split of kernel 1's ring body at L0 ({split['rows']} "
        f"rows, 128->128 bf16, {split['spilled_pairs']} spilled pairs, spin-"
        f"timed): full {ms['full']:.3f}ms (kernel 1 {ms['conv3_fwd']:.3f}, "
        f"ratio {ms['full'] / ms['conv3_fwd']:.3f}) = centre "
        f"{ms['dma_only']:.3f} + rows and products; without the products "
        f"(no_gemm) {ms['no_gemm']:.3f}, with contiguous rows (no_select) "
        f"{ms['no_select']:.3f}, with one table column (no_onehot) "
        f"{ms['no_onehot']:.3f}")

    res = {"win_decompose": {}, "brick_conv_proto": {}}
    x, w, tb, wg = wcase.x, wcase.w, wcase.tables, wcase.graph
    n_pad, cin = x.shape
    cout = w.shape[-1]
    in_window = (tb.lidx >= 0) & (tb.lidx < tb.w_sub)
    hit, hit0 = int(in_window.sum().item()), int(in_window[:, 0].sum().item())
    out_b = n_pad * cout * 2
    centre = 2 * n_pad * cin * cout
    work = {   # bytes each variant's definition reads and writes; its FLOPs
        "full": (nbytes(x, w, tb.r0, tb.starts, tb.lidx) + out_b,
                 centre + 2 * hit * cin * cout),
        "no_onehot": (nbytes(x, w, tb.r0, tb.starts) + 2 * n_pad + out_b,
                      centre + 2 * 26 * hit0 * cin * cout),
        "no_select": (nbytes(x, w, tb.r0, tb.starts) + out_b, 27 * centre),
        "no_gemm": (nbytes(x, tb.r0, tb.starts, tb.lidx) + cin * cout * 2
                    + out_b, {bf16: centre, torch.float32: hit * cout}),
        "dma_only": (nbytes(x) + cin * cout * 2 + out_b, centre),
    }
    # kernel 1's rows: valid, and in no spilled pair (the pairs `full` lacks)
    spilled = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    spilled[torch.from_numpy(wg.spill_out[wg.spill_rows >= 0]).to(
        dev).long()] = True
    k1_rows = wcase.valid & ~spilled
    k1_order = row_order(wcase.nbr_idx)
    for v in VARIANTS:
        vs_k1 = {} if v != "full" else dict(
            other=("conv3_fwd",
                   lambda: conv3_fwd(x, w, wcase.nbr_idx, wcase.valid,
                                     order=k1_order)),
            equal_rows=k1_rows, other_rows=k1_rows)
        res["win_decompose"][v] = _compare(
            f"win_decompose {v} L0 {cin}->{cout}", bf16,
            lambda: win_conv_variant(x, w, tb, v),
            lambda: win_conv_variant_plain(x, w, tb, v),
            work=(*work[v], bf16), **vs_k1)
    full = win_conv_variant(x, w, tb, "full").float()
    k1 = conv3_fwd(x, w, wcase.nbr_idx, wcase.valid, order=k1_order).float()
    total = full + spill_products(x, w, wg)
    scale = k1.abs().max().item()
    err = (total - k1)[wcase.valid].abs().max().item()
    gap = (full - k1)[wcase.valid].abs().max().item()
    log(f"  full + the {wg.num_spills} spilled pairs' products vs conv3_fwd "
        f"(valid rows): max_rel_err={err / scale:.3e} (tol "
        f"{KERNEL_TOL[bf16]:g}); without them {gap / scale:.3e}")
    if not err <= KERNEL_TOL[bf16] * scale:
        raise AssertionError(f"full + spills vs kernel 1: {err} > "
                             f"{KERNEL_TOL[bf16]} * {scale}")
    del wcase, x, w, tb, full, k1, total, in_window, spilled, k1_rows
    torch.cuda.empty_cache()

    g, w = bcase.g, bcase.w
    nb, _, c = g.shape
    n = bcase.xpad.shape[0] - 1
    bg = be.BrickGraph(asm_idx=bcase.asm,
                       out_idx=torch.zeros(0, dtype=torch.int32, device=dev),
                       nbr=torch.zeros(0, dtype=torch.int32, device=dev),
                       n_pad=n + 1)
    occ = bg.occ
    pairs = sum(int(occ[:, be.WIN_LO + d:be.WIN_LO + d + be.WIN_N].sum()
                    .item()) for d in be.K3_DELTAS)
    dense = g[:, :1000].view(nb, 10, 10, 10, c).permute(0, 4, 1, 2, 3)
    w5 = w.view(3, 3, 3, c, c).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    res["brick_conv_proto"][(c, bf16)] = _compare(
        f"brick_conv_proto L0 {c}->{c}, {nb} bricks", bf16,
        lambda: proto_brick_conv(g, w),
        lambda: proto_brick_conv_plain(g, w),
        work=(2 * nbytes(g) + nbytes(w), 2 * pairs * c * c, bf16),
        library=lambda: torch.nn.functional.conv3d(dense, w5))
    m = res["brick_conv_proto"][(c, bf16)]
    log(f"    {dense_tflops(nb, c, c, m['ms'])}, conv3d "
        f"{dense_tflops(nb, c, c, m['library_ms'])}")
    k8 = proto_brick_conv(g, w)
    k7 = be.brick_conv3(g, w, bg)
    masked = k8 * occ[..., None].to(k8.dtype)
    err = (masked.float() - k7.float()).abs().max().item()
    scale = k7.float().abs().max().item()
    empty = (k8.float().abs().amax(-1) > 0)[~occ].float().mean().item()
    log(f"  brick_conv_proto vs brick_conv3 (no epilogue) on the occupied "
        f"cells: max_rel_err={err / scale:.3e}, bitwise equal "
        f"{torch.equal(masked, k7)}; {empty:.1%} of the empty cells hold a "
        f"nonzero sum (no occupancy mask); vs conv3_fwd at the real voxels "
        f"max_rel_err={brick['max_rel_err']:.3e}")
    if not err <= KERNEL_TOL[bf16] * scale:
        raise AssertionError(f"kernel 8 vs kernel 7: {err}")
    del bcase, g, w, k8, k7, masked, dense, occ, bg
    torch.cuda.empty_cache()
    return res, launches


def _segment_scenes(n):
    from unscene3d_torch.data.synthetic import make_segment_scene

    return [make_segment_scene(seed=i, num_segments=400) for i in range(n)]


def _same_masks(a, b):
    return [x.shape == y.shape and bool((x == y).all()) for x, y in zip(a, b)]


def phase_pseudo_row(dev):
    """bench.py's pseudo row through BatchedNCut on the card: cholinv (one
    warm run, median of 3), eigh on fewer scenes, the host loop once;
    finite eigenvectors, at least one mask per scene, two runs bitwise
    equal, scene 0 alone against scene 0 in the batch, the idle share of one
    traced run. The row's features are normal random numbers, whose
    tau-graph is the identity, so its masks say nothing of the solvers: the
    solver agreement (matched IoU, planted-object recovery) is read on
    `make_segment_scene` scenes."""
    import dataclasses

    from torch.profiler import ProfilerActivity
    from unscene3d_torch.bench.pseudo import (bench_pseudo,
                                              make_pseudo_scenes, matched_iou,
                                              object_recovery)
    from unscene3d_torch.pseudo.ncut import (BatchedNCut, NCutConfig,
                                             ncut_eigenvectors)

    scenes = make_pseudo_scenes(**PSEUDO_ROW)
    B = len(scenes)
    torch.cuda.reset_peak_memory_stats()
    row = bench_pseudo(dev, scenes=scenes, runs=3, log=log)
    peak = torch.cuda.max_memory_allocated()
    masks = row["masks"]
    if not all(m.dtype == bool and m.shape[1] == 400 and len(m) >= 1
               for m in masks):
        raise AssertionError("pseudo row: a scene without a mask, or a bad "
                             f"shape: {[m.shape for m in masks]}")
    fa = torch.from_numpy(np.stack([s["features"] for s in scenes])).to(dev)
    zeros = torch.zeros(B, 400, device=dev)
    vec = ncut_eigenvectors(fa, fa, zeros, zeros.bool(), multimodal=False)
    if not torch.isfinite(vec).all():
        raise AssertionError("pseudo row: eigenvectors not finite")
    runner = BatchedNCut(NCutConfig(), dev)
    again = runner.run(scenes)
    if not all(_same_masks(masks, again)):
        raise AssertionError("pseudo row: two runs of the batch differ")
    alone = runner.run(scenes[:1])[0]
    same = _same_masks([alone], masks[:1])[0]
    log(f"pseudo row cholinv: {row['ms_per_scene']:.3f}ms/scene "
        f"({1e3 / row['ms_per_scene']:.1f} scenes/s), runs "
        f"{[round(t, 1) for t in row['runs_ms']]}ms, first "
        f"{row['first_ms']:.1f}ms, peak device memory {peak / 2**30:.2f} GiB, "
        f"masks per scene {min(map(len, masks))}-{max(map(len, masks))}; two "
        f"runs bitwise equal; scene 0 alone vs in the batch of {B}: "
        + ("masks equal" if same else
           f"masks DIFFER (alone {alone.shape}, batch {masks[0].shape}, "
           f"matched IoU {matched_iou(alone, masks[0]):.3f})"))
    eigh = bench_pseudo(dev, cfg=NCutConfig(solver="eigh"),
                        scenes=scenes[:EIGH_SCENES], runs=1, log=log)
    host = bench_pseudo(dev, cfg=NCutConfig(device_loop=False), scenes=scenes,
                        runs=0, log=log)
    log(f"pseudo row eigh ({EIGH_SCENES} scenes): "
        f"{eigh['ms_per_scene']:.3f}ms/scene; host loop ({B} scenes, one "
        f"run): {host['first_ms'] / B:.3f}ms/scene; matched IoU on the row "
        f"(identity graph: no signal) cholinv vs eigh "
        f"{np.mean([matched_iou(a, b) for a, b in zip(masks, eigh['masks'])]):.3f}"
        f", device loop vs host loop "
        f"{np.mean([matched_iou(a, b) for a, b in zip(masks, host['masks'])]):.3f}")

    rows, busy, window = _traced(lambda: runner.run(scenes),
                                 [ProfilerActivity.CUDA], reps=1)
    if rows:
        log(f"pseudo row profile (device tracing): device busy {busy:.1f}ms "
            f"of a {window:.1f}ms traced run, idle share "
            f"{1 - busy / window:.1%}; {sum(r[2] for r in rows)} device ops "
            "per run")
        for ms, name, n in rows[:8]:
            log(f"  {ms:8.2f}ms {100 * ms / busy:5.1f}%  x{n:<5d} {name[:90]}")
    else:
        log("pseudo row profile: no device time in the trace (not measured)")

    # solver agreement where the graphs carry signal
    seg = _segment_scenes(EIGH_SCENES)
    out = {}
    for solver in ("cholinv", "eigh"):
        cfg = NCutConfig(affinity_tau=0.6, solver=solver)
        t0 = time.perf_counter()
        out[solver] = BatchedNCut(cfg, dev).run(seg)
        ms = 1e3 * (time.perf_counter() - t0) / len(seg)
        rec = np.mean([object_recovery(m, s["objects"])
                       for m, s in zip(out[solver], seg)])
        out[solver, "rec"] = rec
        log(f"  segment scenes ({len(seg)} x ~400, tau 0.6) {solver}: "
            f"{ms:.3f}ms/scene (first run), planted-object recovery "
            f"{rec:.3f}")
        first3 = BatchedNCut(dataclasses.replace(
            cfg, max_number_of_instances=3), dev).run(seg)
        out[solver, "first3"] = first3
    iou = np.mean([matched_iou(a, b)
                   for a, b in zip(out["cholinv"], out["eigh"])])
    iou3 = np.mean([matched_iou(a, b) for a, b in zip(
        out["cholinv", "first3"], out["eigh", "first3"])])
    log(f"  cholinv vs eigh on the segment scenes: mean matched IoU "
        f"{iou:.3f} over 20 iterations, {iou3:.3f} over the first 3; "
        f"recovery {out['cholinv', 'rec']:.3f} vs {out['eigh', 'rec']:.3f} "
        f"(tol {RECOVERY_TOL:g})")
    if not abs(out["cholinv", "rec"] - out["eigh", "rec"]) <= RECOVERY_TOL:
        raise AssertionError("cholinv vs eigh planted-object recovery")


def _pseudo_scene(seed):
    """Bench scene `seed` as the pipeline takes it: 2 cm voxels, the
    synthetic grid-cell segments with chain connectivity."""
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.ops.hashing import sparse_quantize

    raw = make_scene(**BENCH_SCENE, seed=seed)
    t0 = time.perf_counter()
    vox, umap, _ = sparse_quantize(raw["xyz"], VOXEL)
    seg = raw["segments"][umap]
    uniq = np.unique(seg)
    conn = np.column_stack([uniq[:-1], uniq[1:]])
    log(f"pseudo scene {seed}: {len(raw['xyz'])} points, {len(vox)} voxels, "
        f"{len(uniq)} segments (quantize {time.perf_counter() - t0:.2f}s)")
    return dict(scene_name=f"bench{seed}", coords=vox,
                feats=raw["features"][umap] - 0.5, segment_ids=[seg],
                segment_connectivity=[np.vstack([conn, conn[:, ::-1]])],
                full_coords=raw["xyz"])


def _scannet_intrinsics(h, w):
    """ScanNet's color intrinsics (1170.19 px focal length at 1296 wide)
    for an (h, w) frame."""
    K = np.eye(3)
    K[0, 0] = K[1, 1] = 1170.187988 * w / 1296.0
    K[0, 2], K[1, 2] = (w - 1) / 2.0, (h - 1) / 2.0
    return K


def _smoke_dir(name):
    """A fresh directory under the checkout's build/ (gitignored)."""
    import os
    import shutil

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _write_checkpoints(root):
    """Seeded random CSC (ME layout, in a `state_dict` wrapper under
    `model.`) and DINO ViT-S/8 (the DINO repository's names under
    `module.`) checkpoints, written with torch.save; their paths."""
    import os

    from unscene3d_torch.models.encoders_2d.dino import ViTExtractor
    from unscene3d_torch.models.torch_convert import random_me_state_dict

    csc = os.path.join(root, "CSC_train_Res16UNet34C_2cm.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v
                               in random_me_state_dict(prefix="model.")
                               .items()}}, csc)
    dino = os.path.join(root, "dino_deitsmall8_pretrain.pth")
    torch.save({f"module.{k}": v for k, v
                in ViTExtractor().init_random_(1).state_dict().items()}, dino)
    return csc, dino


def dino_flops(h, w):
    """Products of one key-facet ViT-S/8 forward at stride 4 on an (h, w)
    frame (the port stops after block 10's qkv): the patch matmul, 9 whole
    blocks (qkv, scores, weighted values, proj, the 4x MLP: 24 N D^2 +
    4 N^2 D) and block 10's qkv (6 N D^2); N tokens with the class token."""
    dim, blocks, patch, stride = 384, 9, 8, 4
    n = ((h - patch) // stride + 1) * ((w - patch) // stride + 1)
    tokens = n + 1
    return (2 * n * 3 * patch * patch * dim
            + blocks * (24 * tokens * dim ** 2 + 4 * tokens ** 2 * dim)
            + 6 * tokens * dim ** 2)


def phase_pseudo_both(dev, card):
    """The pseudo masks as the paper makes them, at full width: 2 bench
    scenes through PseudoMaskPipeline(modality="both") with 75 frames each
    (192 x 256, seeded images, seeded cameras ringed round the scene and
    facing its centre), DINO ViT-S/8 at stride 4 and Res16UNet34C res_2 from
    seeded random checkpoints written in their own formats and read through
    `dino_weights` / `csc_weights`, NCut with the config's values. Asserts
    kernel 1 / 2 launches of 47 / 8 per scene, a share of voxels hit by a
    frame above zero, one frame's DINO features on the card against the
    CPU, (P, K) bool masks over each full cloud and two calls bitwise
    equal; logs each stage's time."""
    from unscene3d_torch import native
    from unscene3d_torch.data.synthetic import ring_poses
    from unscene3d_torch.models.encoders_2d.dino import (DinoNet,
                                                         load_dino_weights)
    from unscene3d_torch.pseudo.ncut import NCutConfig
    from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline
    from unscene3d_torch.pseudo.projection import project_2d_features

    t_phase = time.perf_counter()
    csc, dino = _write_checkpoints(_smoke_dir("pseudo_both"))
    rng = np.random.RandomState(13)
    scenes = []
    for seed in range(PSEUDO_BOTH_SCENES):
        s = _pseudo_scene(seed)
        xyz = s["full_coords"]
        centre = (xyz.min(0) + xyz.max(0)) / 2
        s.update(images=rng.rand(PSEUDO_FRAMES, *FRAME, 3).astype(np.float32),
                 poses=ring_poses(centre, 7.0, 2.5, PSEUDO_FRAMES),
                 intrinsics=_scannet_intrinsics(*FRAME))
        scenes.append(s)
    pipe = PseudoMaskPipeline(modality="both", csc_weights=csc,
                              dino_weights=dino, ncut_cfg=NCutConfig(**FREEMASK),
                              resolution_scale=2, voxel_size=VOXEL,
                              device=dev)
    cnt = reset_counters()
    native.reset_calls()
    first = pipe.process_scenes(scenes)
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in cnt.items()}
    t_first = dict(pipe.timings)
    maps = native.calls()["build_neighbor_map_padded"]
    if maps != 5 * len(scenes):
        raise AssertionError(f"pseudo both: the native k3 map served {maps} "
                             f"levels, expected {5 * len(scenes)}")
    for k, per in PER_CSC_FORWARD.items():
        if got[k] != per * len(scenes):
            raise AssertionError(f"pseudo both: {k} launched {got[k]} times,"
                                 f" expected {per * len(scenes)}")
    share = dict(pipe.hit_share)
    if not min(share.values()) > 0:
        raise AssertionError(f"pseudo both: no voxel hit by a frame {share}")
    again = pipe.process_scenes(scenes)
    for s in scenes:
        cloud, masks = first[s["scene_name"]]
        if (masks.dtype != bool or masks.ndim != 2
                or masks.shape[0] != len(s["full_coords"])
                or cloud.shape != s["full_coords"].shape):
            raise AssertionError(f"pseudo both: masks {masks.dtype} "
                                 f"{masks.shape}")
        if not np.array_equal(masks, again[s["scene_name"]][1]):
            raise AssertionError("pseudo both: two calls differ")

    frame = scenes[0]["images"][:1]
    card_feats = pipe.dino(frame)
    ms = cuda_ms(lambda: pipe.dino(frame), reps=5)
    t0 = time.perf_counter()
    cpu_feats = DinoNet(state_dict=load_dino_weights(dino), device="cpu")(
        frame)
    t_cpu = time.perf_counter() - t0
    scale = cpu_feats.abs().max().item()
    err = (card_feats.cpu() - cpu_feats).abs().max().item()
    bound = 1e3 * dino_flops(*FRAME) / PEAK_FLOPS[torch.float32]
    n_frames = PSEUDO_FRAMES * len(scenes)
    t = pipe.timings
    stages = ", ".join(f"{k} {1e3 * v:.0f}ms (first call "
                       f"{1e3 * t_first.get(k, 0.0):.0f})"
                       for k, v in t.items())
    log(f"pseudo both ({len(scenes)} scenes x {PSEUDO_FRAMES} frames of "
        f"{FRAME[0]}x{FRAME[1]}, {card}): voxels hit by a frame "
        f"{', '.join(f'{v:.3f}' for v in share.values())}; masks "
        f"{[first[s['scene_name']][1].shape for s in scenes]}; two calls "
        f"equal; launches {dict((k, v) for k, v in got.items() if v)}")
    log(f"  per frame: dino {1e3 * t['dino'] / n_frames:.3f} ms (host clock; "
        f"one call {ms:.3f} ms CUDA events, f32 bound {bound:.3f} ms = "
        f"{dino_flops(*FRAME) / 1e9:.1f} GFLOP / 67 TFLOP/s, "
        f"{bound / ms:.1%} of it), project "
        f"{1e3 * t['project'] / n_frames:.3f} ms; per call: {stages}")
    log(f"  DINO card vs CPU (one frame, ViT-S/8 + upsample): max_rel_err "
        f"{err / scale:.3e} (tol {DINO_TOL:g}); the CPU took {t_cpu:.1f}s")
    from torch.profiler import ProfilerActivity

    rows, busy, window = _traced(lambda: pipe.dino(frame),
                                 [ProfilerActivity.CUDA], reps=2)
    if rows:
        log(f"  DINO profile (one frame): device busy {busy:.2f}ms of "
            f"{window:.2f}ms, idle share {1 - busy / window:.1%}")
        for r_ms, name, n in rows[:8]:
            log(f"  {r_ms:8.3f}ms {100 * r_ms / busy:5.1f}%  x{n:<4d} "
                f"{name[:90]}")
    else:
        log("  DINO profile: no device time in the trace (not measured)")
    s0 = scenes[0]
    world = torch.from_numpy((s0["coords"].astype(np.float32) + 0.5)
                             * VOXEL).to(dev)
    valid = torch.ones(len(world), dtype=torch.bool, device=dev)
    pose = torch.from_numpy(s0["poses"][:1].astype(np.float32)).to(dev)
    K = torch.from_numpy(s0["intrinsics"].astype(np.float32)).to(dev)
    rows, busy, window = _traced(lambda: project_2d_features(
        card_feats, world, valid, pose, K, *FRAME), [ProfilerActivity.CUDA],
        reps=2)
    if rows:
        log(f"  projection profile (one frame, {len(world)} voxels): device "
            f"busy {busy:.3f}ms of {window:.3f}ms")
        for r_ms, name, n in rows[:6]:
            log(f"  {r_ms:8.3f}ms {100 * r_ms / busy:5.1f}%  x{n:<4d} "
                f"{name[:90]}")
    if not err <= DINO_TOL * scale:
        raise AssertionError(f"pseudo both: DINO card vs CPU {err} > "
                             f"{DINO_TOL} * {scale}")
    # reference_average=False: each voxel's mean over the frames that hit
    # it, on one scene
    mean_pipe = PseudoMaskPipeline(
        modality="both", csc_weights=csc, dino_weights=dino,
        ncut_cfg=NCutConfig(**FREEMASK), resolution_scale=2,
        voxel_size=VOXEL, device=dev, reference_average=False)
    s0 = scenes[0]
    cnt = reset_counters()
    t0 = time.perf_counter()
    cloud, masks = mean_pipe.process_scenes([s0])[s0["scene_name"]]
    torch.cuda.synchronize()
    t_mean = time.perf_counter() - t0
    mean_got = {k: fn.launches for k, fn in cnt.items()}
    if (masks.dtype != bool or masks.shape[0] != len(s0["full_coords"])
            or mean_pipe.hit_share != {s0["scene_name"]:
                                       share[s0["scene_name"]]}
            or any(mean_got[k] != v for k, v in PER_CSC_FORWARD.items())):
        raise AssertionError(f"pseudo both, reference_average=False: masks "
                             f"{masks.dtype} {masks.shape}, hit share "
                             f"{mean_pipe.hit_share}, launches {mean_got}")
    log(f"  reference_average=False (mean over each voxel's hit frames), "
        f"scene {s0['scene_name']}: {t_mean:.1f}s, masks {masks.shape}, "
        f"voxels hit {mean_pipe.hit_share[s0['scene_name']]:.3f} (as the "
        f"pairwise mean's), stages "
        + ", ".join(f"{k} {1e3 * v:.0f}ms"
                    for k, v in mean_pipe.timings.items()))
    for k in got:
        got[k] += mean_got[k]
    del mean_pipe
    log(f"phase pseudo_both: {time.perf_counter() - t_phase:.1f}s")
    del pipe
    torch.cuda.empty_cache()
    return got


def phase_pseudo_main(dev):
    """`python -m unscene3d_torch.pseudo_masks_main` on the card, run as
    runpy runs it, on a ScanNet-layout directory written here: 2 meshes
    (scannet200_insseg `.pth` tuples, `_vh_clean_2.ply` with faces,
    `axisAlignment` meta files, `train.txt`), JPEG frames with poses and
    intrinsics, and the seeded random checkpoints, with the overrides of
    scripts/unsupervised/pseudo_dino_2d3d.sh (`freemask.modality=both`; the
    card's machine has PIL). Asserts that the native segment_mesh served
    every scene, the CSC forward's launches and both npys per scene."""
    import os
    import runpy

    from unscene3d_torch import native
    from unscene3d_torch.data.synthetic import (make_mesh_scene, ring_poses,
                                                write_scannet_scene)

    t_phase = time.perf_counter()
    root = _smoke_dir("pseudo_main")
    ins, scans = os.path.join(root, "insseg"), os.path.join(root, "scans")
    names = [f"scene{i:04d}_00" for i in range(2)]
    verts = {}
    for i, name in enumerate(names):
        mesh = make_mesh_scene(**MAIN_MESH, seed=i)
        align = np.eye(4)
        align[:3, 3] = [-4.0, -4.0, 0.0]
        centre = (mesh["vertices"].min(0) + mesh["vertices"].max(0)) / 2
        write_scannet_scene(ins, scans, name, mesh, alignment=align,
                            poses=ring_poses(centre, 7.0, 2.5, MAIN_FRAMES),
                            seed=i)
        verts[name] = len(mesh["vertices"])
    with open(os.path.join(ins, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    csc, dino = _write_checkpoints(root)
    save = os.path.join(root, "out")
    argv = ["pseudo_masks_main", "freemask.modality=both",
            "freemask.affinity_tau=0.6", "data.segments_min_vert_nums=[50]",
            f"data.scannet_path={ins}", f"data.scannet_images_path={scans}",
            f"net.weights_for_inner_model={csc}",
            f"image_data.model_checkpoint={dino}", f"misc.save_dir={save}"]
    t_write = time.perf_counter() - t_phase
    cnt = reset_counters()
    native.reset_calls()
    old_argv = sys.argv
    sys.argv = argv
    t0 = time.perf_counter()
    try:
        runpy.run_module("unscene3d_torch.pseudo_masks_main",
                         run_name="__main__", alter_sys=True)
    finally:
        sys.argv = old_argv
    t_run = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in cnt.items()}
    calls = native.calls()["segment_mesh"]
    if calls != len(names):
        raise AssertionError(f"pseudo main: segment_mesh served {calls} "
                             f"scenes of {len(names)}")
    for k, per in PER_CSC_FORWARD.items():
        if got[k] != per * len(names):
            raise AssertionError(f"pseudo main: {k} launched {got[k]} times,"
                                 f" expected {per * len(names)}")
    shapes = []
    for name in names:
        cloud = np.load(os.path.join(save, f"{name}_cloud.npy"))
        masks = np.load(os.path.join(save, f"{name}_masks.npy"))
        if (cloud.shape != (verts[name], 3) or cloud.dtype != np.float32
                or masks.dtype != bool or masks.ndim != 2
                or masks.shape[0] != verts[name]):
            raise AssertionError(f"pseudo main {name}: cloud {cloud.shape} "
                                 f"{cloud.dtype}, masks {masks.shape} "
                                 f"{masks.dtype}")
        shapes.append(masks.shape)
    log(f"pseudo main (python -m unscene3d_torch.pseudo_masks_main, "
        f"modality both, {len(names)} scenes of {verts[names[0]]} vertices, "
        f"{MAIN_FRAMES} JPEG frames each): {t_run:.1f}s (layout written in "
        f"{t_write:.1f}s); segment_mesh {calls} calls "
        f"{1e3 * native.seconds()['segment_mesh']:.0f}ms; masks {shapes}; "
        f"launches {dict((k, v) for k, v in got.items() if v)}")
    log(f"phase pseudo_main: {time.perf_counter() - t_phase:.1f}s")
    torch.cuda.empty_cache()
    return got


def phase_pseudo_pipeline(dev):
    """The bench scene through PseudoMaskPipeline(modality="geom") at full
    width (Res16UNet34C, seeded random weights, res_2 features), bf16 and
    f32: launch counts read around exactly the first call of each, masks
    (P, K) bool over the full cloud, a second call timed by stage. The CSC
    graph's k3 maps come from the native library (asserted)."""
    from unscene3d_torch import native
    from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline

    scene = _pseudo_scene(0)
    launches = {}
    for dt in (torch.bfloat16, torch.float32):
        pipe = PseudoMaskPipeline(modality="geom", device=dev, dtype=dt,
                                  resolution_scale=2, voxel_size=VOXEL)
        cnt = reset_counters()
        native.reset_calls()
        first = pipe.process_scenes([scene])
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in cnt.items()}
        maps = native.calls()["build_neighbor_map_padded"]
        if maps != NATIVE_PER_COLLATE["build_neighbor_map_padded"]:
            raise AssertionError(f"pseudo pipeline {dt}: the native k3 map "
                                 f"served {maps} levels, expected 5")
        for k, per in PER_CSC_FORWARD.items():
            if got[k] != per:
                raise AssertionError(f"pseudo pipeline {dt}: {k} launched "
                                     f"{got[k]} times, expected {per}")
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        t_first = dict(pipe.timings)
        again = pipe.process_scenes([scene])
        cloud, masks = first["bench0"]
        if (masks.dtype != bool or masks.ndim != 2
                or masks.shape[0] != len(scene["full_coords"])
                or masks.shape[1] < 1
                or cloud.shape != scene["full_coords"].shape):
            raise AssertionError(f"pseudo pipeline {dt}: masks "
                                 f"{masks.dtype} {masks.shape}")
        if not np.array_equal(masks, again["bench0"][1]):
            raise AssertionError(f"pseudo pipeline {dt}: two calls differ")
        stages = ", ".join(f"{k} {1e3 * v:.0f}ms (first call "
                           f"{1e3 * t_first[k]:.0f})"
                           for k, v in pipe.timings.items())
        log(f"pseudo pipeline {str(dt)[6:]}: masks {masks.shape}, "
            f"{int(masks.any(1).sum())} points covered; two calls equal; "
            f"launches {dict((k, v) for k, v in got.items() if v)}; {stages}")
        del pipe
        torch.cuda.empty_cache()
    return launches


def phase_pseudo_parity(dev):
    """NCut on the card against the same code on the CPU, f32, 8 segment
    scenes (connected tau-graphs): the first iteration's eigenvectors by
    |cos| for both solvers, the masks of the first three greedy iterations,
    and the matched IoU of whole runs (late iterations cut a painted-out,
    near-degenerate remainder, where a last-bit difference picks another
    vector: reported, not asserted)."""
    import dataclasses

    from unscene3d_torch.bench.pseudo import matched_iou
    from unscene3d_torch.pseudo.ncut import (BatchedNCut, NCutConfig,
                                             ncut_eigenvectors)

    seg = _segment_scenes(NCUT_PARITY_SCENES)
    B, S = len(seg), 448
    fa = np.zeros((B, S, 96), np.float32)
    invalid = np.ones((B, S), bool)
    for b, s in enumerate(seg):
        n = len(s["unique_segments"])
        fa[b, :n], invalid[b, :n] = s["features"], False
    fa, invalid = torch.from_numpy(fa), torch.from_numpy(invalid)
    paint = torch.zeros(B, S)
    for solver in ("cholinv", "eigh"):
        kw = dict(tau=0.6, multimodal=False, solver=solver)
        v_cpu = ncut_eigenvectors(fa, fa, paint, invalid, **kw)
        v_gpu = ncut_eigenvectors(fa.to(dev), fa.to(dev), paint.to(dev),
                                  invalid.to(dev), **kw).cpu()
        cos = torch.nn.functional.cosine_similarity(
            v_cpu.masked_fill(invalid, 0), v_gpu.masked_fill(invalid, 0))
        cfg = NCutConfig(affinity_tau=0.6, solver=solver)
        cfg3 = dataclasses.replace(cfg, max_number_of_instances=3)
        same3 = _same_masks(BatchedNCut(cfg3, dev).run(seg),
                            BatchedNCut(cfg3, "cpu").run(seg))
        full_gpu = BatchedNCut(cfg, dev).run(seg)
        full_cpu = BatchedNCut(cfg, "cpu").run(seg)
        ious = [matched_iou(a, b) for a, b in zip(full_gpu, full_cpu)]
        log(f"  NCut parity {solver} (f32, {B} segment scenes): first "
            f"eigenvector cos min {cos.min().item():.6f}; masks of the first "
            f"3 iterations equal in {sum(same3)} of {B} scenes; whole runs "
            f"equal in {sum(_same_masks(full_gpu, full_cpu))} of {B}, mean "
            f"matched IoU {np.mean(ious):.3f}")
        if not cos.min().item() >= 0.999:
            raise AssertionError(f"NCut parity {solver}: cos {cos}")
        if not sum(same3) >= B - 1:
            raise AssertionError(f"NCut parity {solver}: first-3 masks equal "
                                 f"in only {sum(same3)} of {B} scenes")


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


def phase_train_parity(dev, brick_levels=()):
    """One f32 train step of the same seeded trainer on the card (kernels)
    and on the CPU (twins), on a ~30k-voxel scene: losses, every gradient,
    the updated params and BN running stats; with `brick_levels`, the
    scene collated with those levels' brick tables (kernel 7 on the card).

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
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fps_queries=100,
                                   brick_levels=brick_levels)([scene])
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
    log(f"  train parity (f32, {meta.num_voxels[0]} voxels, brick_levels="
        f"{tuple(brick_levels)}, samples, block "
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


def _write_self_train_data(root):
    """SELF_TRAIN_SCENES scenes of the train batch's size in the reference's
    npy layout (tests/test_datasets.py:write_mask3d_dataset: [xyz, rgb
    0-255, normal, segment, label, instance] and `_freemasks.npy`), the same
    scenes in train_database.yaml and validation_database.yaml. Returns the
    scenes' point counts by name."""
    import os

    import yaml

    from unscene3d_torch.data.synthetic import make_scene

    os.makedirs(f"{root}/train", exist_ok=True)
    db, points = [], {}
    for i in range(SELF_TRAIN_SCENES):
        s = make_scene(**TRAIN_SCENE, seed=300 + i)
        n = len(s["xyz"])
        cols = np.hstack([
            s["xyz"], s["colors"] * 255.0, np.tile([0, 0, 1.0], (n, 1)),
            s["segments"][:, None], s["labels"][:, None],
            s["instances"][:, None]]).astype(np.float32)
        path = f"{root}/train/{i:04d}_00.npy"
        np.save(path, cols)
        np.save(path.replace(".npy", "_freemasks.npy"),
                s["masks"].astype(np.float32))
        db.append({"filepath": path,
                   "raw_filepath": f"/x/scene{i:04d}_00/mesh.ply"})
        points[f"scene{i:04d}_00"] = n
    for mode in ("train", "validation"):
        with open(f"{root}/{mode}_database.yaml", "w") as f:
            yaml.safe_dump(db, f)
    return points


def phase_self_train(dev, card, f32_step_ms):
    """The self-training round through the port's entry point,
    `unscene3d_torch.main_instance_segmentation`, at the reference config
    (Mask3D(Res16UNet34C) at conf/model/mask3d.yaml's widths, f32, batch 8,
    the default augmentations, seeded random weights) on SELF_TRAIN_SCENES
    train-batch-size scenes written in the reference's layout: round 1
    (2 epochs of one step, one validation), the export, and round 2 from
    round 1's best/ on the data set that merges the export. Times each
    stage on the host clock; asserts a bitwise checkpoint restore into a
    fresh trainer, every export found by the merge, the exported masks'
    shapes and kernels 1-5's launch counts."""
    import glob
    import os
    import tempfile

    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)
    from unscene3d_torch.train import checkpoint as ckpt
    from unscene3d_torch.train.loop import build_trainer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        points = _write_self_train_data(f"{tmp}/data")
        log(f"self-train data: {len(points)} scenes, "
            f"{sorted(points.values())} points, written in "
            f"{time.perf_counter() - t0:.1f}s")
        data = [f"general.data_dir={tmp}/data",
                f"data.datasets.validation_dataset.data_dir={tmp}/data",
                f"data.datasets.test_dataset.data_dir={tmp}/data"]
        r1 = f"{tmp}/round1"
        cnt = reset_counters()
        # scripts/unsupervised/train_unscene3d.sh's overrides
        cfg = get_parameters(SELF_TRAIN_ROUND + data + [
            f"general.save_dir={r1}", "trainer.max_epochs=2",
            "trainer.check_val_every_n_epoch=2"])
        t0 = time.perf_counter()
        exp = build_experiment(cfg)
        t_build = time.perf_counter() - t0
        if exp.device != dev or exp.model.dtype != torch.float32:
            raise AssertionError(f"self-train: {exp.device}, "
                                 f"{exp.model.dtype}")
        t0 = time.perf_counter()
        trainer = exp.fit(seed=int(cfg.general.seed),
                          resume=bool(cfg.general.resume),
                          checkpoint=cfg.general.checkpoint)
        t_fit = time.perf_counter() - t0
        fit1, eval1, res1 = (dict(exp.fit_stats), dict(exp.eval_stats),
                             exp.last_results)
        n_steps = trainer.step
        _self_train_report("round 1", exp, t_build, t_fit)

        # a checkpoint restored into a fresh trainer is the saved state
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(f"{tmp}/probe", trainer)
        torch.cuda.synchronize()
        save_ms = 1e3 * (time.perf_counter() - t0)
        nbytes_ckpt = os.path.getsize(f"{path}/state.pt")
        fresh = build_trainer(torch.float32, seed=1, device=dev)
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(f"{tmp}/probe", fresh)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        saved, got = trainer.state_dict(), fresh.state_dict()
        diff = [k for k, v in saved["model"].items()
                if not torch.equal(v, got["model"][k])]
        diff += [f"moment {i}" for i, (a, b) in enumerate(zip(
            saved["optimizer"]["mu"] + saved["optimizer"]["nu"],
            got["optimizer"]["mu"] + got["optimizer"]["nu"]))
            if not torch.equal(a, b)]
        if (diff or saved["step"] != got["step"]
                or saved["optimizer"]["count"] != got["optimizer"]["count"]):
            raise AssertionError(f"checkpoint restore differs: {diff[:8]}, "
                                 f"step {got['step']} / {saved['step']}")
        log(f"self-train checkpoint: {nbytes_ckpt} bytes ({len(diff)} "
            f"differing tensors of {len(saved['model'])} + "
            f"{2 * len(saved['optimizer']['mu'])} moments after a restore "
            f"into a fresh trainer: bitwise EQUAL, step {got['step']}); "
            f"save {save_ms:.1f} ms, restore {restore_ms:.1f} ms")
        del fresh, saved, got, trainer, exp
        torch.cuda.empty_cache()

        # the export: scripts/mask3d_DINO_CSC_self_train.sh's test run
        cfg = get_parameters(SELF_TRAIN_EXPORT + data + [
            f"general.save_dir={r1}"])
        t0 = time.perf_counter()
        exp = build_experiment(cfg)
        res_x = exp.test(checkpoint=cfg.general.checkpoint,
                         save_for_freemask=bool(cfg.general.save_for_freemask))
        t_export = time.perf_counter() - t0
        evalx = dict(exp.eval_stats)
        if exp._eval_dev_cache or exp._eval_cache:
            raise AssertionError("test() left eval batches cached")
        files = sorted(glob.glob(f"{r1}/freemasks/*.npy"))
        for name, n in points.items():
            masks = np.load(f"{r1}/freemasks/{name}_masks.npy")
            cloud = np.load(f"{r1}/freemasks/{name}_cloud.npy")
            if masks.dtype != bool or masks.shape[0] != n or \
                    cloud.shape != (n, 3):
                raise AssertionError(f"export {name}: masks {masks.dtype} "
                                     f"{masks.shape}, cloud {cloud.shape}, "
                                     f"{n} points")
        n_bytes = sum(os.path.getsize(f) for f in files)
        log(f"self-train export: {len(files)} files, {n_bytes} bytes, "
            f"{t_export:.1f}s (build, restore, evaluation: "
            f"{_eval_split(evalx)})")
        del exp
        torch.cuda.empty_cache()

        # round 2: the next round's overrides from its best checkpoint
        cfg = get_parameters(SELF_TRAIN_ROUND + data + [
            f"general.save_dir={tmp}/round2", "trainer.max_epochs=1",
            "optimizer=adamw_lower",
            f"data.datasets.train_dataset.self_train_data_dir={r1}",
            "data.datasets.train_dataset.load_self_train_data=true",
            f"general.checkpoint={r1}/best"])
        t0 = time.perf_counter()
        exp = build_experiment(cfg)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        trainer = exp.fit(seed=int(cfg.general.seed),
                          resume=bool(cfg.general.resume),
                          checkpoint=cfg.general.checkpoint)
        t_fit = time.perf_counter() - t0
        n_steps += trainer.step
        ds = exp.train_dataset
        found = sorted(ds.merge_found)
        _self_train_report("round 2", exp, t_build, t_fit)
        log(f"self-train round 2 merge: exports found for {len(found)} of "
            f"{len(points)} train scenes, {ds.merged_instances} instances "
            "merged (at random weights the count means nothing)")
        if len(found) != len(points):
            raise AssertionError(f"merge found {found}, expected "
                                 f"{sorted(points)}")
        res2 = exp.last_results
        n_evals = 3 * len(points)
        del trainer, exp
    launches = {k: fn.launches for k, fn in cnt.items()}
    log(f"self-train path: {n_steps} train steps, {n_evals} evaluated "
        f"scenes, launches {launches}")
    for k in PER_TRAIN_STEP:
        want = n_steps * PER_TRAIN_STEP[k] + n_evals * PER_FORWARD[k]
        if launches[k] != want:
            raise AssertionError(f"self-train {k}: {launches[k]} launches, "
                                 f"expected {n_steps} x {PER_TRAIN_STEP[k]}"
                                 f" + {n_evals} x {PER_FORWARD[k]}")
    for what, res in (("round 1", res1), ("export", res_x),
                      ("round 2", res2)):
        aps = [res["all_ap"], res["all_ap_50%"], res["all_ap_25%"]]
        if not all(np.isfinite(aps)):
            raise AssertionError(f"self-train {what}: AP not finite {aps}")
        log(f"self-train {what} AP / AP50 / AP25: {aps[0]:.4f} / "
            f"{aps[1]:.4f} / {aps[2]:.4f} (finite; at random weights their "
            "values mean nothing)")
    steps = fit1["step_ms"]
    scenes_s = TRAIN_BATCH * len(steps) / sum(fit1["epoch_s"])
    log(f"self-train round 1 through fit: steps {[round(x, 1) for x in steps]}"
        f" ms, prefetch wait {[round(x, 1) for x in fit1['wait_ms']]} ms per "
        f"step, epochs {[round(x, 2) for x in fit1['epoch_s']]} s = "
        f"{scenes_s:.2f} scenes/s through fit (Trainer.train_step alone, "
        f"f32, phase_train_f32: {1e3 * TRAIN_BATCH / f32_step_ms:.2f} "
        f"scenes/s); eval {eval1['seconds'] / eval1['scenes']:.3f} s per "
        f"scene; on {card}")
    STEP_STATS["self_train"] = (scenes_s,
                                eval1["seconds"] / eval1["scenes"])
    log(f"phase self_train: {time.perf_counter() - t_phase:.1f}s")
    return launches


# -------------------------------------------------------------- supervised
class _Spy:
    """Wraps Experiment._collate_step and Trainer.train_step while a phase
    drives the entry point: the experiment, the classes of every collated
    train batch and every step's total loss."""

    def __init__(self):
        from unscene3d_torch.train import experiment, loop

        self.mods = (experiment.Experiment, loop.Trainer)
        self.exp, self.classes, self.losses = None, [], []

    def __enter__(self):
        exp_cls, trainer_cls = self.mods
        self.orig = (exp_cls._collate_step, trainer_cls.train_step)
        collate, step = self.orig
        spy = self

        def collate_step(exp, scene_lists):
            spy.exp = exp
            batches = collate(exp, scene_lists)
            for b in batches:
                t = b.target
                spy.classes.append(sorted(set(t.labels[t.valid].tolist())))
            return batches

        def train_step(trainer, batch, generator=None):
            losses = step(trainer, batch, generator)
            spy.losses.append(float(losses["total"]))
            return losses

        exp_cls._collate_step, trainer_cls.train_step = collate_step, \
            train_step
        return self

    def __exit__(self, *exc):
        self.mods[0]._collate_step, self.mods[1].train_step = self.orig


def phase_supervised(dev, card):
    """Supervised Mask3D training through the port's entry point,
    `unscene3d_torch.main_instance_segmentation.main`, with the overrides
    of scripts/scannet/scannet_val.sh (data/datasets=scannet, 19 targets):
    SemanticSegmentationDataset on 8 train and 2 validation scenes of the
    bench scene's size written in the Mask3D npy layout, Mask3D(Res16UNet34C)
    at conf/model/mask3d.yaml's widths, f32, batch 8, the default
    augmentations; 3 steps and one validation with save_visualizations.
    Asserts finite losses, train targets of several classes, kernels 1-5's
    launches and every validation scene's visualization files; prints the
    step ms, scenes/s through fit and the prefetch wait."""
    import os
    import shutil

    from unscene3d_torch import main_instance_segmentation as entry
    from unscene3d_torch.data.synthetic import write_mask3d_scenes

    t_phase = time.perf_counter()
    root = _smoke_dir("supervised")
    t0 = time.perf_counter()
    write_mask3d_scenes(f"{root}/data", SUPERVISED_SCENES, **BENCH_SCENE,
                        class_ids=SUPERVISED_CLASSES, seed=400)
    t_write = time.perf_counter() - t0
    cnt = reset_counters()
    t0 = time.perf_counter()
    with _Spy() as spy:
        trainer = entry.main(SCANNET_VAL + [
            f"general.data_dir={root}/data", f"general.save_dir={root}/run",
            "data.batch_size=8", f"trainer.max_epochs={SUPERVISED_STEPS}",
            f"trainer.check_val_every_n_epoch={SUPERVISED_STEPS}",
            "general.save_visualizations=true"])
    t_main = time.perf_counter() - t0
    exp = spy.exp
    launches = {k: fn.launches for k, fn in cnt.items()}
    n_steps, n_evals = trainer.step, SUPERVISED_SCENES["validation"]
    if (n_steps != SUPERVISED_STEPS or exp.device != dev
            or exp.model.dtype != torch.float32
            or exp.model.num_classes != 19):
        raise AssertionError(f"supervised: {n_steps} steps on {exp.device}"
                             f", {exp.model.dtype}, {exp.model.num_classes} "
                             "classes")
    if len(spy.losses) != n_steps or not np.isfinite(spy.losses).all():
        raise AssertionError(f"supervised losses {spy.losses}")
    if not all(len(c) > 1 and min(c) >= 2 for c in spy.classes):
        raise AssertionError(f"supervised target classes {spy.classes}")
    for k in PER_TRAIN_STEP:
        want = n_steps * PER_TRAIN_STEP[k] + n_evals * PER_FORWARD[k]
        if launches[k] != want:
            raise AssertionError(f"supervised {k}: {launches[k]} launches, "
                                 f"expected {n_steps} x {PER_TRAIN_STEP[k]}"
                                 f" + {n_evals} x {PER_FORWARD[k]}")
    vis = f"{root}/run/visualizations"
    files = sorted(os.listdir(vis))
    for i in range(SUPERVISED_SCENES["train"],
                   SUPERVISED_SCENES["train"] + n_evals):
        for suffix in (".html", "_rgb.ply", "_segments.ply"):
            if f"scene{i:04d}_00{suffix}" not in files:
                raise AssertionError(f"supervised visualizations: {files}")
    res = exp.last_results
    aps = [res["all_ap"], res["all_ap_50%"], res["all_ap_25%"]]
    if not all(np.isfinite(aps)):
        raise AssertionError(f"supervised AP not finite {aps}")
    st, ev = exp.fit_stats, exp.eval_stats
    scenes_s = TRAIN_BATCH * len(st["step_ms"]) / sum(st["epoch_s"])
    vis_bytes = sum(os.path.getsize(os.path.join(vis, f)) for f in files)
    log(f"supervised (scannet_val.sh through main_instance_segmentation."
        f"main, f32, batch 8 of {BENCH_SCENE['num_points']}-point scenes, "
        f"{sum(SUPERVISED_SCENES.values())} scenes written in "
        f"{t_write:.1f}s): main {t_main:.1f}s; train classes per batch "
        f"{spy.classes}; losses {[round(x, 4) for x in spy.losses]}; step "
        f"ms {[round(x, 1) for x in st['step_ms']]}, prefetch wait ms "
        f"{[round(x, 1) for x in st['wait_ms']]}, epoch s "
        f"{[round(x, 2) for x in st['epoch_s']]} = {scenes_s:.2f} scenes/s"
        f" through fit; validation {_eval_split(ev)}; AP / AP50 / AP25 "
        f"{aps[0]:.4f} / {aps[1]:.4f} / {aps[2]:.4f} (random weights); "
        f"{len(files)} visualization files, {vis_bytes} bytes; launches "
        f"{dict((k, v) for k, v in launches.items() if v)} = {n_steps} x "
        f"the step's + {n_evals} x the forward's; on {card}")
    STEP_STATS["supervised"] = (scenes_s, ev["seconds"] / ev["scenes"])
    del trainer, exp, spy
    torch.cuda.empty_cache()
    shutil.rmtree(root)       # ~0.4 GB of scenes and visualizations
    log(f"phase supervised: {time.perf_counter() - t_phase:.1f}s")
    return launches


def phase_eval_clis(dev, card):
    """The three evaluation CLIs through their `main(argv)` on a ScanNet-
    layout directory written here: 2 meshes of phase_pseudo_main's size
    (scannet200_insseg `.pth` clouds, meshes, poses, ScanNet's color
    intrinsics), pseudo masks drawn from the GT instances for
    eval_freemask_gt_performance, and CutLER-style PNG id maps rendered
    from the GT for eval_cutler_projection, which runs on the card and
    again with --device cpu: the per-frame ids must be equal. Prints each
    CLI's seconds a scene and HDBSCAN's share of eval_3duis_performance."""
    import contextlib
    import io
    import os

    from PIL import Image

    from unscene3d_torch import (eval_3duis_performance,
                                 eval_cutler_projection,
                                 eval_freemask_gt_performance)
    from unscene3d_torch.data.synthetic import (make_mesh_scene,
                                                render_instance_ids,
                                                ring_poses,
                                                scannet_color_intrinsics,
                                                write_scannet_scene)

    t_phase = time.perf_counter()
    root = _smoke_dir("eval_clis")
    ins, scans = os.path.join(root, "insseg"), os.path.join(root, "scans")
    masks_dir, cutler = os.path.join(root, "masks"), os.path.join(root,
                                                                  "cutler")
    os.makedirs(masks_dir)
    names = [f"scene{i:04d}_00" for i in range(2)]
    K = scannet_color_intrinsics()
    K_img = K[:3, :3] * np.array([MASK_IMAGE[1] / 1296.0,
                                  MASK_IMAGE[0] / 968.0, 1.0])[:, None]
    verts = {}
    for i, name in enumerate(names):
        mesh = make_mesh_scene(**MAIN_MESH, seed=20 + i)
        align = np.eye(4)
        align[:3, 3] = [-4.0, -4.0, 0.0]
        centre = (mesh["vertices"].min(0) + mesh["vertices"].max(0)) / 2
        poses = ring_poses(centre, 7.0, 2.5, EVAL_FRAMES)
        write_scannet_scene(ins, scans, name, mesh, alignment=align,
                            poses=poses, image_resolution=(96, 128), seed=i)
        np.savetxt(os.path.join(scans, name, "intrinsic",
                                "intrinsic_color.txt"), K)
        inst = mesh["instances"]
        r = np.random.RandomState(i)
        soft = np.stack([np.where(inst == k, 0.6 + 0.4 * r.rand(len(inst)),
                                  0.4 * r.rand(len(inst)))
                         for k in np.unique(inst[inst >= 0])], 1)
        np.save(os.path.join(masks_dir, f"{name}_cloud.npy"),
                mesh["vertices"])
        np.save(os.path.join(masks_dir, f"{name}_masks.npy"), soft)
        os.makedirs(os.path.join(cutler, name))
        for k, pose in enumerate(poses):
            Image.fromarray(render_instance_ids(
                mesh["vertices"].astype(np.float64), inst, pose, K_img,
                MASK_IMAGE)).save(os.path.join(cutler, name,
                                               f"{20 * k:06d}.png"))
        verts[name] = len(mesh["vertices"])
    with open(os.path.join(ins, "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    t_write = time.perf_counter() - t_phase

    def run(module, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = module.main(argv)
        lines = out.getvalue().splitlines()
        if res["results"] is None or not lines[-1].startswith("AP "):
            raise AssertionError(f"{module.__name__}: {lines}")
        aps = [res["results"][k] for k in ("all_ap", "all_ap_50%",
                                           "all_ap_25%")]
        if not all(np.isfinite(aps)):
            raise AssertionError(f"{module.__name__}: AP {aps}")
        return res, lines[-1]

    res_f, line_f = run(eval_freemask_gt_performance,
                        ["--masks_dir", masks_dir, "--gt_dir", ins])
    res_h, line_h = run(eval_3duis_performance, ["--gt_dir", ins])
    cli = ["--masks_dir", cutler, "--gt_dir", ins, "--scans_dir", scans]
    res_c, line_c = run(eval_cutler_projection, cli)
    res_cpu, line_cpu = run(eval_cutler_projection, cli + ["--device", "cpu"])
    differ = sum(int((a != b).sum()) for s in names for a, b in zip(
        res_c["per_frame"][s], res_cpu["per_frame"][s]))
    if differ or line_c != line_cpu:
        raise AssertionError(f"cutler projection: {differ} per-frame ids "
                             f"differ card vs CPU; {line_c} / {line_cpu}")
    n = len(names)
    log(f"eval CLIs ({n} scenes of {sorted(verts.values())} points, layout "
        f"written in {t_write:.1f}s; host clock): freemask_gt "
        f"{res_f['seconds'] / n:.3f} s a scene ({line_f}); 3duis "
        f"{res_h['seconds'] / n:.3f} s a scene on {res_h['voxels']} voxels "
        f"(5 cm), HDBSCAN {res_h['hdbscan_seconds'] / n:.3f} s a scene = "
        f"{100 * res_h['hdbscan_seconds'] / res_h['seconds']:.1f}% ({line_h})"
        f"; cutler_projection on the card {res_c['seconds'] / n:.3f} s a "
        f"scene ({res_c['frames']} frames of {MASK_IMAGE[0]} x "
        f"{MASK_IMAGE[1]}, projection {res_c['project_seconds']:.3f}s; "
        f"{line_c}), with --device cpu {res_cpu['seconds'] / n:.3f} s a scene"
        f" (projection {res_cpu['project_seconds']:.3f}s); per-frame ids card"
        f" vs CPU: {differ} differ (EQUAL); on {card}")
    log(f"phase eval_clis: {time.perf_counter() - t_phase:.1f}s")


# ---------------------------------------------------------------- train_dp
def train_shards(n):
    """The train batch's 8 scenes (train_batch) as n shards of 8 / n,
    each collated alone, as each rank collates its own (CPU tensors)."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene

    scenes = [make_scene(**TRAIN_SCENE, seed=100 + i)
              for i in range(TRAIN_BATCH)]
    per = TRAIN_BATCH // n
    collator = FreeMaskCollator(voxel_size=VOXEL, fps_queries=100)
    return [collator(scenes[r * per:(r + 1) * per])[0] for r in range(n)]


def _spawn_ranks(fn, args, nprocs, limit, what):
    """fn(rank, *args) in nprocs spawned processes, joined under `limit`
    seconds; raises when a rank fails, dies or runs past it."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: a rank ran past {limit}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _dp_rank(rank, world, backend, coordinator, shards_path, out_path):
    """One rank of phase_train_dp (a spawned process): the seeded f32
    trainer (full widths) under a `backend` group, replicate, one warm-up
    step and a restore, then the measured step on this rank's shard with
    the rank's generator, kernels 1-5's launches counted around it. Saves
    the state after the step, the launches and the times to
    `out_path`.<rank>."""
    import copy

    import torch.distributed as dist

    from unscene3d_torch.parallel.distributed import rank_seed
    from unscene3d_torch.parallel.mesh import replicate
    from unscene3d_torch.train.loop import build_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank, **kw)
    try:
        trainer = build_trainer(torch.float32, seed=0, device=dev,
                                group=dist.group.WORLD)
        replicate(trainer)
        start = copy.deepcopy(trainer.state_dict())
        batch = torch.load(shards_path, weights_only=False)[rank].to(dev)
        seed = rank_seed(0, rank)
        trainer.train_step(batch, torch.Generator(device=dev).manual_seed(seed))
        trainer.load_state_dict(start)
        grads_done = []
        step_of = type(trainer).loss_and_grads

        def timed(self, b, generator=None):
            out = step_of(self, b, generator)
            torch.cuda.synchronize()
            grads_done.append(time.perf_counter())
            return out

        trainer.loss_and_grads = timed.__get__(trainer)
        dist.barrier()
        cnt = reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.train_step(batch,
                                    torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = {k: fn.launches for k, fn in cnt.items()}
        nbytes, ar_ms = trainer.last_all_reduce()
        torch.save({"state": _flat_state(trainer.state_dict()),
                    "losses": {k: v.cpu() for k, v in losses.items()},
                    "launches": launches, "step_ms": 1e3 * (t1 - t0),
                    "grads_ms": 1e3 * (grads_done[0] - t0),
                    "wait_ms": 1e3 * (t1 - grads_done[0]),
                    "allreduce_ms": ar_ms, "allreduce_bytes": nbytes},
                   f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def _flat_state(state):
    """A Trainer.state_dict() as CPU tensors by name: the model's
    state_dict (parameters, BN statistics), AdamW's moments, the step and
    the count."""
    flat = {f"model.{k}": v for k, v in state["model"].items()}
    opt = state["optimizer"]
    flat.update({f"mu.{i}": m for i, m in enumerate(opt["mu"])})
    flat.update({f"nu.{i}": v for i, v in enumerate(opt["nu"])})
    flat = {k: v.to("cpu", copy=True) for k, v in flat.items()}
    flat["count"] = torch.tensor([state["step"], opt["count"]])
    return flat


def _mean_of_shards(trainer, batches, seeds):
    """The mean-of-shards step in this process on `trainer`: each batch's
    loss_and_grads with a generator of its seed on the trainer's device
    and its BN statistics updated from the same start, the gradients and
    the BN statistics summed and divided by the batch count, one AdamW
    step. Returns (the flat state after the step, the mean float
    losses)."""
    dev = trainer.params[0].device
    stats_of = [t for bn in trainer._bns for t in (bn.mean, bn.var)]
    start = [t.clone() for t in stats_of]
    grads = stats = None
    losses = []
    for batch, seed in zip(batches, seeds):
        with torch.no_grad():
            for t, v in zip(stats_of, start):
                t.copy_(v)
        gen = torch.Generator(device=dev).manual_seed(seed)
        ls, g = trainer.loss_and_grads(batch.to(dev), gen)
        for bn in trainer._bns:
            bn.update_running_stats()
        s = [t.clone() for t in stats_of]
        grads = g if grads is None else torch._foreach_add(grads, g)
        stats = s if stats is None else torch._foreach_add(stats, s)
        losses.append(ls)
        del g
    n = float(len(batches))
    torch._foreach_div_(grads, n)
    torch._foreach_div_(stats, n)
    with torch.no_grad():
        for t, v in zip(stats_of, stats):
            t.copy_(v)
    trainer.optimizer.step(trainer.params, grads)
    trainer.step += 1
    mean = {k: sum(ls[k] for ls in losses) / n for k, v in losses[0].items()
            if v.is_floating_point()}
    return _flat_state(trainer.state_dict()), mean


def _differing(got, want, tol=None):
    """Names whose tensors differ: bitwise (tol None), else by more than
    tol of the tensor's largest |want|."""
    out = []
    for k, w in want.items():
        g = got[k]
        if tol is None:
            if not torch.equal(g, w):
                out.append(k)
        elif w.is_floating_point():
            scale = max(w.abs().max().item(), 1e-30)
            if (g - w).abs().max().item() > tol * scale:
                out.append(k)
        elif not torch.equal(g, w):
            out.append(k)
    return out


def phase_train_dp(dev, card, host_batch):
    """Data parallelism of the self-training round's step (train/loop.py
    under a process group):

      * world size 1 over NCCL: the f32 step on the train batch is bitwise
        Trainer.train_step from the same state;
      * DP_RANKS ranks on this one card over gloo (NCCL refuses two ranks on
        one device), each with 8 / DP_RANKS of the train batch's scenes, f32
        at full widths from seeded random weights: the state after one step
        (every parameter, BN statistic and AdamW moment) bitwise the
        mean-of-shards oracle computed here on the card, kernels 1-5's
        launches per rank, each rank's step and wait ms and the
        all-reduce's ms and bytes. The ranks time-share the card, so their
        step time is no scaling number;
      * where the machine has two cards or more: the same ranks over NCCL
        on two cards against the same oracle, and the entry point
        (`python -m unscene3d_torch.main_instance_segmentation`, one rank
        per card) held to its own mean-of-shards oracle, both at f32
        tolerance. On one card this part does not run and says so.

    Returns kernels 1-5's launches of rank 0's step (asserted equal on
    every rank)."""
    import copy
    import tempfile

    import torch.distributed as dist

    from unscene3d_torch.parallel.distributed import free_port, rank_seed
    from unscene3d_torch.train.loop import build_trainer

    t_phase = time.perf_counter()
    # world size 1 over NCCL
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        trainer = build_trainer(torch.float32, seed=0, device=dev)
        batch = host_batch.to(dev)
        start = copy.deepcopy(trainer.state_dict())
        runs = []
        for group in (None, dist.group.WORLD):
            trainer.load_state_dict(start)
            trainer.group = group
            losses = trainer.train_step(
                batch, torch.Generator(device=dev).manual_seed(0))
            runs.append((_flat_state(trainer.state_dict()), losses))
        nbytes, nccl_ms = trainer.last_all_reduce()
    finally:
        dist.destroy_process_group()
    diff = _differing(runs[1][0], runs[0][0])
    diff += [f"loss {k}" for k in runs[0][1]
             if not torch.equal(runs[0][1][k], runs[1][1][k])]
    if diff:
        raise AssertionError(f"NCCL world size 1: the step differs from "
                             f"Trainer.train_step in {diff[:8]}")
    log(f"train_dp NCCL world size 1, f32 train batch: bitwise EQUAL to "
        f"Trainer.train_step ({len(runs[0][0])} state tensors and the "
        f"losses); all-reduce of one rank {nccl_ms:.3f} ms, {nbytes} bytes "
        f"({nbytes / 4e6:.1f} M f32)")
    del trainer, batch, start, runs
    torch.cuda.empty_cache()

    shards = train_shards(DP_RANKS)
    with tempfile.TemporaryDirectory() as tmp:
        shards_path = f"{tmp}/shards.pt"
        torch.save(shards, shards_path)
        t0 = time.perf_counter()
        _spawn_ranks(_dp_rank, (DP_RANKS, "gloo",
                                f"localhost:{free_port()}", shards_path,
                                f"{tmp}/gloo"),
                     DP_RANKS, 300, "train_dp gloo")
        t_ranks = time.perf_counter() - t0
        outs = [torch.load(f"{tmp}/gloo.{r}", weights_only=False)
                for r in range(DP_RANKS)]
        want, want_losses = _mean_of_shards(
            build_trainer(torch.float32, seed=0, device=dev), shards,
            [rank_seed(0, r) for r in range(DP_RANKS)])
        for r, out in enumerate(outs):
            diff = _differing(out["state"], want)
            diff += [f"loss {k}" for k, v in want_losses.items()
                     if not torch.equal(out["losses"][k], v.cpu())]
            if diff:
                raise AssertionError(f"train_dp rank {r}: {len(diff)} "
                                     f"tensors differ from the mean of "
                                     f"shards, first {diff[:8]}")
            for k, per in PER_TRAIN_STEP.items():
                if out["launches"][k] != per:
                    raise AssertionError(f"train_dp rank {r} {k}: "
                                         f"{out['launches'][k]} launches, "
                                         f"expected {per} per step")
            log(f"train_dp rank {r}/{DP_RANKS} (gloo, one card, "
                f"{TRAIN_BATCH // DP_RANKS} scenes): step "
                f"{out['step_ms']:.1f} ms (forward + backward "
                f"{out['grads_ms']:.1f} ms, then wait + all-reduce + AdamW "
                f"{out['wait_ms']:.1f} ms), all-reduce {out['allreduce_ms']:.1f}"
                f" ms (CUDA events) of {out['allreduce_bytes']} bytes; loss "
                f"{out['losses']['total'].item():.4f}; launches "
                f"{out['launches']}")
        log(f"train_dp: {DP_RANKS} ranks bitwise EQUAL to the mean-of-shards "
            f"oracle on the card ({len(want)} state tensors: parameters, BN "
            f"statistics, AdamW moments, step) and to each other; spawn + "
            f"steps {t_ranks:.1f}s. The ranks time-share one card: their "
            f"step time is no scaling number; on {card}")
        if outs[1]["launches"] != outs[0]["launches"]:
            raise AssertionError("train_dp: the ranks' launches differ")
        if torch.cuda.device_count() >= 2:
            _train_dp_cards(tmp, shards_path, want, card)
        else:
            log(f"train_dp: NCCL across cards NOT RUN: this machine has "
                f"{torch.cuda.device_count()} card, and NCCL refuses two "
                "ranks on one device")
    log(f"phase train_dp: {time.perf_counter() - t_phase:.1f}s")
    return outs[0]["launches"]


def _train_dp_cards(tmp, shards_path, want, card):
    """Two ranks over NCCL on cards 0 and 1 against the same oracle, then
    the entry point on two cards against its own (f32 tolerance)."""
    from unscene3d_torch.parallel.distributed import free_port

    _spawn_ranks(_dp_rank, (2, "nccl", f"localhost:{free_port()}",
                            shards_path, f"{tmp}/nccl"),
                 2, 300, "train_dp nccl")
    for r in range(2):
        out = torch.load(f"{tmp}/nccl.{r}", weights_only=False)
        diff = _differing(out["state"], want, DP_CARDS_TOL)
        if diff:
            raise AssertionError(f"train_dp NCCL rank {r}: {diff[:8]} off "
                                 "the mean of shards")
        bitwise = not _differing(out["state"], want)
        log(f"train_dp NCCL rank {r} on card {r}: step "
            f"{out['step_ms']:.1f} ms (forward + backward "
            f"{out['grads_ms']:.1f}, wait + all-reduce + AdamW "
            f"{out['wait_ms']:.1f}), NCCL all-reduce "
            f"{out['allreduce_ms']:.3f} ms of {out['allreduce_bytes']} "
            f"bytes; state within {DP_CARDS_TOL} of the oracle "
            f"({'bitwise' if bitwise else 'not bitwise'}); on {card}")
    _train_dp_entry(tmp)


def _train_dp_entry(tmp):
    """The entry point on two cards (it spawns one rank per card) on the
    self-train scenes for one step, then the same step rebuilt here: each
    rank's scene draws (the shared sampler, the rank's own data set and
    collator seeds), its shard's gradients with its generator, the mean, one
    AdamW step; rank 0's checkpoint held to it at f32 tolerance."""
    import os
    import subprocess

    import unscene3d_torch.parallel.distributed as dist_mod
    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)
    from unscene3d_torch.parallel.distributed import rank_seed
    from unscene3d_torch.train import checkpoint as ckpt
    from unscene3d_torch.train.experiment import _EpochSampler

    _write_self_train_data(f"{tmp}/data")
    data = [f"general.data_dir={tmp}/data",
            f"data.datasets.validation_dataset.data_dir={tmp}/data",
            f"data.datasets.test_dataset.data_dir={tmp}/data"]
    argv = SELF_TRAIN_ROUND + data + [f"general.save_dir={tmp}/entry",
                                      "trainer.max_epochs=1"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0,1")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "unscene3d_torch.main_instance_segmentation",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=600)
    t_run = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"entry point on 2 cards: rc {res.returncode}"
                             f"\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    saved = ckpt.load_state(f"{tmp}/entry/checkpoints")
    # the same step rebuilt in this process, rank by rank
    cfg = get_parameters(argv + [f"general.save_dir={tmp}/rebuilt"])
    seed = int(cfg.general.seed)
    batches, trainer = [], None
    real = dist_mod.rank, dist_mod.world_size
    try:
        for r in range(2):
            dist_mod.rank, dist_mod.world_size = (lambda r=r: r), (lambda: 2)
            exp = build_experiment(cfg, "cuda:0")
            sampler = _EpochSampler(len(exp.train_dataset),
                                    np.random.RandomState(seed))
            exp.collator.reseed(rank_seed(seed, r))
            ids = exp._draw_step_ids(sampler)
            batches.append(exp._collate_step(exp._load_scenes(ids))[0])
            if r == 0:
                trainer = exp.trainer
            exp.close()
    finally:
        dist_mod.rank, dist_mod.world_size = real
    want, _ = _mean_of_shards(trainer, batches,
                              [rank_seed(seed, r) for r in range(2)])
    diff = _differing(_flat_state(saved), want, DP_CARDS_TOL)
    if diff:
        raise AssertionError(f"entry point on 2 cards: {diff[:8]} off the "
                             "mean of shards")
    written = sorted(os.listdir(f"{tmp}/entry"))
    log(f"train_dp entry point on 2 cards (NCCL, {TRAIN_BATCH} scenes, "
        f"4 a rank): {t_run:.1f}s, rank 0's checkpoint within "
        f"{DP_CARDS_TOL} of the mean-of-shards step rebuilt here; wrote "
        f"{written}")


def _triplane_planes(tri, valid):
    """Pixels of each plane and the voxels a pixel holds (median, max), from
    the host maps: each plane's pixels are one range of ids."""
    pid, counts = tri.pixel_id.numpy(), tri.counts.numpy()
    out, lo = [], 0
    for d, name in enumerate(("XY", "XZ", "YZ")):
        hi = int(pid[d][valid].max()) + 1
        c = counts[lo:hi]
        out.append(f"{name} {hi - lo} (median {int(np.median(c))}, max "
                   f"{int(c.max())} voxels a pixel)")
        lo = hi
    return out


def _noise_robust_ms(trainer, batch, gen, reps=2):
    """Device time of the tri-plane loss alone (CUDA events): its forward
    (target and prediction projections, BCE, scene sums) and its backward
    to the segment logits, on one forward's outputs and matching; the last
    of `reps` runs. Also its kernel-3 launches per forward + backward."""
    model, crit = trainer.model, trainer.criterion
    with torch.no_grad():
        out = model(batch, generator=gen)
        matched = crit.matcher(out["pred_logits"], out["pred_masks_seg"],
                               batch.target, batch.seg_valid)
    seg = out["pred_masks_seg"].detach().requires_grad_()
    del out
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(reps):
        cnt = reset_counters()
        ev[0].record()
        loss = crit._loss_noise_robust(seg, batch.target, matched, batch)
        ev[1].record()
        torch.autograd.grad(loss.sum(), seg)
        ev[2].record()
        ev[2].synchronize()
    return (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
            cnt["segment_sum"].launches)


def _triplane_loss_f64(seg, batch, matched):
    """loss_noise_robust of every set in f64 on the CPU, the same math as
    the criterion's (plain index_add_ sums): the reference that shows how
    far the f32 loss sits from exact on this input."""
    L, B, S, Q = seg.shape
    T = matched.shape[-1]
    tri, valid = batch.triplane, batch.valid
    mq = torch.clamp_min(matched, 0)[:, :, None, :].expand(L, B, S, T)
    sig = torch.sigmoid(torch.take_along_dim(seg.double(), mq, dim=3))
    seg_flat = batch.batch_idx.long() * S + batch.point2segment.long()
    pred = (sig.permute(1, 2, 0, 3).reshape(B * S, L * T)[seg_flat]
            * valid[:, None].double())

    def project(x):
        out = torch.zeros(tri.num_pixels + 1, x.shape[1], dtype=torch.float64)
        for d in range(3):
            ids = torch.where(valid, tri.pixel_id[d].long(), tri.num_pixels)
            out.index_add_(0, ids, x)
        return out[:-1]

    cnt = tri.counts.double()
    p = torch.clamp(project(pred).reshape(-1, L, T)
                    / (cnt + 1e-9)[:, None, None], 1e-7, 1 - 1e-7)
    t = (project(batch.target.vox_masks.double())
         / (cnt + 1e-9)[:, None])[:, None, :]
    t_valid = batch.target.valid[None] & (matched >= 0)
    bce = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    bce = (bce * t_valid.transpose(0, 1).double()[tri.pix_scene.long()]
           * ((cnt > 0) & tri.pix_valid)[:, None, None].double())
    ids = torch.where(tri.pix_valid, tri.pix_scene.long(), B)
    scene = torch.zeros(B + 1, L, dtype=torch.float64).index_add_(
        0, ids, bce.sum(-1))[:B]
    shape = torch.clamp_min(t_valid.sum(-1).double()
                            * tri.npix_scene.double()[None], 1.0)
    return (scene.T / shape).sum(-1), float((1 - p).min())


def _noise_robust_parity(dev):
    """loss_noise_robust of 13 sets and its gradient to the segment logits,
    card (kernel 3) vs CPU (twins), on the parity scene with random logits
    and one matching."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.losses.criterion import SetCriterion
    from unscene3d_torch.losses.matcher import HungarianMatcher

    scene = make_scene(num_points=30_000, num_objects=6, extent=4.0, seed=7)
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fps_queries=100,
                                   build_triplane=True)([scene])
    S = batch.num_segments_padded
    rng = np.random.RandomState(3)
    seg = torch.from_numpy((rng.randn(13, 1, S, 100) * 3).astype(np.float32))
    logits = torch.from_numpy(rng.randn(13, 1, 100, 3).astype(np.float32))
    crit = SetCriterion(HungarianMatcher(), weight_noise_robust=1.0)
    matched = crit.matcher(logits, seg, batch.target, batch.seg_valid)
    got = {}
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        b = batch.to(d)
        x = seg.to(d).requires_grad_()
        loss = crit._loss_noise_robust(x, b.target, matched.to(d), b)
        (g,) = torch.autograd.grad(loss.sum(), x)
        got[name] = (loss.detach().cpu(), g.cpu())
    (lc, gc), (lg, gg) = got["cpu"], got["cuda"]
    with torch.no_grad():
        l64, gap = _triplane_loss_f64(seg, batch, matched)
    exact = {k: ((v.double() - l64).abs() / l64).max().item()
             for k, v in (("card", lg), ("cpu", lc))}
    loss_err = ((lg - lc).abs() / lc.abs()).max().item()
    grad_err = ((gg - gc).abs().max() / gc.abs().max()).item()
    log(f"  noise-robust parity ({meta.num_voxels[0]} voxels, "
        f"{int(b.triplane.pix_valid.sum())} pixels, 13 sets): the f32 loss "
        f"against its f64 value (CPU): card {exact['card']:.2e} (tol "
        f"{NR_EXACT_TOL:g}), CPU {exact['cpu']:.2e}, min 1 - p {gap:.2e}; "
        f"card vs CPU: loss rel err {loss_err:.2e} (tol {NR_LOSS_TOL:g}), "
        f"gradient {grad_err:.2e} of its max (tol {NR_GRAD_TOL:g})")
    if not (torch.isfinite(lg).all() and (lg > 0).all()):
        raise AssertionError(f"noise-robust parity: loss {lg}")
    if not exact["card"] <= NR_EXACT_TOL:
        raise AssertionError(f"noise-robust parity: card loss {exact['card']} "
                             f"from its f64 value")
    if not (loss_err <= NR_LOSS_TOL and grad_err <= NR_GRAD_TOL):
        raise AssertionError(f"noise-robust parity: loss {loss_err}, "
                             f"gradient {grad_err}")


def phase_train_noise_robust(dev, card, host_batch):
    """The train batch with the noise-robust tri-plane loss at weight 1.0:
    the host maps and kernel 3's tables, kernel 3 at the tri-plane shapes
    (targets C = T, predictions C = 13 T) against its twin and index_add_,
    build_trainer(weight_noise_robust=1.0) in f32 and bf16 (one warm-up and
    NR_STEPS timed steps each, kernel 3's launches per step, peak memory
    beside the plain step of phase_train / phase_train_f32, the loss's own
    device time), two f32 steps from one state bitwise equal with the loss
    and also with dropout 0.1, and card-vs-CPU parity of the loss and its
    gradient."""
    import dataclasses

    from unscene3d_torch.ops import triplane as tri_ops
    from unscene3d_torch.train.loop import build_trainer

    t_phase = time.perf_counter()
    lvl0 = host_batch.graph.levels[0]
    valid = lvl0.valid.numpy()
    t0 = time.perf_counter()
    tri = tri_ops.build_triplane_maps(lvl0.coords.numpy(), valid,
                                      host_batch.batch_size)
    t_maps = time.perf_counter() - t0
    n_pix = int(tri.pix_valid.sum())
    log(f"noise-robust train batch: {int(valid.sum())} valid voxels of "
        f"{lvl0.num_padded} rows, T = {host_batch.target.labels.shape[1]}, "
        f"{n_pix} occupied pixels (padded {tri.num_pixels}): "
        f"{', '.join(_triplane_planes(tri, valid))}; order of "
        f"{tri.order.numel()} entries; host maps + kernel-3 tables "
        f"{t_maps:.2f}s")
    batch = dataclasses.replace(host_batch, triplane=tri).to(dev)
    tri_d, T = batch.triplane, batch.target.labels.shape[1]
    n0, trash, m = lvl0.num_padded, tri_d.num_pixels, tri_d.order.numel()
    n_valid = int(valid.sum())
    ids3 = torch.cat([torch.where(batch.valid, tri_d.pixel_id[d].long(),
                                  trash) for d in range(3)])
    g = torch.Generator().manual_seed(2)
    res = {}
    log("kernel 3 at the tri-plane shapes vs its twin (index_add_ per "
        "plane) and one index_add_ over the three planes (float atomics)")
    for c in (T, 13 * T):
        x = torch.rand(n0, c, generator=g).to(dev)
        x3 = x.repeat(3, 1)
        dump = torch.zeros(trash + 1, c, device=dev)
        res[c] = _compare(
            f"segment_sum triplane ({n0},{c})->({trash},{c})", torch.float32,
            lambda: tri_ops.project(x, tri_d, batch.valid),
            lambda: tri_ops.project_plain(x, tri_d, batch.valid),
            # bytes: each valid row once (the three planes may share one
            # read of it), the order, the pieces and the occupied pixels'
            # rows of the output; one add per entry and channel
            work=(nbytes(tri_d.order, tri_d.pieces)
                  + (n_valid + n_pix) * c * 4, m * c, torch.float32),
            library=lambda: dump.zero_().index_add_(0, ids3, x3))
        del x, x3, dump
    launches = {k: 0 for k in KERNELS}
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        trainer = build_trainer(dtype, seed=0, device=dev,
                                weight_noise_robust=1.0)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cnt = reset_counters()
        times = []
        for step in range(1 + NR_STEPS):
            t0 = time.perf_counter()
            losses = trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            nr = losses["loss_noise_robust"]
            for key in ("loss_ce", "loss_mask", "loss_dice",
                        "loss_noise_robust", "total"):
                if not torch.isfinite(losses[key]).all():
                    raise AssertionError(f"noise-robust {label} step {step}: "
                                         f"{key} not finite")
            if not (nr > 0).all():
                raise AssertionError(f"noise-robust {label} step {step}: "
                                     f"loss_noise_robust {nr.tolist()}")
            log(f"  noise-robust {label} step {step}: {times[-1]:.1f}ms "
                f"total={losses['total'].item():.4f} loss_noise_robust "
                f"sets {nr.min().item():.4f}-{nr.max().item():.4f}")
        got = {k: fn.launches for k, fn in cnt.items()}
        peak = torch.cuda.max_memory_allocated()
        n = 1 + NR_STEPS
        for k, per in PER_TRAIN_STEP_NR.items():
            if got[k] != per * n:
                raise AssertionError(f"noise-robust {label} {k}: {got[k]} "
                                     f"launches, expected {per} x {n}")
            launches[k] += got[k]
        warm = statistics.median(times[1:])
        plain_ms, plain_peak = STEP_STATS[label]
        fwd_ms, bwd_ms, k3 = _noise_robust_ms(trainer, batch, gen)
        log(f"train {label} with the noise-robust loss, batch {TRAIN_BATCH}: "
            f"first step {times[0]:.1f}ms, warm median of {NR_STEPS} "
            f"{warm:.1f}ms (min {min(times[1:]):.1f}, max "
            f"{max(times[1:]):.1f}) beside the plain step's {plain_ms:.1f}ms "
            f"in this run (+{warm - plain_ms:.1f}ms); peak device memory "
            f"{peak / 2**30:.2f} GiB beside {plain_peak / 2**30:.2f} GiB; "
            f"the loss alone (CUDA events): forward {fwd_ms:.2f}ms, "
            f"backward {bwd_ms:.2f}ms, {k3} kernel-3 launches; kernel 3 "
            f"{PER_TRAIN_STEP_NR['segment_sum']} launches a step; n_pix "
            f"{n_pix}; on {card}")
        STEP_STATS[f"nr_{label}"] = (warm, peak, fwd_ms, bwd_ms)
        if label == "f32":
            phase_train_repeat(dev, trainer, batch, "f32 noise-robust")
        del trainer
        torch.cuda.empty_cache()
    trainer = build_trainer(torch.float32, seed=0, device=dev,
                            weight_noise_robust=1.0, dropout=0.1)
    phase_train_repeat(dev, trainer, batch, "f32 noise-robust, dropout 0.1")
    del trainer, batch
    torch.cuda.empty_cache()
    _noise_robust_parity(dev)
    log(f"phase train_noise_robust: {time.perf_counter() - t_phase:.1f}s")
    return launches, res


def phase_train_options(dev, card, bench_batch):
    """The training options through the entry point's functions
    (get_parameters + build_experiment + fit): the overrides of
    scripts/unsupervised/train_unscene3d.sh with TRAIN_OPTIONS (the
    noise-robust loss, decoder dropout and pre-norm, the Mix3D merge
    collator, eval collates in 2 processes) on phase_self_train's 8 scenes,
    one epoch of one step and one validation; then one eval forward of the
    bench scene per decoder mode group (bf16, full width), finite and of the
    expected shapes. Launch counts read around both."""
    import tempfile

    from unscene3d_torch.inference import build_mask3d
    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)

    t_phase = time.perf_counter()
    cnt = reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        _write_self_train_data(f"{tmp}/data")
        over = [o for o in SELF_TRAIN_ROUND
                if not o.startswith("data/collation_functions=")]
        cfg = get_parameters(over + TRAIN_OPTIONS + [
            f"general.data_dir={tmp}/data",
            f"data.datasets.validation_dataset.data_dir={tmp}/data",
            f"data.datasets.test_dataset.data_dir={tmp}/data",
            f"general.save_dir={tmp}/run", "trainer.max_epochs=1",
            "trainer.check_val_every_n_epoch=1"])
        t0 = time.perf_counter()
        exp = build_experiment(cfg)
        t_build = time.perf_counter() - t0
        try:
            layer = exp.model.cross_attention[0][0]
            if not (type(exp.collator).__name__ == "MergeCollator"
                    and exp.collator.build_triplane
                    and exp.criterion.weight_noise_robust == 1.0
                    and exp.prefetch_processes == 2 and layer.pre_norm
                    and layer.dropout == 0.1 and exp.device == dev):
                raise AssertionError("train options: the overrides did not "
                                     "reach the experiment")
            t0 = time.perf_counter()
            trainer = exp.fit(seed=int(cfg.general.seed),
                              resume=bool(cfg.general.resume),
                              checkpoint=cfg.general.checkpoint)
            t_fit = time.perf_counter() - t0
            pooled = exp._collate_pool is not None
        finally:
            exp.close()
        fit, ev, res = exp.fit_stats, exp.eval_stats, exp.last_results
        n_steps = trainer.step
        _self_train_report("train options", exp, t_build, t_fit)
        del trainer, exp
    launches = {k: fn.launches for k, fn in cnt.items()}
    n_evals = ev["scenes"]
    log(f"train options path: {n_steps} train steps, {n_evals} evaluated "
        f"scenes (collates in a pool of 2 processes: {pooled}), launches "
        f"{launches}")
    for k in PER_TRAIN_STEP_NR:
        want = n_steps * PER_TRAIN_STEP_NR[k] + n_evals * PER_FORWARD[k]
        if launches[k] != want:
            raise AssertionError(f"train options {k}: {launches[k]} launches,"
                                 f" expected {n_steps} x "
                                 f"{PER_TRAIN_STEP_NR[k]} + {n_evals} x "
                                 f"{PER_FORWARD[k]}")
    aps = [res["all_ap"], res["all_ap_50%"], res["all_ap_25%"]]
    if not (pooled and all(np.isfinite(aps))):
        raise AssertionError(f"train options: pool {pooled}, AP {aps}")
    scenes_s = TRAIN_BATCH * n_steps / sum(fit["epoch_s"])
    st_scenes_s, st_eval_s = STEP_STATS["self_train"]
    log(f"train options through fit: {scenes_s:.2f} scenes/s (Mix3D merges "
        f"of 2 scenes, noise-robust loss, dropout 0.1, pre-norm; "
        f"phase_self_train's round 1: {st_scenes_s:.2f} scenes/s); eval "
        f"{ev['seconds'] / n_evals:.3f} s per scene with the collate pool "
        f"(phase_self_train's round 1, thread collates: {st_eval_s:.3f} s); "
        f"AP / AP50 / AP25 {aps[0]:.4f} / {aps[1]:.4f} / {aps[2]:.4f} "
        f"(finite; at random weights their values mean nothing); on {card}")
    b = bench_batch.to(dev)
    S, n0 = b.num_segments_padded, b.graph.levels[0].num_padded
    for name, kw in MODE_GROUPS.items():
        model = build_mask3d(torch.bfloat16, seed=0, **kw).to(dev)
        cnt = reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(b, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = {k: fn.launches for k, fn in cnt.items()}
        want = dict(PER_FORWARD, segment_sum=0) \
            if kw.get("scatter_type") == "max" else PER_FORWARD
        shapes = {"pred_logits": (13, 1, 100, 3),
                  "pred_masks_seg": (13, 1, S, 100),
                  "pred_masks_vox": (1, n0, 100)}
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape or \
                    not torch.isfinite(out[key]).all():
                raise AssertionError(f"mode group {name}: {key} "
                                     f"{tuple(out[key].shape)} (expected "
                                     f"{shape}) or not finite")
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"mode group {name}: launches {got}")
        for k in launches:
            launches[k] += got[k]
        log(f"  mode group {name}: bf16 eval forward of the bench scene "
            f"{ms:.1f}ms (first call), outputs finite, shapes "
            f"{[tuple(out[k].shape) for k in shapes]}")
        del model, out
    log(f"phase train_options: {time.perf_counter() - t_phase:.1f}s")
    return launches


def _self_train_report(what, exp, t_build, t_fit):
    st, ev = exp.fit_stats, exp.eval_stats
    log(f"self-train {what}: build_experiment {t_build:.1f}s, fit "
        f"{t_fit:.1f}s ({len(st['step_ms'])} steps of batch "
        f"{exp.batch_size}: step ms {[round(x, 1) for x in st['step_ms']]}, "
        f"prefetch wait ms {[round(x, 1) for x in st['wait_ms']]}, epoch s "
        f"{[round(x, 2) for x in st['epoch_s']]}, checkpoint s "
        f"{[round(x, 2) for x in st['checkpoint_s']]}); validation "
        + _eval_split(ev))


def _eval_split(ev):
    return (f"{ev['scenes']} scenes in {ev['seconds']:.2f}s = "
            f"{ev['seconds'] / ev['scenes']:.3f} s per scene (host clock, "
            f"main thread: prefetch wait {ev['prefetch_wait_s']:.2f}s, "
            f"forward + pack + copy {ev['forward_and_pack_s']:.2f}s, wait "
            f"for the last tails {ev['tails_wait_s']:.2f}s, AP and box AP "
            f"{ev['ap_s']:.2f}s; the tails on 2 threads: post "
            f"{ev['tail_post_s']:.2f}s, boxes {ev['tail_boxes_s']:.2f}s, "
            f"exports {ev['tail_exports_s']:.2f}s)")


# ----------------------------------------------------------- the brick route
def brick_convs(backbone, levels, train=False):
    """k3 convs of one Res16UNet forward at `levels`, from
    models/backbone.py: the stem and block 8 at level 0, blocks 1 and 7 at
    level 1, 2 and 6 at 2, 3 and 5 at 3, block 4 at 4, two convs a block;
    with `train` the blocks' convs twice (remat recomputes each block in
    the backward; the stem is no block)."""
    n = backbone.layers
    blocks = {0: n[7], 1: n[0] + n[6], 2: n[1] + n[5], 3: n[2] + n[4],
              4: n[3]}
    per_block = 4 if train else 2
    return sum(per_block * blocks[lv] for lv in levels) + (0 in levels)


def _with_bricks(batch, levels):
    """The host batch with the brick tables of `levels` added, as the
    collator's `brick_levels` builds them (build_brick_graph over the
    level's padded coords), without collating the scenes again."""
    import dataclasses

    from unscene3d_torch.ops.brick_engine import build_brick_graph
    from unscene3d_torch.ops.sparse_graph import SparseGraph

    return dataclasses.replace(batch, graph=SparseGraph(tuple(
        dataclasses.replace(lv, brick=build_brick_graph(
            lv.coords.numpy(), lv.valid.numpy())) if i in levels else lv
        for i, lv in enumerate(batch.graph.levels))))


def _log_bricks(batch, levels, what):
    for lv in levels:
        level = batch.graph.levels[lv]
        bg, n = level.brick, int(level.valid.sum())
        cells = bg.nb_pad * 1008 * 128
        log(f"  {what} L{lv}: {n} voxels in {bg.nb_pad} bricks "
            f"({n / max(bg.nb_pad - 1, 1):.1f} voxels a brick, "
            f"{bg.occ.float().mean().item():.1%} of the cells occupied); "
            f"one (nb, 1008, 128) brick tensor {cells * 2 / 2**20:.0f} MiB "
            f"bf16, {cells * 4 / 2**20:.0f} MiB f32")


def phase_brick_route(dev, card):
    """The JAX collator's `brick_levels` through the eval entry point: the
    bench scene collated with brick_levels=(0, 1) (Predictor's collator)
    through Mask3D(Res16UNet34C) at conf/model/mask3d.yaml's widths, seeded
    weights, bf16 and f32, beside the same scene and weights on the gather
    route. Kernel 7's launches per forward equal the k3 convs of levels 0
    and 1 (models/backbone.py) and kernel 1's drop by as many; two runs
    bitwise equal; f32 outputs within SLICE_TOL of the gather route's,
    bf16 ones within BRICK_BF16_FACTOR x the gather route's own bf16-vs-f32
    spread; warm forwards, kernel 7's share of the traced device time."""
    from torch.profiler import ProfilerActivity

    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.inference import Predictor, build_mask3d

    t_phase = time.perf_counter()
    scene = make_scene(**BENCH_SCENE, seed=0)
    preds = {dt: Predictor(build_mask3d(dt, seed=0), dev, voxel_size=VOXEL)
             for dt in (torch.float32, torch.bfloat16)}
    brick = Predictor(preds[torch.float32].model, dev, voxel_size=VOXEL,
                      brick_levels=BRICK_LEVELS).collator
    t0 = time.perf_counter()
    batch, _ = brick([scene])
    t_brick = time.perf_counter() - t0
    t0 = time.perf_counter()
    gather, meta = preds[torch.float32].collator([scene])
    t_gather = time.perf_counter() - t0
    log(f"brick route: bench scene ({meta.num_voxels[0]} voxels) collate "
        f"with brick_levels={BRICK_LEVELS} {t_brick:.2f}s, without "
        f"{t_gather:.2f}s")
    _log_bricks(batch, BRICK_LEVELS, "bench scene")
    b, gb = batch.to(dev), gather.to(dev)
    n_brick = brick_convs(preds[torch.float32].model.backbone, BRICK_LEVELS)
    per = dict(PER_FORWARD, conv3_fwd=PER_FORWARD["conv3_fwd"] - n_brick,
               brick_conv3=n_brick)
    launches = dict.fromkeys(PER_FORWARD, 0)
    keys = ("backbone_features", "mask_features", "pred_logits",
            "pred_masks_seg", "pred_masks_vox")
    gather_out = {}
    for dt in (torch.float32, torch.bfloat16):
        model = preds[dt].model
        cnt = reset_counters()
        out = model(b)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in cnt.items()}
        if got != per:
            raise AssertionError(f"brick route {dt}: launches {got}, "
                                 f"expected {per}")
        for k in launches:
            launches[k] += got[k]
        again = model(b)
        if not all(torch.equal(out[k], again[k]) for k in keys):
            raise AssertionError(f"brick route {dt}: two runs differ")
        ref = model(gb)
        gather_out[dt] = {k: ref[k].float() for k in keys}
        errs = []
        for k in keys:
            a, r = out[k].float(), gather_out[dt][k]
            if not torch.isfinite(a).all() or a.shape != r.shape:
                raise AssertionError(f"brick route {dt} {k}: not finite or "
                                     f"shape {tuple(a.shape)}")
            err = (a - r).abs().max().item()
            if dt == torch.float32:
                tol = SLICE_TOL * max(r.abs().max().item(), 1e-6)
            else:
                tol = BRICK_BF16_FACTOR * (
                    r - gather_out[torch.float32][k]).abs().max().item()
            errs.append(f"{k} {err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"brick route {dt} {k}: {err} > {tol}")
        del out, again, ref
        warm = cuda_ms(lambda: model(b), reps=5, warmup=1)
        warm_g = cuda_ms(lambda: model(gb), reps=5, warmup=1)
        rows, busy, window = _traced(lambda: model(b),
                                     [ProfilerActivity.CUDA], reps=1)
        if rows:
            k7 = sum(r[0] for r in rows if "brick_conv_kernel" in r[1])
            share = (f"kernel 7 {k7:.1f}ms of {busy:.1f}ms device busy "
                     f"({k7 / busy:.1%}) in a {window:.1f}ms traced forward")
        else:
            share = "kernel 7's share not measured (no device time traced)"
        log(f"  brick route {str(dt)[6:]}: warm forward (median of 5) "
            f"{warm:.1f}ms, gather route {warm_g:.1f}ms on the same scene "
            f"and weights ({warm / warm_g:.2f}x); {share}; two runs bitwise "
            f"equal; launches {dict((k, v) for k, v in got.items() if v)}; "
            f"max abs err vs the gather route: {', '.join(errs)}; {card}")
    del preds, b, gb
    torch.cuda.empty_cache()
    log(f"phase brick_route (eval): {time.perf_counter() - t_phase:.1f}s")
    return launches


def phase_brick_train(dev, card, host_batch):
    """Training at a brick level: the train batch with brick_levels=(0,)
    through build_trainer(f32): one warm-up and one timed step with kernel
    7's launches (the level's k3 convs and remat's recomputes) and kernel
    1's asserted, then two steps from one state bitwise equal; beside
    phase_train_f32's step on the same batch."""
    from unscene3d_torch.train.loop import build_trainer

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    batch = _with_bricks(host_batch, BRICK_TRAIN_LEVELS)
    log(f"brick train: tables of level {BRICK_TRAIN_LEVELS} built in "
        f"{time.perf_counter() - t0:.2f}s")
    _log_bricks(batch, BRICK_TRAIN_LEVELS, "train batch")
    b = batch.to(dev)
    trainer = build_trainer(torch.float32, seed=0, device=dev)
    n_brick = brick_convs(trainer.model.backbone, BRICK_TRAIN_LEVELS,
                          train=True)
    per = dict(PER_TRAIN_STEP,
               conv3_fwd=PER_TRAIN_STEP["conv3_fwd"] - n_brick,
               brick_conv3=n_brick)
    gen = torch.Generator(device=dev).manual_seed(0)
    times, launches, peak = _timed_steps(trainer, b, gen, 2, per,
                                         "f32 brick_levels=(0,)")
    gather = ("gather route not measured in this run" if "f32" not in
              STEP_STATS else
              "gather route {:.1f}ms, peak {:.2f} GiB (phase_train_f32, same "
              "batch)".format(STEP_STATS["f32"][0],
                              STEP_STATS["f32"][1] / 2**30))
    log(f"brick train f32, batch {TRAIN_BATCH}, brick_levels="
        f"{BRICK_TRAIN_LEVELS}: step {times[1]:.1f}ms (first {times[0]:.1f})"
        f", peak device memory {peak / 2**30:.2f} GiB; {gather}; {card}")
    phase_train_repeat(dev, trainer, b, "f32 brick_levels=(0,)")
    del trainer, b
    torch.cuda.empty_cache()
    log(f"phase brick_train: {time.perf_counter() - t_phase:.1f}s")
    return launches


def phase_brick_entry(dev):
    """One train step through the entry point's functions with
    `data.collation_functions.train_collation.brick_levels=[0,1]` over
    scripts/unsupervised/train_unscene3d.sh's overrides, on
    phase_self_train's 8 scenes: the collator takes the levels, the batch
    carries the tables, the step's losses are finite and kernel 7 ran the
    k3 convs of levels 0 and 1."""
    import tempfile

    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _write_self_train_data(f"{tmp}/data")
        cfg = get_parameters(SELF_TRAIN_ROUND + [
            f"general.data_dir={tmp}/data",
            f"data.datasets.validation_dataset.data_dir={tmp}/data",
            f"data.datasets.test_dataset.data_dir={tmp}/data",
            f"general.save_dir={tmp}/run",
            "data.collation_functions.train_collation.brick_levels=[0,1]"])
        exp = build_experiment(cfg)
        try:
            if exp.collator.brick_levels != (0, 1) or exp.device != dev:
                raise AssertionError("brick entry: the override did not "
                                     "reach the collator")
            t0 = time.perf_counter()
            (batch,) = exp._collate_step(exp._load_scenes(
                [list(range(TRAIN_BATCH))]))
            t_collate = time.perf_counter() - t0
            have = [lv.brick is not None for lv in batch.graph.levels]
            if have != [True, True, False, False, False]:
                raise AssertionError(f"brick entry: tables at {have}")
            n_brick = brick_convs(exp.model.backbone, (0, 1), train=True)
            cnt = reset_counters()
            t0 = time.perf_counter()
            losses = exp.trainer.train_step(
                batch.to(dev), torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            exp.close()
    launches = {k: fn.launches for k, fn in cnt.items()}
    if launches["brick_conv3"] != n_brick or not all(
            torch.isfinite(losses[k]).all() for k in ("loss_ce", "loss_mask",
                                                      "loss_dice", "total")):
        raise AssertionError(f"brick entry: launches {launches}, losses "
                             f"{losses}")
    log(f"brick entry point: one f32 step of batch {TRAIN_BATCH} with "
        f"brick_levels=[0,1] {ms:.1f}ms (first step; collate "
        f"{t_collate:.1f}s), total={losses['total'].item():.4f}, launches "
        f"{dict((k, v) for k, v in launches.items() if v)}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    return launches


def phase_brick_parity(dev):
    """Card (kernel 7) vs CPU (its twin) on the parity scene, f32, same
    seeded weights, brick_levels=BRICK_PARITY_LEVELS: the forward and one
    train step (phase_train_parity's replayed decisions). Level 1 only, to
    bound the CPU side's time (a forward at levels 0 and 1, 1,280 + 256
    bricks, took most of a minute on the card's host); level 0 is held to
    the gather route on the card in phase_brick_route."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.inference import build_mask3d

    t_phase = time.perf_counter()
    scene = make_scene(num_points=30_000, num_objects=6, extent=4.0, seed=7)
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fine_buckets=True,
                                   fps_queries=100,
                                   brick_levels=BRICK_PARITY_LEVELS)([scene])
    model = build_mask3d(torch.float32, seed=0).to(dev)
    out_gpu = model(batch.to(dev))
    t0 = time.perf_counter()
    out_cpu = model.to("cpu")(batch)
    t_cpu = time.perf_counter() - t0
    del model
    for key in ("pred_logits", "pred_masks_seg", "pred_masks_vox"):
        a, r = out_gpu[key].float().cpu(), out_cpu[key].float()
        err = (a - r).abs().max().item()
        scale = max(r.abs().max().item(), 1e-6)
        log(f"  brick parity {key}: max_rel_err={err / scale:.3e} (tol "
            f"{SLICE_TOL:g})")
        if not err <= SLICE_TOL * scale:
            raise AssertionError(f"brick card vs CPU {key}: {err} > "
                                 f"{SLICE_TOL} * {scale}")
    log(f"brick parity forward: {meta.num_voxels[0]} voxels, "
        f"brick_levels={BRICK_PARITY_LEVELS}, the CPU forward {t_cpu:.1f}s")
    phase_train_parity(dev, brick_levels=BRICK_PARITY_LEVELS)
    log(f"phase brick_parity: {time.perf_counter() - t_phase:.1f}s")


# ------------------------------------------------------- MinkUNet / ResNet
def resunet_launches(model, train=False):
    """Kernel launches of one forward (and backward, with `train`) of a
    MinkUNet / ResNet (models/resunet.py). MinkUNet: the stem and 2 k3 convs
    a block (kernel 1), 3 k2 down + 3 up convs (kernel 2); ResNet: the stem,
    each stage's stride-2 block one stride-1 k3 conv and the others two
    (kernel 1), its k3 and k1 stride-2 convs (kernel 2, K = 27 and 1), the
    sum pool (kernel 2's sum). The backward: kernel 4's dx for every
    kernel-1 conv but the stem, kernel 5's dW for all, kernel 2 again for
    every kernel-2 conv's dx; the sum pool's dx is a gather."""
    from unscene3d_torch.models.resunet import MinkUNetBase

    n = model.layers
    if isinstance(model, MinkUNetBase):
        k3, k2, pool = 1 + 2 * sum(n), 6, 0
    else:
        k3, k2, pool = 1 + sum(2 * m - 1 for m in n), 2 * len(n), 1
    out = dict.fromkeys(PER_FORWARD, 0)
    out.update(conv3_fwd=k3, k_apply_gemm=k2, k_apply_sum=pool)
    if train:
        out.update(conv3_bwd=k3 - 1, conv3_dw=k3, k_apply_gemm=2 * k2)
    return out


def _resunet_input(scene):
    """A scene's collated features and its voxels' 6-level graph with the
    k3 stride-2 maps (ops/kernel_maps.py:build_sparse_graph, the collator's
    fine buckets: level 0's rows are the collated batch's)."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.ops.kernel_maps import build_sparse_graph
    from unscene3d_torch.ops.sparse_graph import graph_from_levels

    batch, _ = FreeMaskCollator(voxel_size=VOXEL, fine_buckets=True,
                                fps_queries=100)([scene])
    lv0 = batch.graph.levels[0]
    graph = graph_from_levels(build_sparse_graph(
        lv0.coords[lv0.valid].numpy(), num_levels=6, fine_buckets=True,
        build_down_nbr_maps=True))
    if graph.levels[0].num_padded != lv0.num_padded:
        raise AssertionError("resunet: level 0 rows differ from the batch's")
    return batch.features, graph


def phase_resunet(dev, card):
    """The MinkUNet / ResNet families at their default full widths
    (MinkUNet planes (64, 128, 256, 512, 256, 128, 128), init 64; ResNet
    (64, 128, 256, 512)), 20 classes, seeded weights, on the bench scene
    collated over 6 levels with the k3 stride-2 maps: ResUNet34 and
    ResNet34 eval forwards in bf16 and f32 (launches asserted, two runs
    bitwise equal), one f32 train forward + backward of each with
    CrossEntropyLoss on 20 seeded labels (launches, peak memory, two runs
    bitwise equal); kernel 2 at ResNet34's first K = 27 stride-2 conv and
    its transposed dx against the twin and the bound; card vs CPU of the
    f32 forwards on the parity scene."""
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.losses.criterion import CrossEntropyLoss
    from unscene3d_torch.models import load_model
    from unscene3d_torch.models.weights import init_random_
    from unscene3d_torch.ops.k_apply import k_apply, k_apply_plain

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    feats, graph = _resunet_input(make_scene(**BENCH_SCENE, seed=0))
    log(f"resunet: bench scene over 6 levels with the k3 stride-2 maps, "
        f"collate + graph {time.perf_counter() - t0:.2f}s, rows per level "
        f"{[lv.num_padded for lv in graph.levels]}")
    graph, feats = graph.to(dev), feats.to(dev)
    launches = dict.fromkeys(PER_FORWARD, 0)

    def count(fn, want, what):
        cnt = reset_counters()
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in cnt.items()}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for k in launches:
            launches[k] += got[k]
        return out

    for name in ("ResUNet34", "ResNet34"):
        for dt in (torch.float32, torch.bfloat16):
            model = init_random_(load_model(name)(RESUNET_CLASSES, dtype=dt),
                                 0).to(dev).eval()
            with torch.no_grad():
                fwd = lambda: model(feats, graph)  # noqa: E731
                out = count(fwd, resunet_launches(model), f"{name} {dt}")
                again = fwd()
                ms = cuda_ms(fwd, reps=5, warmup=1)
            rows = graph.levels[0 if name == "ResUNet34" else 5].num_padded
            if (tuple(out.shape) != (rows, RESUNET_CLASSES)
                    or not torch.isfinite(out).all()
                    or not torch.equal(out, again)):
                raise AssertionError(f"{name} {dt}: {tuple(out.shape)}, "
                                     "not finite or two runs differ")
            log(f"  {name} eval {str(dt)[6:]}: warm forward (median of 5) "
                f"{ms:.1f}ms, out {tuple(out.shape)}, two runs bitwise "
                f"equal; {card}")
            del model, out, again
        model = init_random_(load_model(name)(RESUNET_CLASSES), 0).to(
            dev).train()
        n_out = graph.levels[0 if name == "ResUNet34" else 5]
        g = torch.Generator().manual_seed(20)
        labels = torch.where(n_out.valid.cpu(),
                             torch.randint(0, RESUNET_CLASSES,
                                           (n_out.num_padded,), generator=g),
                             255).to(dev)
        params = list(model.parameters())

        def step():
            loss = CrossEntropyLoss()(model(feats, graph), labels)
            return loss, torch.autograd.grad(loss, params)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = count(step, resunet_launches(model, train=True),
                            f"{name} train")
        t0 = time.perf_counter()
        loss2, grads2 = step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        same = torch.equal(loss, loss2) and all(
            torch.equal(a, b) for a, b in zip(grads, grads2))
        if not (same and torch.isfinite(loss) and all(
                torch.isfinite(gr).all() for gr in grads)):
            raise AssertionError(f"{name} train: not finite or two runs "
                                 "differ")
        log(f"  {name} train f32 forward + backward with CrossEntropyLoss "
            f"({RESUNET_CLASSES} seeded labels): {ms:.1f}ms (second run), "
            f"loss {loss.item():.4f}, peak device memory "
            f"{peak / 2**30:.2f} GiB, two runs bitwise equal; {card}")
        del model, grads, grads2, params
        torch.cuda.empty_cache()

    # kernel 2 at ResNet34's first stride-2 conv (levels 1 -> 2, 64 -> 64)
    fine, coarse = graph.levels[1], graph.levels[2]
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(fine.num_padded, 64, generator=g).to(dev)
             * fine.valid[:, None]).to(dtype)
        w = (torch.randn(27, 64, 64, generator=g) / 8).to(dev, dtype)
        gm = (torch.randn(coarse.num_padded, 64, generator=g).to(dev)
              * coarse.valid[:, None]).to(dtype)
        wt = w.transpose(1, 2).contiguous()
        for what, inp, table, wk, valid in (
                ("fwd", x, coarse.down_nbr_idx, w, coarse.valid),
                ("dx", gm, coarse.down_nbr_t, wt, fine.valid)):
            pairs = hits(table)
            out_rows = table.shape[1]
            res[(what, dtype)] = _compare(
                f"k_apply_gemm K=27 stride-2 L1->L2 64->64 {what}", dtype,
                lambda: k_apply(inp, table, wk, valid),
                lambda: k_apply_plain(inp, table, wk, valid),
                # bytes: the table, the flags, the weights, each source row
                # the table points at read once, the output written once;
                # FLOPs over the valid pairs only
                work=(nbytes(table, valid, wk)
                      + (distinct_rows(table) + out_rows) * 64
                      * inp.element_size(),
                      2 * pairs * 64 * 64, dtype))
        del x, w, gm, wt

    pfeats, pgraph = _resunet_input(
        make_scene(num_points=30_000, num_objects=6, extent=4.0, seed=7))
    for name in ("ResUNet34", "ResNet34"):
        model = init_random_(load_model(name)(RESUNET_CLASSES), 0).eval()
        with torch.no_grad():
            cpu = model(pfeats, pgraph)
            gpu = model.to(dev)(pfeats.to(dev), pgraph.to(dev)).cpu()
        err = (gpu - cpu).abs().max().item()
        scale = max(cpu.abs().max().item(), 1e-6)
        log(f"  {name} parity (f32, {int(pgraph.levels[0].valid.sum())} "
            f"voxels): card vs "
            f"CPU max_rel_err={err / scale:.3e} (tol {SLICE_TOL:g})")
        if not err <= SLICE_TOL * scale:
            raise AssertionError(f"{name} card vs CPU: {err} > {SLICE_TOL} "
                                 f"* {scale}")
    log(f"phase resunet: {time.perf_counter() - t_phase:.1f}s")
    return launches, res


# -------------------------------------------------------------------- LSeg
def phase_lseg(dev, card):
    """LSeg at full width (ViT-L/16, DPT decoder, 512-d features) on seeded
    random weights: one frame at each of LSEG_FRAMES in f32, timed beside
    the f32 FLOP bound (torch.utils.flop_counter over the same call, at
    67 TFLOP/s), the features finite and of unit norm or less;
    relevance_maps against 20 seeded text embeddings; the tiny
    configuration on the card against the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    from unscene3d_torch.models.encoders_2d import load_2d_model

    t_phase = time.perf_counter()
    lseg = load_2d_model("LSegNet")
    g = torch.Generator().manual_seed(21)
    text = torch.randn(20, 512, generator=g)
    t0 = time.perf_counter()
    net = lseg(image_size=LSEG_FRAMES[0], text_embeddings=text, device=dev)
    n_params = sum(p.numel() for p in net.model.parameters())
    log(f"lseg: ViT-L/16 LSeg, {n_params / 1e6:.1f}M f32 params, seeded "
        f"random weights built in {time.perf_counter() - t0:.1f}s")
    for h, w in LSEG_FRAMES:
        img = torch.rand(1, h, w, 3, generator=g).to(dev)
        out = net(img)
        norm = torch.linalg.vector_norm(out, dim=-1)
        if (tuple(out.shape) != (1, h, w, 512) or not torch.isfinite(out).all()
                or not norm.max().item() <= 1 + 1e-5
                or not norm.min().item() > 0):
            raise AssertionError(f"lseg {h}x{w}: {tuple(out.shape)}, norms "
                                 f"{norm.min().item()}..{norm.max().item()}")
        ms = cuda_ms(lambda: net(img), reps=5, warmup=1)
        with FlopCounterMode(display=False) as fc:
            net(img)
        flops = fc.get_total_flops()
        bound = 1e3 * flops / PEAK_FLOPS[torch.float32]
        log(f"  lseg f32 {h}x{w}: {ms:.2f} ms a frame (CUDA events, median "
            f"of 5), f32 bound {bound:.3f} ms = {flops / 1e9:.1f} GFLOP / "
            f"67 TFLOP/s ({bound / ms:.1%} of it); features finite, norms "
            f"{norm.min().item():.3f}..{norm.max().item():.3f}; {card}")
    rel = net.relevance_maps(img)
    if tuple(rel.shape) != (1, h, w, 20) or not torch.isfinite(rel).all():
        raise AssertionError(f"lseg relevance maps {tuple(rel.shape)}")
    log(f"  relevance_maps over 20 text embeddings: {tuple(rel.shape)}, "
        f"logits {rel.min().item():.2f}..{rel.max().item():.2f}")
    del net, out, rel
    torch.cuda.empty_cache()
    img = torch.rand(2, 64, 96, 3, generator=g)
    card_out = lseg(image_size=(64, 96), tiny=True, seed=3,
                    device=dev).forward_multi_res(img[None].to(dev))
    cpu_out = lseg(image_size=(64, 96), tiny=True, seed=3,
                   device="cpu").forward_multi_res(img[None])
    errs = []
    for a, r in zip(card_out, cpu_out):
        err = (a.cpu() - r).abs().max().item()
        scale = max(r.abs().max().item(), 1e-6)
        errs.append(err / scale)
    log(f"  lseg tiny card vs CPU (out, 1/2, 1/4, 1/8): max_rel_err "
        f"{', '.join(f'{e:.2e}' for e in errs)} (tol {LSEG_TOL:g})")
    if not max(errs) <= LSEG_TOL:
        raise AssertionError(f"lseg tiny card vs CPU: {errs}")
    log(f"phase lseg: {time.perf_counter() - t_phase:.1f}s")


# --------------------------------------------------------------- renderers
def phase_renderers(dev, card):
    """Both renderers (pseudo/projection.py) on bench scene 0's voxels at
    FRAME from a ring camera, 32 seeded features a voxel: the
    nearest-voxel render and the interpolating one with its gradient to the
    features, each run twice bitwise equal, kernel 3's launches asserted
    (one per render, one more in the interpolating render's backward), and
    held to the same calls on the CPU (the twins), RENDER_TOL relative."""
    from unscene3d_torch.data.synthetic import ring_poses
    from unscene3d_torch.pseudo.projection import (
        render_voxels_to_image, render_voxels_to_image_interpolate)

    t_phase = time.perf_counter()
    s = _pseudo_scene(0)
    coords = s["coords"] - s["coords"].min(0)
    world = (coords.astype(np.float32) + 0.5) * VOXEL
    centre = (world.min(0) + world.max(0)) / 2
    pose = ring_poses(centre, 7.0, 2.5, 8)[0].astype(np.float32)
    K = _scannet_intrinsics(*FRAME).astype(np.float32)
    g = torch.Generator().manual_seed(22)
    n = len(coords)
    host = dict(feats=torch.randn(n, 32, generator=g),
                world=torch.from_numpy(world),
                coords=torch.from_numpy(coords.astype(np.int32)),
                valid=torch.ones(n, dtype=torch.bool),
                pose=torch.from_numpy(pose), K=torch.from_numpy(K),
                r=torch.randn(*FRAME, 32, generator=g))
    dims = tuple(int(d) + 2 for d in coords.max(0))

    def run(t):
        near = render_voxels_to_image(t["feats"], t["world"], t["valid"],
                                      t["pose"], t["K"], *FRAME)
        f = t["feats"].clone().requires_grad_()
        interp = render_voxels_to_image_interpolate(
            f, t["coords"], t["valid"], t["pose"], t["K"], *FRAME, dims,
            voxel_size=VOXEL)
        (interp[0] * t["r"]).sum().backward()
        return [near[0], near[1], *interp, f.grad]

    card_in = {k: v.to(dev) for k, v in host.items()}
    cnt = reset_counters()
    first = run(card_in)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in cnt.items()}
    if launches["segment_sum"] != 3 or sum(launches.values()) != 3:
        raise AssertionError(f"renderers: launches {launches}")
    again = run(card_in)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("renderers: two runs differ")
    ms = cuda_ms(lambda: run(card_in), reps=3, warmup=1)
    cpu = run(host)
    names = ("image", "hit", "interp image", "weights", "mapping", "grad")
    errs = []
    for i, (name, a, r) in enumerate(zip(names, first, cpu)):
        a, r = a.cpu().float(), r.float()
        err = (a - r).abs().max().item()
        scale = max(r.abs().max().item(), 1e-6)
        tol = RENDER_TOL if i < 2 else INTERP_TOL
        errs.append(f"{name} {err / scale:.2e} (tol {tol:g})")
        if not err <= tol * scale:
            raise AssertionError(f"renderers {name}: card vs CPU {err} > "
                                 f"{tol} * {scale}")
    hit = first[1].float().mean().item()
    covered = (first[3] > 0).float().mean().item()
    log(f"renderers on bench scene 0 ({n} voxels, grid {dims}, {FRAME[0]}x"
        f"{FRAME[1]}): both renders + the interpolating one's backward "
        f"{ms:.1f}ms (CUDA events, median of 3); {hit:.1%} of the pixels "
        f"hit (nearest), {covered:.1%} with weight (interpolating); two "
        f"runs bitwise equal; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}; card vs CPU "
        f"max_rel_err {', '.join(errs)}; {card}")
    log(f"phase renderers: {time.perf_counter() - t_phase:.1f}s")
    return launches


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev, card = phase_device()
    phase_build()
    if argv == ["--phase", "train_dp"]:
        # the data-parallel phase alone (on a machine of several cards too)
        phase_train_dp(dev, card, train_batch())
        return 0
    if argv in (["--phase", "supervised"], ["--phase", "eval_clis"],
                ["--phase", "resunet"], ["--phase", "lseg"],
                ["--phase", "renderers"]):
        {"supervised": phase_supervised, "eval_clis": phase_eval_clis,
         "resunet": phase_resunet, "lseg": phase_lseg,
         "renderers": phase_renderers}[argv[1]](dev, card)
        return 0
    if argv == ["--phase", "kernels"]:
        # kernels 1-5 at the table's shapes, each level's products over its
        # pairs, and the f32 train step (launches, bitwise repeat)
        from unscene3d_torch.data.collate import FreeMaskCollator
        from unscene3d_torch.data.synthetic import make_scene

        bench = [FreeMaskCollator(voxel_size=VOXEL, fine_buckets=True,
                                  fps_queries=100, csr_levels=c)(
            [make_scene(**BENCH_SCENE, seed=0)])[0] for c in ((), CSR_LEVELS)]
        phase_kernels(dev, *bench)
        phase_order_ratios(bench[0], "bench scene")
        del bench
        tbatch = train_batch()
        phase_order_ratios(tbatch, "train batch")
        phase_train_kernels(dev, tbatch, train_batch(CSR_LEVELS))
        torch.cuda.empty_cache()
        phase_train_f32(dev, tbatch.to(dev))
        return 0
    if argv == ["--phase", "brick_route"]:
        phase_brick_route(dev, card)
        phase_brick_train(dev, card, train_batch())
        phase_brick_entry(dev)
        phase_brick_parity(dev)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene

    scene0 = make_scene(**BENCH_SCENE, seed=0)
    batches = {}
    for csr_levels in ((), CSR_LEVELS):
        t0 = time.perf_counter()
        batches[csr_levels], _ = FreeMaskCollator(
            voxel_size=VOXEL, fine_buckets=True, fps_queries=100,
            csr_levels=csr_levels)([scene0])
        log(f"bench scene collate (csr_levels={csr_levels}): "
            f"{time.perf_counter() - t0:.2f}s")
    res = phase_kernels(dev, batches[()], batches[CSR_LEVELS])
    phase_order_ratios(batches[()], "bench scene")
    launches = {}
    launches["eval"], preds, served = phase_slice(dev)
    phase_profile(preds, served)
    phase_parity(dev, preds[torch.float32].model)
    del served
    res["brick_conv3"], launches["brick"] = phase_brick(dev, batches[()])
    proto_res, launches["proto"] = phase_proto(dev)
    res.update(proto_res)
    launches["eval_csr"] = phase_slice_csr(dev, scene0, preds)
    del preds
    torch.cuda.empty_cache()
    phase_pseudo_row(dev)
    launches["pseudo"] = phase_pseudo_pipeline(dev)
    phase_pseudo_parity(dev)
    launches["pseudo_both"] = phase_pseudo_both(dev, card)
    launches["pseudo_main"] = phase_pseudo_main(dev)

    tbatch = train_batch()
    tbatch_csr = train_batch(CSR_LEVELS)
    phase_order_ratios(tbatch, "train batch")
    for name, cases in phase_train_kernels(dev, tbatch, tbatch_csr).items():
        res.setdefault(name, {}).update(cases)
    res["csr_conv3"], dw_vs_csr = phase_csr_kernels(dev, batches[CSR_LEVELS],
                                                    tbatch_csr)
    tbatch_host, tbatch = tbatch, tbatch.to(dev)
    launches["train"], trainer, gen = phase_train(dev, tbatch)
    phase_train_repeat(dev, trainer, tbatch)
    phase_train_profile(trainer, tbatch, gen)
    del trainer
    torch.cuda.empty_cache()
    launches["train_f32"], f32_step_ms = phase_train_f32(dev, tbatch)
    del tbatch
    torch.cuda.empty_cache()
    launches["train_csr"] = phase_train_csr(dev, tbatch_csr.to(dev))
    del tbatch_csr
    torch.cuda.empty_cache()
    phase_train_parity(dev)
    torch.cuda.empty_cache()
    launches["self_train"] = phase_self_train(dev, card, f32_step_ms)
    torch.cuda.empty_cache()
    launches["train_dp"] = phase_train_dp(dev, card, tbatch_host)
    torch.cuda.empty_cache()
    launches["train_noise_robust"], nr_res = phase_train_noise_robust(
        dev, card, tbatch_host)
    torch.cuda.empty_cache()
    launches["brick_route"] = phase_brick_route(dev, card)
    launches["brick_train"] = phase_brick_train(dev, card, tbatch_host)
    launches["brick_entry"] = phase_brick_entry(dev)
    phase_brick_parity(dev)
    del tbatch_host
    launches["train_options"] = phase_train_options(dev, card, batches[()])
    torch.cuda.empty_cache()
    launches["supervised"] = phase_supervised(dev, card)
    phase_eval_clis(dev, card)
    torch.cuda.empty_cache()
    launches["resunet"], k27 = phase_resunet(dev, card)
    phase_lseg(dev, card)
    launches["renderers"] = phase_renderers(dev, card)

    main_case = {"conv3_fwd": (0, 128, 96, torch.bfloat16),
                 "k_apply_gemm": ("up", torch.bfloat16),
                 "k_apply_sum": ("bench", 0, 128, torch.float32),
                 "segment_sum": ("bench", torch.float32),
                 "conv3_bwd": (0, 128, 96, torch.bfloat16),
                 "conv3_dw": (0, 128, 96, torch.bfloat16),
                 "csr_conv3": (0, 128, 96, torch.bfloat16),
                 "brick_conv3": (96, torch.bfloat16),
                 "brick_conv_proto": (96, torch.bfloat16),
                 "win_decompose": "full"}
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        m = res[name][main_case[name]]
        per_path = {f"launches_{path}": n[name]
                    for path, n in launches.items()}
        if not sum(per_path.values()) > 0:
            raise AssertionError(f"{name}: launched on no path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(per_path.values()), **per_path,
            max_abs_err=max(r["max_abs_err"] for r in res[name].values()),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"]))
        if name == "segment_sum":   # the tri-plane projection's shapes
            for c, r in nr_res.items():
                kernels[-1].update({f"triplane_c{c}_{k}": r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms",
                    "max_abs_err")})
        if name == "k_apply_gemm":   # the K = 27 stride-2 conv and its dx
            for (what, dt), r in k27.items():
                kernels[-1].update({
                    f"k27_stride2_{what}_{str(dt)[6:]}_{k}": r[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "max_abs_err")})
        if name in ("csr_conv3", "win_decompose"):   # beside kernel 1
            kernels[-1].update(kernel1_ms=m["other_ms"])
        if name == "csr_conv3":
            log(f"kernel 6 (csr_conv3) bench L0 128->96 +res bf16: "
                f"{m['ms']:.3f} ms, kernel 1 {m['other_ms']:.3f} ms (ratio "
                f"{m['ms'] / m['other_ms']:.3f}), bound {m['bound_ms']:.4f}")
        if name == "conv3_dw":   # beside csr_dw (plain torch), same data
            csr_ms, k5_ms = dw_vs_csr[torch.bfloat16]
            kernels[-1].update(csr_dw_ms=csr_ms, ms_beside_csr_dw=k5_ms)
            log(f"kernel 5 (conv3_dw) train L0 128->96 bf16: {m['ms']:.3f} "
                f"ms, bound {m['bound_ms']:.4f}; on the csr_levels batch's "
                f"level 0 in this run: conv3_dw {k5_ms:.3f} ms, csr_dw "
                f"(plain torch over the pair tables) {csr_ms:.3f} ms")
    log(f"total {time.perf_counter() - T_START:.1f}s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
