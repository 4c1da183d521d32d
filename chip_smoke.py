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
contract) and one request through the DBSCAN route.

    python3 chip_smoke.py

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
# the pseudo row of bench.py: scenes x segments x features
PSEUDO_ROW = dict(batch_scenes=64, num_segments=400)
EIGH_SCENES = 16         # scenes of the row timed with the exact solver
NCUT_PARITY_SCENES = 8   # card-vs-CPU NCut scenes (f32)
# planted-object recovery of cholinv against eigh, the reference's own
# acceptance criterion (tests/test_ncut_solver_agreement.py): within 0.10
RECOVERY_TOL = 0.10


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
    for fn in cnt.values():
        fn.launches = 0
    return cnt


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped): each input read once, each
    output written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def hits(table) -> int:
    """Entries of a neighbour / child / parent map that are no miss (misses
    point at the map's largest row)."""
    return int((table != table.max()).sum().item())


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
    from unscene3d_torch.ops.conv3 import conv3_fwd, conv3_fwd_plain
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
            res["conv3_fwd"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_fwd L{lv} {cin}->{cout}"
                + (" +scale/shift+res+relu" if epi else " +scale/shift+relu"),
                dtype,
                lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw),
                lambda: conv3_fwd_plain(x, w, lvl.nbr_idx, lvl.valid, **kw),
                work=(nbytes(x, w, lvl.nbr_idx, lvl.valid, kw["scale"],
                             kw["shift"], kw.get("residual"))
                      + n * cout * x.element_size(),
                      2 * hits(lvl.nbr_idx) * cin * cout, dtype),
                other=k6, equal_rows=lvl.valid)
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
                                           flip_transpose)
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
            pairs = hits(lvl.nbr_idx)
            k6 = None
            if lv in csr:
                k6 = ("csr_conv3 as dx", lambda: csr_conv3_fwd(
                    gm, flip_transpose(w), csr[lv], lvl.valid))
            res["conv3_bwd"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_bwd (dx + dW) L{lv} {cin}->{cout}, dx", dtype,
                lambda: conv3_bwd(*args)[0],
                lambda: conv3_bwd_plain(*args)[0],
                work=(nbytes(x, x, gm, w, w, lvl.nbr_idx, lvl.valid),
                      4 * pairs * cin * cout, dtype),
                other=k6, equal_rows=lvl.valid)
            res["conv3_dw"][(lv, cin, cout, dtype)] = _compare(
                f"conv3_dw L{lv} {cin}->{cout} (f32 out)", dtype,
                lambda: conv3_dw(x, gm, lvl.nbr_idx),
                lambda: conv3_dw_plain(x, gm, lvl.nbr_idx),
                tol=DW_TOL[dtype],
                work=(nbytes(x, gm, lvl.nbr_idx) + 27 * cin * cout * 4,
                      2 * pairs * cin * cout, dtype))
            del x, w, gm, args, k6
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
    log(f"{what} train path: {n_steps} steps, launches {launches}")
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
                                           flip_transpose)
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
                other=("conv3_fwd", lambda: conv3_fwd(x, w, lvl.nbr_idx,
                                                      lvl.valid, **kw)),
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
            other=("conv3_fwd", lambda: conv3_fwd(gm, wf, lvl.nbr_idx,
                                                  lvl.valid)),
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
    from unscene3d_torch.ops.conv3 import conv3_fwd

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
            ref = conv3_fwd(x, w, lvl.nbr_idx, lvl.valid)
            err = (flat.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            eng_ms = cuda_ms(lambda: be.disassemble(
                be.brick_conv3(be.assemble(x, bg), w, bg), bg, lvl), reps=5)
            k1_ms = cuda_ms(lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid),
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
        ref = conv3_fwd(conv3_fwd(x, w1, lvl.nbr_idx, lvl.valid), w2,
                        lvl.nbr_idx, lvl.valid)
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
    log(f"phase train_f32: {time.perf_counter() - t_phase:.1f}s")
    return launches


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
    from unscene3d_torch.ops.conv3 import conv3_fwd
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
    for v in VARIANTS:
        vs_k1 = {} if v != "full" else dict(
            other=("conv3_fwd",
                   lambda: conv3_fwd(x, w, wcase.nbr_idx, wcase.valid)),
            equal_rows=k1_rows, other_rows=k1_rows)
        res["win_decompose"][v] = _compare(
            f"win_decompose {v} L0 {cin}->{cout}", bf16,
            lambda: win_conv_variant(x, w, tb, v),
            lambda: win_conv_variant_plain(x, w, tb, v),
            work=(*work[v], bf16), **vs_k1)
    full = win_conv_variant(x, w, tb, "full").float()
    k1 = conv3_fwd(x, w, wcase.nbr_idx, wcase.valid).float()
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


def phase_pseudo_pipeline(dev):
    """The bench scene through PseudoMaskPipeline(modality="geom") at full
    width (Res16UNet34C, seeded random weights, res_2 features), bf16 and
    f32: launch counts read around exactly the first call of each, masks
    (P, K) bool over the full cloud, a second call timed by stage. The CSC
    graph's k3 maps come from the native library (asserted)."""
    from unscene3d_torch import native
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.ops.hashing import sparse_quantize
    from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline

    raw = make_scene(**BENCH_SCENE, seed=0)
    t0 = time.perf_counter()
    vox, umap, _ = sparse_quantize(raw["xyz"], VOXEL)
    seg = raw["segments"][umap]
    uniq = np.unique(seg)
    conn = np.column_stack([uniq[:-1], uniq[1:]])
    scene = dict(scene_name="bench0", coords=vox,
                 feats=raw["features"][umap] - 0.5, segment_ids=[seg],
                 segment_connectivity=[np.vstack([conn, conn[:, ::-1]])],
                 full_coords=raw["xyz"])
    log(f"pseudo pipeline scene: {len(raw['xyz'])} points, {len(vox)} "
        f"voxels, {len(uniq)} segments (quantize "
        f"{time.perf_counter() - t0:.2f}s)")
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
                or masks.shape[0] != len(raw["xyz"]) or masks.shape[1] < 1
                or cloud.shape != raw["xyz"].shape):
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

    tbatch = train_batch()
    tbatch_csr = train_batch(CSR_LEVELS)
    for name, cases in phase_train_kernels(dev, tbatch, tbatch_csr).items():
        res.setdefault(name, {}).update(cases)
    res["csr_conv3"], dw_vs_csr = phase_csr_kernels(dev, batches[CSR_LEVELS],
                                                    tbatch_csr)
    tbatch = tbatch.to(dev)
    launches["train"], trainer, gen = phase_train(dev, tbatch)
    phase_train_repeat(dev, trainer, tbatch)
    phase_train_profile(trainer, tbatch, gen)
    del trainer
    torch.cuda.empty_cache()
    launches["train_f32"] = phase_train_f32(dev, tbatch)
    del tbatch
    torch.cuda.empty_cache()
    launches["train_csr"] = phase_train_csr(dev, tbatch_csr.to(dev))
    del tbatch_csr
    torch.cuda.empty_cache()
    phase_train_parity(dev)

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
    sys.exit(main())
