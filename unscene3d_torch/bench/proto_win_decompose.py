"""Take the k3 conv's time apart on the card: kernel 9's five variants on the
bench scene's level 0 (counterpart of benchmarks/proto_win_decompose.py).

    VARIANTS="full no_onehot no_select no_gemm dma_only" CIN=128 GROUP=8 \\
        W_SUB=384 python3 -m unscene3d_torch.bench.proto_win_decompose

`full` is the conv read through the window tables (kernel 1 minus the
level's spilled pairs); no_select reads contiguous rows in place of the
scattered ones, no_onehot looks one column of the table up for every offset,
no_gemm adds the selected rows without multiplying them, dma_only keeps the
centre product alone. Only `full` is right; the others are wrong by
construction and are timed against it. Kernel 9 runs kernel 1's ring main
loop, so the variants split kernel 1's own body: scattered read, per-offset
lookup, products, centre. `harness` is the timing loop around nothing.
Kernel 1 (`conv3_fwd`) runs on the same x and w, and the level's
spilled-pair count is printed, so that the split reads against the kernel
the model runs. Times are CUDA events, median of 10, each run behind a spin
kernel (`bench/timing.py`, `spin=True`), kernel 1 on the same timer (the TPU
prototype chained 8 calls to defeat its compiler's caching; events need no
chain).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from unscene3d_torch.bench.timing import clock_name, device_ms
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops.conv3 import conv3_fwd, row_order
from unscene3d_torch.ops.kernel_maps import build_neighbor_map_padded
from unscene3d_torch.ops.sparse_graph import bucket_size
from unscene3d_torch.ops.win_decompose import (VARIANTS, WinTables,
                                               win_conv_variant)
from unscene3d_torch.ops.win_graph import TILE, WinGraph, build_win_graph
from unscene3d_torch.runtime import resolve_device

BENCH_SCENE = dict(num_points=250_000, num_objects=12, extent=8.0, seed=0)


@dataclasses.dataclass
class Case:
    """One level's inputs of the prototype, tensors on the device."""

    x: torch.Tensor          # (n_pad, Cin) bf16, noise on every row
    w: torch.Tensor          # (27, Cin, Cout) bf16
    tables: WinTables
    graph: WinGraph          # the numpy tables, spills included
    nbr_idx: torch.Tensor    # (27, n_pad) int32
    valid: torch.Tensor      # (n_pad,) bool


def build_case(device, cin: int = 128, group: int = 8, w_sub: int = 384,
               scene: dict | None = None, voxel_size: float = 0.02) -> Case:
    """Level 0 of the scene, padded to a multiple of 256 x group rows as a
    window level is, with its window tables (w_union = 4096 + (g - 1) 256)
    and seeded noise for x (every row, padding included) and w."""
    batch, _ = FreeMaskCollator(voxel_size=voxel_size, fine_buckets=True)(
        [make_scene(**(scene or BENCH_SCENE))])
    lvl = batch.graph.levels[0]
    coords = lvl.coords[lvl.valid].numpy()
    n_pad = bucket_size(len(coords) + 1, fine=True, align=TILE * group)
    nbr = build_neighbor_map_padded(coords, n_pad)
    wg = build_win_graph(nbr, n_pad, w_sub=w_sub,
                         w_union=4096 + (group - 1) * TILE, group=group)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(n_pad, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(27, cin, cin) * 0.05).astype(np.float32))
    return Case(x=x.to(device, torch.bfloat16), w=w.to(device, torch.bfloat16),
                tables=WinTables.from_graph(wg).to(device), graph=wg,
                nbr_idx=torch.from_numpy(nbr).to(device),
                valid=(torch.arange(n_pad) < len(coords)).to(device))


def run(device="cuda", variants=VARIANTS, cin: int = 128, group: int = 8,
        w_sub: int = 384, scene: dict | None = None, reps: int = 10,
        harness: bool = False, case: Case | None = None, log=print) -> dict:
    """Time the variants (and kernel 1) at the scene's level 0. Returns
    {"rows", "spilled_pairs", "ms": {name: ms}, "clock"}."""
    device = resolve_device(device)
    if case is None:
        case = build_case(device, cin, group, w_sub, scene)
    wg = case.graph
    log(f"level 0: {case.x.shape[0]} rows, Cin = Cout = {case.x.shape[1]}, "
        f"group {wg.group}, w_sub {wg.w_sub}, w_union {wg.w_union}, "
        f"{wg.num_spills} spilled pairs ({clock_name(device)})")
    ms = {}
    if harness:
        ms["harness"] = device_ms(lambda: None, device, reps, spin=True)
    for variant in variants:
        ms[variant] = device_ms(
            lambda: win_conv_variant(case.x, case.w, case.tables, variant),
            device, reps, spin=True)
    order = row_order(case.nbr_idx)
    ms["conv3_fwd"] = device_ms(
        lambda: conv3_fwd(case.x, case.w, case.nbr_idx, case.valid,
                          order=order), device, reps, spin=True)
    for name, t in ms.items():
        log(f"{name:>10}: {t:.3f}ms")
    return dict(rows=case.x.shape[0], spilled_pairs=wg.num_spills, ms=ms,
                clock=clock_name(device))


def main():
    variants = os.environ.get("VARIANTS", " ".join(VARIANTS)).split()
    harness = "harness" in variants
    if harness:
        variants.remove("harness")
    run("cuda", variants, cin=int(os.environ.get("CIN", 128)),
        group=int(os.environ.get("GROUP", 8)),
        w_sub=int(os.environ.get("W_SUB", 384)), harness=harness)


if __name__ == "__main__":
    main()
