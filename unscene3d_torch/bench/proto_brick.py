"""Prototype and microbenchmark of the dense brick shift-GEMM conv (kernel 8)
against the gather conv (kernel 1) on the bench scene's level-0 topology
(counterpart of benchmarks/proto_brick_pallas.py).

    python3 -m unscene3d_torch.bench.proto_brick

Host side, its own code as in the prototype: the level's voxels are sorted
by (Morton key of their 8^3 brick, cell id), each brick's 26 neighbour
bricks and the row window of the sorted array that covers them are found,
and an assemble map names, for each of the 10^3 halo'd cells of each brick,
the sorted voxel that sits there. On the device: the assembly gather, the
gather conv 96 -> 96 (kernel 1, where the prototype timed XLA's gather conv)
and the brick conv (kernel 8) are timed, and kernel 8's rows at the real
voxels are held against kernel 1's (asserted; the prototype only printed).
The prototype wrote the sorted features into the level's rows unpermuted, so
its printed error compared two different inputs; here every voxel's feature
sits at its own row.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from unscene3d_torch.bench.timing import clock_name, device_ms
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops.brick_engine import CELLS
from unscene3d_torch.ops.conv3 import conv3_fwd, row_order
from unscene3d_torch.ops.hashing import CoordHashTable
from unscene3d_torch.ops.kernel_maps import KERNEL3_OFFSETS
from unscene3d_torch.ops.proto_brick import proto_brick_conv
from unscene3d_torch.runtime import resolve_device

BENCH_SCENE = dict(num_points=250_000, num_objects=12, extent=8.0, seed=0)
# kernel 8 against kernel 1 at the real voxels, relative to max|kernel 1|:
# both sum the same bf16 products in f32 and round once (one bf16 ulp)
REL_TOL = 8e-3


def morton3(c: np.ndarray) -> np.ndarray:
    """Morton key of (n, 3) non-negative coordinates, 16 bits per axis."""
    c = c.astype(np.uint64)
    out = np.zeros(len(c), np.uint64)
    for b in range(16):
        for d in range(3):
            out |= (((c[:, d] >> np.uint64(b)) & np.uint64(1))
                    << np.uint64(3 * b + (2 - d)))
    return out


def brick_order(real: np.ndarray) -> dict:
    """Voxels (n, 3) sorted by (brick Morton key, cell id). Returns the
    sort `order`, each sorted voxel's brick `own_brick` and 8^3 cell id
    `cell`, the bricks' coords `ubrick` and keys `uniq` in Morton order, and
    each brick's row range [starts, ends) in the sorted array."""
    brick_coord = real >> 3
    uniq, inv = np.unique(morton3(brick_coord), return_inverse=True)
    inv = inv.reshape(-1)
    nb = len(uniq)
    local = real - (brick_coord << 3)
    cell = local[:, 0] * 64 + local[:, 1] * 8 + local[:, 2]
    order = np.lexsort((cell, inv))
    own_brick = inv[order]
    ubrick = np.zeros((nb, 3), np.int64)
    ubrick[own_brick] = brick_coord[order]
    return dict(order=order, own_brick=own_brick, cell=cell[order],
                ubrick=ubrick, uniq=uniq,
                starts=np.searchsorted(own_brick, np.arange(nb)),
                ends=np.searchsorted(own_brick, np.arange(nb), side="right"))


def neighbour_bricks(ubrick: np.ndarray, uniq: np.ndarray) -> np.ndarray:
    """(nb, 27) neighbour brick ids, -1 where there is none (the
    prototype's dict lookup, as one searchsorted per offset)."""
    nbr_ids = np.full((len(ubrick), 27), -1, np.int64)
    for k, off in enumerate(KERNEL3_OFFSETS):
        nc = ubrick + off
        ok = (nc >= 0).all(1)
        nk = morton3(np.maximum(nc, 0))
        pos = np.minimum(np.searchsorted(uniq, nk), len(uniq) - 1)
        nbr_ids[:, k] = np.where(ok & (uniq[pos] == nk), pos, -1)
    return nbr_ids


def window_stats(nbr_ids, starts, ends) -> np.ndarray:
    """Rows of the sorted array from the first voxel of any neighbour brick
    to the last, per brick."""
    has = nbr_ids >= 0
    ids = np.where(has, nbr_ids, 0)
    wlo = np.where(has, starts[ids], np.iinfo(np.int64).max).min(1)
    whi = np.where(has, ends[ids], 0).max(1)
    return whi - wlo


def assemble_map(sorted_coords: np.ndarray, ubrick: np.ndarray) -> np.ndarray:
    """(nb, 1008) int64: the sorted voxel in each halo'd cell (x, y, z in
    [-1, 9), flat id (x+1)*100 + (y+1)*10 + (z+1)); empty cells and the 8
    pad rows hold n, the index of a zero row."""
    n, nb = len(sorted_coords), len(ubrick)
    rng = np.arange(-1, 9)
    cell_coords = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                           -1).reshape(-1, 3)
    tbl = CoordHashTable(np.column_stack([np.zeros(n, np.int64),
                                          sorted_coords]))
    asm = np.full((nb, CELLS), n, np.int64)
    base = ubrick << 3
    for ci in range(0, 1000, 250):
        q = (base[:, None, :] + cell_coords[None, ci:ci + 250, :]).reshape(
            -1, 3)
        idx, found = tbl.lookup(np.column_stack(
            [np.zeros(len(q), np.int64), q]))
        asm[:, ci:ci + 250] = np.where(found, idx, n).reshape(nb, -1)
    return asm


@dataclasses.dataclass
class Case:
    """The prototype's inputs on the device and the host tables behind
    them."""

    g: torch.Tensor          # (nb, 1008, C) assembled bricks, bf16
    w: torch.Tensor          # (27, C, C) bf16
    xpad: torch.Tensor       # (n + 1, C) sorted voxel features + a zero row
    asm: torch.Tensor        # (nb, 1008) int32 assemble map, n = empty
    xfull: torch.Tensor      # (n_pad, C) every voxel's feature at its row
    nbr_idx: torch.Tensor    # (27, n_pad) int32 of the level
    valid: torch.Tensor      # (n_pad,) bool
    order: torch.Tensor      # (n,) sorted position -> valid row
    own_brick: torch.Tensor  # (n,) brick of each sorted voxel
    interior: torch.Tensor   # (n,) its flat cell id in the halo'd brick
    stats: dict              # counts of the host decomposition


def build_case(device, channels: int = 96, scene: dict | None = None,
               voxel_size: float = 0.02, log=print) -> Case:
    """Level 0 of the scene in Morton-ordered bricks, with seeded noise for
    the features and the weights."""
    batch, _ = FreeMaskCollator(voxel_size=voxel_size)(
        [make_scene(**(scene or BENCH_SCENE))])
    lvl = batch.graph.levels[0]
    real = lvl.coords.numpy()[lvl.valid.numpy()][:, 1:].astype(np.int64)
    n, n_pad = len(real), lvl.num_padded
    log(f"N={n} n_pad={n_pad}")

    t0 = time.perf_counter()
    bo = brick_order(real)
    nb = len(bo["ubrick"])
    log(f"bricks={nb} avg voxels/brick={n / nb:.1f} "
        f"occupancy={n / (nb * 512):.2f}")
    nbr_ids = neighbour_bricks(bo["ubrick"], bo["uniq"])
    wsize = window_stats(nbr_ids, bo["starts"], bo["ends"])
    log(f"window rows: mean={wsize.mean():.0f} "
        f"p95={np.percentile(wsize, 95):.0f} max={wsize.max()}  "
        f"(host prep {time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    asm = assemble_map(real[bo["order"]], bo["ubrick"])
    log(f"assemble-map host build {time.perf_counter() - t0:.2f}s")

    rng = np.random.default_rng(0)
    c = channels
    xs = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(
        device, torch.bfloat16)                  # features, sorted order
    w = torch.from_numpy(
        (rng.normal(size=(27, c, c)) * 0.1).astype(np.float32)).to(
            device, torch.bfloat16)
    xpad = torch.cat([xs, torch.zeros(1, c, dtype=xs.dtype, device=device)])
    asm_d = torch.from_numpy(asm.astype(np.int32)).to(device)
    # every voxel's feature at its own row of the level
    order = torch.from_numpy(bo["order"]).to(device)
    xfull = torch.zeros(n_pad, c, dtype=xs.dtype, device=device)
    xfull[torch.nonzero(lvl.valid).reshape(-1).to(device)[order]] = xs
    cell = bo["cell"]
    interior = ((cell // 64 + 1) * 100 + ((cell // 8) % 8 + 1) * 10
                + cell % 8 + 1)
    return Case(
        g=xpad[asm_d.reshape(-1).long()].reshape(nb, CELLS, c), w=w,
        xpad=xpad, asm=asm_d, xfull=xfull, nbr_idx=lvl.nbr_idx.to(device),
        valid=lvl.valid.to(device), order=order,
        own_brick=torch.from_numpy(bo["own_brick"]).to(device),
        interior=torch.from_numpy(interior).to(device),
        stats=dict(voxels=n, bricks=nb, occupancy=n / (nb * 512),
                   window_rows_mean=float(wsize.mean()),
                   window_rows_max=int(wsize.max())))


def run(device="cuda", channels: int = 96, scene: dict | None = None,
        voxel_size: float = 0.02, reps: int = 6, case: Case | None = None,
        log=print) -> dict:
    """The prototype on `device`. Returns its counts, times (ms) and the
    error of kernel 8 against kernel 1 at the real voxels."""
    device = resolve_device(device)
    log(f"brick prototype on {device} ({clock_name(device)})")
    if case is None:
        case = build_case(device, channels, scene, voxel_size, log)
    g, w = case.g, case.w
    nb, _, c = g.shape
    rows = case.asm.reshape(-1).long()
    ms = {"assembly_gather": device_ms(lambda: case.xpad[rows], device, reps)}
    log(f"assembly gather (nb*1008 rows): {ms['assembly_gather']:.3f}ms")
    k1_order = row_order(case.nbr_idx)
    ms["conv3_fwd"] = device_ms(
        lambda: conv3_fwd(case.xfull, w, case.nbr_idx, case.valid,
                          order=k1_order), device, reps)
    log(f"gather conv (kernel 1) {c}->{c}: {ms['conv3_fwd']:.3f}ms")
    ms["brick_conv_proto"] = device_ms(lambda: proto_brick_conv(g, w),
                                       device, reps)
    log(f"brick conv (kernel 8) {c}->{c} (nb={nb}): "
        f"{ms['brick_conv_proto']:.3f}ms")

    # kernel 8's rows at the real voxels against kernel 1's
    got = proto_brick_conv(g, w)[case.own_brick, case.interior].float()
    ref = conv3_fwd(case.xfull, w, case.nbr_idx, case.valid,
                    order=k1_order)[case.valid][case.order].float()
    err = (got - ref).abs().max().item()
    rel = err / (ref.abs().max().item() + 1e-6)
    log(f"brick-vs-gather max abs err {err:.4f} rel {rel:.5f} "
        f"(tol {REL_TOL:g})")
    if not rel <= REL_TOL:
        raise AssertionError(f"kernel 8 vs kernel 1 at the real voxels: "
                             f"rel err {rel} > {REL_TOL}")
    return dict(case.stats, ms=ms, max_abs_err=err, max_rel_err=rel,
                clock=clock_name(device))


def main():
    run("cuda")


if __name__ == "__main__":
    main()
