"""Static sparse topology of one collated batch, as plain dataclasses of
tensors (counterpart of unscene3d_tpu/ops/sparse_graph.py).

The host builds the whole multi-level topology once per batch (ops/
kernel_maps.py) and pads every level to a bucketed size; the kernels then
read the maps directly. Levels: 0 = stride 1 ... 4 = stride 16. A level
named in the collator's `csr_levels` also carries the valid-pair tables of
kernel 6 (ops/csr_conv.py:CsrGraph), one named in `brick_levels` the brick
tables of kernel 7 (ops/brick_engine.py:BrickGraph), and with
`build_down_nbr_maps` every level but the finest the k3 stride-2 maps of the
MinkUNet / ResNet families. The window tables of the JAX package exist only
for the TPU compiler and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from unscene3d_torch.ops.csr_conv import CsrGraph

if TYPE_CHECKING:
    from unscene3d_torch.ops.brick_engine import BrickGraph
    from unscene3d_torch.ops.conv3 import RowOrder


@dataclasses.dataclass
class LevelGraph:
    """Topology of one resolution level, padded to N rows.

    Missing neighbours, children and parents point at the respective level's
    LAST row, which bucketing guarantees to be padding."""

    coords: torch.Tensor         # (N, 4) int32 [batch, x, y, z] unit coords
    valid: torch.Tensor          # (N,) bool
    nbr_idx: torch.Tensor        # (27, N) int32, offsets z-fastest, centre 13
    child_idx: torch.Tensor      # (8, N) int32 rows of the finer level
    parent_idx: torch.Tensor     # (N,) int32 row of the coarser level
    parent_offset: torch.Tensor  # (N,) int32 k2 offset id in [0, 8)
    finer_num_padded: int = 0    # padded rows of the finer level (static)
    # (8, N) int32 rows of the coarser level, one-hot by parent_offset: the
    # up2 conv's gather tables (None at the coarsest level)
    up_idx: torch.Tensor | None = None
    # valid-pair tables of the level's k3 topology: with them every k3 conv
    # of the level runs through kernel 6 instead of kernel 1
    csr: CsrGraph | None = None
    # the level's halo'd 8^3 bricks: with them every k3 conv of the level
    # runs through kernel 7 (ops/conv_ops.py:sparse_conv3)
    brick: "BrickGraph | None" = None
    # k3 STRIDE-2 maps (MinkUNet / ResNet stage convs), on the coarse level:
    # (27, N) int32 rows of the finer level at 2 * coord + offset (misses
    # finer_num_padded - 1), and their transpose (27, finer_num_padded)
    # int32 rows of this level (misses N - 1), the gather table of the dx
    down_nbr_idx: torch.Tensor | None = None
    down_nbr_t: torch.Tensor | None = None
    # the order kernel 1 and 4's dx walk the rows in, built from nbr_idx by
    # the level's first k3 conv on that route (ops/conv3.py:level_order)
    order: "RowOrder | None" = None

    @property
    def num_padded(self) -> int:
        return self.coords.shape[0]

    @property
    def child_valid(self) -> torch.Tensor:
        return self.child_idx != (self.finer_num_padded - 1)

    @property
    def down_nbr_valid(self) -> torch.Tensor:
        return self.down_nbr_idx != (self.finer_num_padded - 1)

    def to(self, device, non_blocking: bool = False) -> "LevelGraph":
        """Every tensor and table of the level on `device` (the ints and the
        absent tables stay as they are)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)
            if hasattr(getattr(self, f.name), "to")})


@dataclasses.dataclass
class SparseGraph:
    """Full multi-level topology of one collated batch."""

    levels: tuple[LevelGraph, ...]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def to(self, device, non_blocking: bool = False) -> "SparseGraph":
        return SparseGraph(tuple(lv.to(device, non_blocking)
                                 for lv in self.levels))


def graph_from_levels(levels: list[dict]) -> SparseGraph:
    """The level dicts of ops/kernel_maps.py:build_sparse_graph (numpy) as a
    SparseGraph of CPU tensors."""
    t = torch.from_numpy
    return SparseGraph(tuple(
        LevelGraph(coords=t(lv["coords"]), valid=t(lv["valid"]),
                   nbr_idx=t(lv["nbr_idx"]), child_idx=t(lv["child_idx"]),
                   parent_idx=t(lv["parent_idx"]),
                   parent_offset=t(lv["parent_offset"]),
                   finer_num_padded=lv["finer_num_padded"],
                   up_idx=None if lv["up_idx"] is None else t(lv["up_idx"]),
                   csr=lv["csr"], brick=lv.get("brick"),
                   down_nbr_idx=_opt(lv.get("down_nbr_idx")),
                   down_nbr_t=_opt(lv.get("down_nbr_t")))
        for lv in levels))


def _opt(a):
    return None if a is None else torch.from_numpy(a)


def bucket_size(n: int, align: int = 128, min_size: int = 256,
                fine: bool = False) -> int:
    """Round n up to a geometric bucket (unscene3d_tpu/ops/sparse_graph.py):
    {1, 1.25, 1.5, 1.75} * 2^k, or sixteenth steps with `fine=True`,
    aligned to `align`."""
    n = max(int(n), 1)
    target = max(n, min_size)
    p = 1
    while p < target:
        p <<= 1
    if p == target:
        size = p
    else:
        half = p >> 1
        size = p
        steps = [i / 16.0 for i in range(17)] if fine else (1.25, 1.5, 1.75)
        for frac in steps:
            cand = int(half * (1.0 + frac)) if fine else int(half * frac)
            if cand >= target:
                size = cand
                break
    return ((size + align - 1) // align) * align
