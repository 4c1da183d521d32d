"""Static sparse topology of one collated batch, as plain dataclasses of
tensors (counterpart of unscene3d_tpu/ops/sparse_graph.py).

The host builds the whole multi-level topology once per batch (ops/
kernel_maps.py) and pads every level to a bucketed size; the kernels then
read the maps directly. Levels: 0 = stride 1 ... 4 = stride 16. A level
named in the collator's `csr_levels` also carries the valid-pair tables of
kernel 6 (ops/csr_conv.py:CsrGraph); the brick tables of kernel 7 are built
apart from the batch (ops/brick_engine.py:build_brick_graph). The window
tables of the JAX package exist only for the TPU compiler and have no
counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from unscene3d_torch.ops.csr_conv import CsrGraph


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

    @property
    def num_padded(self) -> int:
        return self.coords.shape[0]

    @property
    def child_valid(self) -> torch.Tensor:
        return self.child_idx != (self.finer_num_padded - 1)

    def to(self, device, non_blocking: bool = False) -> "LevelGraph":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, CsrGraph))})


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
