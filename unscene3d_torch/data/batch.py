"""Collated batch as a dataclass of tensors (counterpart of
unscene3d_tpu/data/batch.py:SceneBatch and Targets; no triplane maps).

Scenes are concatenated into flat padded arrays; per-scene decomposition goes
through precomputed gather tables. `to(device)` moves every tensor, the
targets included."""

from __future__ import annotations

import dataclasses

import torch

from unscene3d_torch.ops.sparse_graph import SparseGraph


@dataclasses.dataclass
class Targets:
    """Instance targets, padded to T instances per scene
    (unscene3d_tpu/data/batch.py:Targets)."""

    labels: torch.Tensor      # (B, T) int32 class ids
    valid: torch.Tensor       # (B, T) bool
    seg_masks: torch.Tensor   # (B, T, S) bool per-instance segment membership
    vox_masks: torch.Tensor   # (N0, T) bool per-instance voxel masks, rows
    #                           live only inside the owning scene's row range

    def to(self, device, non_blocking: bool = False) -> "Targets":
        return Targets(*(getattr(self, f.name).to(device,
                                                  non_blocking=non_blocking)
                         for f in dataclasses.fields(self)))


@dataclasses.dataclass
class SceneBatch:
    graph: SparseGraph
    features: torch.Tensor       # (N0, C_in) f32
    raw_coords: torch.Tensor     # (N0, 3) f32 un-voxelized xyz
    point2segment: torch.Tensor  # (N0,) int32 local segment id per voxel
    seg_valid: torch.Tensor      # (B, S) bool
    scene_idx: tuple             # per level (B, n_max_l) int32 flat rows;
    #                              invalid entries point at a padded row
    scene_valid: tuple           # per level (B, n_max_l) bool
    level_bounds: torch.Tensor   # (B, 5, 2, 3) f32 per-scene [min, max] of
    #                              the avg-pool2 coordinate pyramid
    seg_counts: torch.Tensor     # (B*S,) f32 voxels per (scene, segment)
    fps_idx: torch.Tensor        # (B, Q) int32 host FPS query seeds
    seg_order: torch.Tensor      # (M,) int32 valid L0 rows, stable-sorted by
    #                              flat segment id b*S + point2segment
    seg_offsets: torch.Tensor    # (B*S + 1,) int32 offsets into seg_order
    target: Targets | None = None  # when the scenes carry instance masks

    @property
    def batch_size(self) -> int:
        return self.scene_idx[0].shape[0]

    @property
    def num_segments_padded(self) -> int:
        return self.seg_valid.shape[1]

    @property
    def batch_idx(self) -> torch.Tensor:
        return self.graph.levels[0].coords[:, 0]

    @property
    def valid(self) -> torch.Tensor:
        return self.graph.levels[0].valid

    def to(self, device, non_blocking: bool = False) -> "SceneBatch":
        def mv(v):
            if isinstance(v, torch.Tensor):
                return v.to(device, non_blocking=non_blocking)
            if isinstance(v, tuple):
                return tuple(mv(e) for e in v)
            if v is None:
                return None
            return v.to(device, non_blocking)
        return dataclasses.replace(self, **{
            f.name: mv(getattr(self, f.name))
            for f in dataclasses.fields(self)})
