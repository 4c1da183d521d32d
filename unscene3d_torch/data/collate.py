"""Host-side voxelization + collation (counterpart of
unscene3d_tpu/data/collate.py:FreeMaskCollator, without crops, triplane maps
or TPU tables).

numpy, and the port's native library (`unscene3d_torch/native`, C++) for
the k3 maps and the FPS seeds, as the JAX collator calls its own;
`native=False` runs their numpy twins instead. With the same settings every
table equals the JAX collator's
bitwise (tests/test_torch_collate.py): the voxelize step, the 5-level graph,
segments and seg_valid, per-level scene tables, level_bounds, seg_counts,
the host FPS seeds and, for scenes that carry instance `masks`, the targets.
Two additions, static per batch: the stable segment row order and offsets
that kernel 3 (ops/segment_pool.py) walks, and each level's one-hot parent
tables `up_idx` that the up2 conv gathers through. With `csr_levels` (the
JAX collator's `data.csr_levels`) those levels are padded to 256 rows and
carry the valid-pair tables of kernel 6, ragged and exact where the JAX
collator buckets them for static shapes.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from unscene3d_torch import native as native_lib
from unscene3d_torch.data.batch import SceneBatch, Targets
from unscene3d_torch.ops.hashing import sparse_quantize
from unscene3d_torch.ops.kernel_maps import build_sparse_graph
from unscene3d_torch.ops.segment_pool import segment_order, segment_pieces
from unscene3d_torch.ops.sparse_graph import bucket_size, graph_from_levels

# instance targets are padded to a multiple of 8, at least 8 (the JAX
# collator's target_align default)
_TARGET_ALIGN = 8


@dataclasses.dataclass
class CollateMeta:
    """Host-only per-scene metadata for full-resolution post-processing."""

    scene_names: list
    inverse_maps: list            # (P_b,) voxel index per original point
    num_voxels: list
    segment_connectivity: list
    original_segments: list       # (P_b,) consecutive full-res segment ids


def fps_numpy(xyz: np.ndarray, valid: np.ndarray, k: int,
              native: bool = True) -> np.ndarray:
    """Iterative-argmax furthest point sampling (start at 0, f32 distances,
    first-max ties), identical to the JAX collator's seeds: the C++ loop
    (`native/point_ops.cpp`) by default, the numpy loop with `native=False`.
    The (x - c) squared-sum arithmetic is kept on purpose: an |x|^2
    expansion would change the f32 rounding and the seeds."""
    if native:
        return native_lib.furthest_point_sample(xyz, np.asarray(valid), k)
    n = len(xyz)
    xyz = np.asarray(xyz, np.float32)
    mask_bias = np.where(valid, np.float32(0), -np.inf).astype(np.float32)
    dist = np.full(n, np.inf, np.float32)
    idxs = np.zeros(k, np.int32)
    buf = np.empty((n, 3), np.float32)
    for i in range(1, k):
        np.subtract(xyz, xyz[idxs[i - 1]], out=buf)
        np.multiply(buf, buf, out=buf)
        d = buf.sum(axis=1)
        np.minimum(dist, d, out=dist)
        idxs[i] = np.argmax(dist + mask_bias)
    return idxs


def _coord_pyramid_bounds(levels: list[dict], raw_coords: np.ndarray,
                          B: int) -> np.ndarray:
    """Per-scene [min, max] of the avg-pool2 coordinate pyramid, (B, 5, 2, 3):
    per-offset child sums in offset order in f32, as avg_pool2 computes
    them."""
    bounds = np.zeros((B, len(levels), 2, 3), np.float32)
    c = np.asarray(raw_coords, np.float32)
    for lv, lvl in enumerate(levels):
        if lv > 0:
            child_idx = lvl["child_idx"]
            child_valid = child_idx != lvl["finer_num_padded"] - 1
            s = np.zeros((len(lvl["valid"]), 3), np.float32)
            for k in range(8):
                s = s + np.where(child_valid[k][:, None], c[child_idx[k]], 0.0)
            cnt = child_valid.sum(axis=0).astype(np.float32)
            c = s / np.maximum(cnt, 1.0)[:, None]
            c = c * lvl["valid"][:, None]
        bidx = lvl["coords"][:, 0]
        for b in range(B):
            m = (bidx == b) & lvl["valid"]
            if m.any():
                bounds[b, lv, 0] = c[m].min(axis=0)
                bounds[b, lv, 1] = c[m].max(axis=0)
    return bounds


def _relabel(ids: np.ndarray) -> np.ndarray:
    _, inv = np.unique(ids, return_inverse=True)
    return inv.astype(np.int32).reshape(-1)


def _targets(per_scene: list[dict], scene_rows: list[tuple[int, int]],
             s_max: int, n0_pad: int) -> Targets:
    """Instance targets (unscene3d_tpu/data/collate.py:361-391): labels
    from `mask_labels`, or 1 (the freemask foreground class) where a scene
    has none; T = bucket_size(max instances, 8, min_size=8)."""
    B = len(per_scene)
    t_counts = [p["masks"].shape[1] for p in per_scene]
    t_max = bucket_size(max(t_counts + [1]), align=_TARGET_ALIGN,
                        min_size=_TARGET_ALIGN)
    labels = np.zeros((B, t_max), np.int32)
    t_valid = np.zeros((B, t_max), bool)
    seg_masks = np.zeros((B, t_max, s_max), bool)
    vox_masks = np.zeros((n0_pad, t_max), bool)
    for b, p in enumerate(per_scene):
        off, n = scene_rows[b]
        k = p["masks"].shape[1]
        labels[b, :k] = 1 if p["mask_labels"] is None else p["mask_labels"]
        t_valid[b, :k] = True
        vox_masks[off:off + n, :k] = p["masks"]
        for t in range(k):
            seg_masks[b, t, np.unique(p["seg"][p["masks"][:, t]])] = True
    t = torch.from_numpy
    return Targets(labels=t(labels), valid=t(t_valid),
                   seg_masks=t(seg_masks), vox_masks=t(vox_masks))


class FreeMaskCollator:
    """Collate a list of scene dicts (xyz (P,3), features (P,C), segments
    (P,), optional masks (P,K) bool with optional mask_labels (K,),
    segment_connectivity and name) into (SceneBatch of CPU tensors,
    CollateMeta). Instances that voxelization empties are dropped. `native`
    (default) builds the k3 maps and the FPS seeds in the C++ library;
    False runs their numpy twins. `timings` holds the last call's seconds:
    `voxelize` (quantize, dedup, relabel per scene) and `total`."""

    def __init__(self, voxel_size: float = 0.02, num_levels: int = 5,
                 seg_align: int = 64,
                 fine_buckets: bool = False, fps_queries: int = 100,
                 csr_levels: tuple = (), native: bool = True):
        self.voxel_size = voxel_size
        self.num_levels = num_levels
        self.seg_align = seg_align
        self.fine_buckets = fine_buckets
        self.fps_queries = int(fps_queries)
        # levels whose k3 convs run over compacted valid pairs (kernel 6)
        self.csr_levels = tuple(csr_levels)
        self.native = bool(native)
        self.timings = {}

    def __call__(self, scenes: list[dict]) -> tuple[SceneBatch, CollateMeta]:
        t0 = time.perf_counter()
        B = len(scenes)
        per_scene = []
        meta = CollateMeta([], [], [], [], [])
        for b, s in enumerate(scenes):
            xyz = np.asarray(s["xyz"], np.float32)
            vox, unique_map, inverse_map = sparse_quantize(xyz, self.voxel_size)
            masks, mask_labels = s.get("masks"), None
            if masks is not None:
                masks = np.asarray(masks, bool)[unique_map]
                keep = masks.sum(0) > 0   # drop instances voxelization emptied
                masks = masks[:, keep]
                if s.get("mask_labels") is not None:
                    mask_labels = np.asarray(s["mask_labels"])[keep]
            per_scene.append(dict(
                coords=vox,
                feats=np.asarray(s["features"], np.float32)[unique_map],
                raw=xyz[unique_map],
                seg=_relabel(np.asarray(s["segments"])[unique_map]),
                masks=masks, mask_labels=mask_labels))
            meta.scene_names.append(s.get("name", f"scene{b:04d}"))
            meta.inverse_maps.append(inverse_map)
            meta.num_voxels.append(len(vox))
            meta.segment_connectivity.append(s.get("segment_connectivity"))
            meta.original_segments.append(_relabel(np.asarray(s["segments"])))
        t_vox = time.perf_counter()

        coords_all = np.concatenate(
            [np.column_stack([np.full(len(p["coords"]), b, np.int32),
                              p["coords"]])
             for b, p in enumerate(per_scene)])
        levels = build_sparse_graph(coords_all, self.num_levels,
                                    fine_buckets=self.fine_buckets,
                                    csr_levels=self.csr_levels,
                                    native=self.native)
        n0_pad = len(levels[0]["valid"])

        c_in = per_scene[0]["feats"].shape[1]
        features = np.zeros((n0_pad, c_in), np.float32)
        raw_coords = np.zeros((n0_pad, 3), np.float32)
        point2segment = np.zeros(n0_pad, np.int32)
        offset = 0
        scene_rows = []
        for p in per_scene:
            n = len(p["coords"])
            features[offset:offset + n] = p["feats"]
            raw_coords[offset:offset + n] = p["raw"]
            point2segment[offset:offset + n] = p["seg"]
            scene_rows.append((offset, n))
            offset += n

        scene_idx, scene_valid = [], []
        for lvl in levels:
            bidx, valid = lvl["coords"][:, 0], lvl["valid"]
            rows = [np.nonzero((bidx == b) & valid)[0] for b in range(B)]
            n_max = bucket_size(max(len(r) for r in rows) + 1, align=64,
                                min_size=64)
            idx_tbl = np.full((B, n_max), len(valid) - 1, np.int32)
            val_tbl = np.zeros((B, n_max), bool)
            for b, r in enumerate(rows):
                idx_tbl[b, :len(r)] = r
                val_tbl[b, :len(r)] = True
            scene_idx.append(idx_tbl)
            scene_valid.append(val_tbl)

        level_bounds = _coord_pyramid_bounds(levels, raw_coords, B)

        c0 = levels[0]["coords"][:, 1:].astype(np.float32)
        fps_idx = np.stack([
            fps_numpy(c0[scene_idx[0][b]], scene_valid[0][b],
                      self.fps_queries, self.native)
            for b in range(B)]).astype(np.int32)

        s_counts = [int(p["seg"].max()) + 1 if len(p["seg"]) else 0
                    for p in per_scene]
        s_max = bucket_size(max(s_counts) + 1, align=self.seg_align,
                            min_size=self.seg_align)
        seg_valid = np.zeros((B, s_max), bool)
        for b, c in enumerate(s_counts):
            seg_valid[b, :c] = True
        seg_flat = levels[0]["coords"][:, 0] * s_max + point2segment
        valid0 = levels[0]["valid"]
        seg_counts = np.bincount(seg_flat[valid0], minlength=B * s_max
                                 ).astype(np.float32)[:B * s_max]
        seg_order, seg_offsets = segment_order(seg_flat, B * s_max, valid0)
        target = None
        if per_scene[0]["masks"] is not None:
            target = _targets(per_scene, scene_rows, s_max, n0_pad)

        t = torch.from_numpy
        graph = graph_from_levels(levels)
        batch = SceneBatch(
            graph=graph, features=t(features), raw_coords=t(raw_coords),
            point2segment=t(point2segment), seg_valid=t(seg_valid),
            scene_idx=tuple(t(a) for a in scene_idx),
            scene_valid=tuple(t(a) for a in scene_valid),
            level_bounds=t(level_bounds), seg_counts=t(seg_counts),
            fps_idx=t(fps_idx), seg_order=t(seg_order),
            seg_offsets=t(seg_offsets),
            seg_pieces=t(segment_pieces(seg_offsets)), target=target)
        self.timings = {"voxelize": t_vox - t0,
                        "total": time.perf_counter() - t0}
        return batch, meta
