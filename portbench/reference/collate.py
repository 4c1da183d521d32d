"""The reference's collate, in NumPy and plain torch: voxelisation, the
5-level sparse graph (k3 neighbour maps, child / parent / up tables),
segments, per-level scene tables, the coordinate-pyramid bounds, the FPS
query seeds and the instance targets, worked out from the raw scenes alone.

The port's NumPy twins (its collator with `native=False`), trimmed to the
configuration the benchmark runs (no crops, no pair or brick tables, no
tri-plane maps), with the neighbour maps and FPS written as batched torch
searches that run on the card. It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

_COORD_BITS = 18
_COORD_OFFSET = 1 << (_COORD_BITS - 1)
_COORD_MASK = (1 << _COORD_BITS) - 1
_TARGET_ALIGN = 8
KERNEL3_OFFSETS = np.array(list(itertools.product((-1, 0, 1), repeat=3)),
                           dtype=np.int32)                        # (27, 3)


def ravel_hash(coords: np.ndarray) -> np.ndarray:
    """Unique int64 key of (N, 3) or batched (N, 4) integer coords."""
    coords = np.asarray(coords, dtype=np.int64)
    spatial = coords[:, -3:]
    x = (spatial[:, 0] + _COORD_OFFSET) & _COORD_MASK
    y = (spatial[:, 1] + _COORD_OFFSET) & _COORD_MASK
    z = (spatial[:, 2] + _COORD_OFFSET) & _COORD_MASK
    key = (x << (2 * _COORD_BITS)) | (y << _COORD_BITS) | z
    if coords.shape[1] == 4:
        key = key | (coords[:, 0] << (3 * _COORD_BITS))
    return key


def sparse_quantize(xyz: np.ndarray, voxel_size: float):
    """(unique voxel coords (M, 3) int32, one point per voxel (M,))."""
    coords = np.floor(np.asarray(xyz) / voxel_size).astype(np.int64)
    _, unique_map = np.unique(ravel_hash(coords), return_index=True)
    return coords[unique_map].astype(np.int32), unique_map


def neighbor_map(coords: np.ndarray, n_pad: int, device="cpu") -> np.ndarray:
    """(27, n_pad) int32 k3 map; misses and padding point at n_pad - 1.
    One sorted-key search per offset on `device`: a neighbour's key is the
    voxel's key plus the offset's, since no coordinate field is at its
    range's end."""
    coords = np.asarray(coords, np.int64)
    n = len(coords)
    spatial = coords[:, 1:]
    if spatial.min() <= -_COORD_OFFSET or spatial.max() >= _COORD_OFFSET - 1:
        raise OverflowError("coordinates too close to the hash range's end")
    keys = torch.from_numpy(ravel_hash(coords)).to(device)
    sorted_keys, order = torch.sort(keys)
    out = torch.full((27, n_pad), n_pad - 1, dtype=torch.int32,
                     device=device)
    for k, (dx, dy, dz) in enumerate(KERNEL3_OFFSETS.tolist()):
        q = keys + ((dx << (2 * _COORD_BITS)) + (dy << _COORD_BITS) + dz)
        pos = torch.clamp_max(torch.searchsorted(sorted_keys, q), n - 1)
        found = sorted_keys[pos] == q
        out[k, :n] = torch.where(found, order[pos], n_pad - 1).int()
    return out.cpu().numpy()


def bucket_size(n: int, align: int = 128, min_size: int = 256) -> int:
    """n rounded up to {1, 1.25, 1.5, 1.75} x 2^k, aligned to `align`."""
    target = max(int(n), 1, min_size)
    p = 1
    while p < target:
        p <<= 1
    size = p
    if p != target:
        for frac in (1.25, 1.5, 1.75):
            cand = int((p >> 1) * frac)
            if cand >= target:
                size = cand
                break
    return ((size + align - 1) // align) * align


def _downsample(coords: np.ndarray):
    coords = np.asarray(coords, dtype=np.int64)
    parents = coords.copy()
    parents[:, 1:] >>= 1
    _, first, inverse = np.unique(ravel_hash(parents), return_index=True,
                                  return_inverse=True)
    off = ((coords[:, 1] & 1) * 4 + (coords[:, 2] & 1) * 2
           + (coords[:, 3] & 1)).astype(np.int32)
    return parents[first], inverse.astype(np.int32).reshape(-1), off


@dataclasses.dataclass
class Level:
    coords: torch.Tensor        # (N, 4) int32
    valid: torch.Tensor         # (N,) bool
    nbr_idx: torch.Tensor       # (27, N) int32
    child_idx: torch.Tensor     # (8, N) int32 rows of the finer level
    parent_idx: torch.Tensor    # (N,) int32
    parent_offset: torch.Tensor  # (N,) int32
    finer_num_padded: int
    up_idx: torch.Tensor | None  # (8, N) int32 rows of the coarser level

    @property
    def child_valid(self):
        return self.child_idx != (self.finer_num_padded - 1)

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def build_levels(coords: np.ndarray, num_levels: int = 5, device="cpu"
                 ) -> list[Level]:
    level_coords = [np.asarray(coords, np.int64)]
    p_idxs, p_offs = [], []
    for _ in range(num_levels - 1):
        coarse, p_idx, p_off = _downsample(level_coords[-1])
        level_coords.append(coarse)
        p_idxs.append(p_idx)
        p_offs.append(p_off)
    pads = [bucket_size(len(lc) + 1) for lc in level_coords]
    out = []
    for li in range(num_levels):
        lc = level_coords[li].astype(np.int32)
        n, n_pad = len(lc), pads[li]
        coords_p = np.zeros((n_pad, 4), np.int32)
        coords_p[:n] = lc
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        if li == 0:
            child = np.zeros((8, n_pad), np.int32)
        else:
            n_fine = len(level_coords[li - 1])
            child = np.full((8, n_pad), pads[li - 1] - 1, np.int32)
            child[p_offs[li - 1][:n_fine], p_idxs[li - 1][:n_fine]] = \
                np.arange(n_fine, dtype=np.int32)
        last = pads[li + 1] - 1 if li < num_levels - 1 else 0
        parent_idx = np.full(n_pad, last, np.int32)
        parent_off = np.zeros(n_pad, np.int32)
        up = None
        if li < num_levels - 1:
            parent_idx[:n] = p_idxs[li]
            parent_off[:n] = p_offs[li]
            up = np.full((8, n_pad), pads[li + 1] - 1, np.int32)
            up[parent_off[:n], np.arange(n)] = parent_idx[:n]
        t = torch.from_numpy
        out.append(Level(
            coords=t(coords_p), valid=t(valid),
            nbr_idx=t(neighbor_map(lc, n_pad, device)), child_idx=t(child),
            parent_idx=t(parent_idx), parent_offset=t(parent_off),
            finer_num_padded=pads[li - 1] if li > 0 else 1,
            up_idx=None if up is None else t(up)))
    return out


def fps(xyz: np.ndarray, valid: np.ndarray, k: int, device="cpu"
        ) -> np.ndarray:
    """Furthest point sampling from row 0 of each scene, all scenes at
    once on `device`: xyz (B, n, 3) integer voxel coordinates as f32 (so
    every squared distance is exact), valid (B, n); the first maximum on
    ties. Returns (B, k) int32."""
    x = torch.from_numpy(np.asarray(xyz, np.float32)).to(device)
    bias = torch.where(torch.from_numpy(np.asarray(valid)).to(device), 0.0,
                       float("-inf"))
    B = x.shape[0]
    rows = torch.arange(B, device=device)
    dist = torch.full(x.shape[:2], float("inf"), device=device)
    idxs = torch.zeros(B, k, dtype=torch.long, device=device)
    for i in range(1, k):
        d = x - x[rows, idxs[:, i - 1]][:, None, :]
        d = d * d
        dist = torch.minimum(dist, (d[..., 0] + d[..., 1]) + d[..., 2])
        idxs[:, i] = torch.argmax(dist + bias, dim=1)
    return idxs.int().cpu().numpy()


@dataclasses.dataclass
class Batch:
    levels: list
    features: torch.Tensor       # (N0, C) f32
    raw_coords: torch.Tensor     # (N0, 3) f32
    point2segment: torch.Tensor  # (N0,) int32
    seg_valid: torch.Tensor      # (B, S) bool
    scene_idx: list              # per level (B, n_max) int32
    scene_valid: list            # per level (B, n_max) bool
    level_bounds: torch.Tensor   # (B, 5, 2, 3) f32
    seg_counts: torch.Tensor     # (B * S,) f32
    fps_idx: torch.Tensor        # (B, Q) int32
    labels: torch.Tensor         # (B, T) int32
    t_valid: torch.Tensor        # (B, T) bool
    seg_masks: torch.Tensor      # (B, T, S) bool

    @property
    def batch_size(self):
        return self.scene_idx[0].shape[0]

    def to(self, device):
        def mv(v):
            if isinstance(v, list):
                return [mv(e) for e in v]
            return v.to(device)
        return dataclasses.replace(self, **{
            f.name: mv(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def collate(scenes: list[dict], voxel_size: float = 0.02,
            fps_queries: int = 100, seg_align: int = 64,
            device="cpu") -> Batch:
    """The batch of the raw scene dicts (xyz, features, segments, masks),
    on the host; the neighbour maps and FPS computed on `device`."""
    B = len(scenes)
    per = []
    for s in scenes:
        xyz = np.asarray(s["xyz"], np.float32)
        vox, umap = sparse_quantize(xyz, voxel_size)
        masks = np.asarray(s["masks"], bool)[umap]
        masks = masks[:, masks.sum(0) > 0]
        _, seg = np.unique(np.asarray(s["segments"])[umap],
                           return_inverse=True)
        per.append(dict(coords=vox, raw=xyz[umap], masks=masks,
                        feats=np.asarray(s["features"], np.float32)[umap],
                        seg=seg.astype(np.int32).reshape(-1)))
    coords_all = np.concatenate([
        np.column_stack([np.full(len(p["coords"]), b, np.int32), p["coords"]])
        for b, p in enumerate(per)])
    levels = build_levels(coords_all, device=device)
    n0 = levels[0].valid.shape[0]
    feats = np.zeros((n0, per[0]["feats"].shape[1]), np.float32)
    raw = np.zeros((n0, 3), np.float32)
    p2s = np.zeros(n0, np.int32)
    rows, off = [], 0
    for p in per:
        n = len(p["coords"])
        feats[off:off + n], raw[off:off + n] = p["feats"], p["raw"]
        p2s[off:off + n] = p["seg"]
        rows.append((off, n))
        off += n

    scene_idx, scene_valid = [], []
    for lvl in levels:
        bidx, valid = lvl.coords[:, 0].numpy(), lvl.valid.numpy()
        r = [np.nonzero((bidx == b) & valid)[0] for b in range(B)]
        n_max = bucket_size(max(len(x) for x in r) + 1, align=64, min_size=64)
        it = np.full((B, n_max), len(valid) - 1, np.int32)
        vt = np.zeros((B, n_max), bool)
        for b, x in enumerate(r):
            it[b, :len(x)] = x
            vt[b, :len(x)] = True
        scene_idx.append(it)
        scene_valid.append(vt)

    # per-scene bounds of the average-pooled coordinate pyramid
    bounds = np.zeros((B, len(levels), 2, 3), np.float32)
    c = raw
    for lv, lvl in enumerate(levels):
        valid = lvl.valid.numpy()
        if lv > 0:
            child = lvl.child_idx.numpy()
            cv = child != lvl.finer_num_padded - 1
            s = np.zeros((len(valid), 3), np.float32)
            for k in range(8):
                s = s + np.where(cv[k][:, None], c[child[k]], 0.0)
            c = s / np.maximum(cv.sum(0).astype(np.float32), 1.0)[:, None]
            c = c * valid[:, None]
        bidx = lvl.coords[:, 0].numpy()
        for b in range(B):
            m = (bidx == b) & valid
            bounds[b, lv, 0] = c[m].min(0)
            bounds[b, lv, 1] = c[m].max(0)

    c0 = levels[0].coords[:, 1:].numpy().astype(np.float32)
    fps_idx = fps(c0[scene_idx[0]], scene_valid[0], fps_queries, device)

    s_counts = [int(p["seg"].max()) + 1 for p in per]
    s_max = bucket_size(max(s_counts) + 1, align=seg_align,
                        min_size=seg_align)
    seg_valid = np.zeros((B, s_max), bool)
    for b, n in enumerate(s_counts):
        seg_valid[b, :n] = True
    valid0 = levels[0].valid.numpy()
    seg_flat = levels[0].coords[:, 0].numpy().astype(np.int64) * s_max + p2s
    seg_counts = np.bincount(seg_flat[valid0], minlength=B * s_max
                             ).astype(np.float32)[:B * s_max]

    t_max = bucket_size(max([p["masks"].shape[1] for p in per] + [1]),
                        align=_TARGET_ALIGN, min_size=_TARGET_ALIGN)
    labels = np.zeros((B, t_max), np.int32)
    t_valid = np.zeros((B, t_max), bool)
    seg_masks = np.zeros((B, t_max, s_max), bool)
    for b, p in enumerate(per):
        k = p["masks"].shape[1]
        labels[b, :k] = 1
        t_valid[b, :k] = True
        for t in range(k):
            seg_masks[b, t, np.unique(p["seg"][p["masks"][:, t]])] = True
    t = torch.from_numpy
    return Batch(levels=levels, features=t(feats), raw_coords=t(raw),
                 point2segment=t(p2s), seg_valid=t(seg_valid),
                 scene_idx=[t(a) for a in scene_idx],
                 scene_valid=[t(a) for a in scene_valid],
                 level_bounds=t(bounds), seg_counts=t(seg_counts),
                 fps_idx=t(fps_idx), labels=t(labels), t_valid=t(t_valid),
                 seg_masks=t(seg_masks))
