"""Per-segment feature aggregation (counterpart of
unscene3d_tpu/pseudo/features.py).

Mean or max pooling of voxel features onto segments runs on the host through
ops/segment_ops.py over CPU tensors (their `index_add_` is deterministic
there, as it is not for floats on the GPU; the features arrive as numpy and
leave as numpy); the zero-feature infill (a segment
whose voxels all have zero features gets the mean of its connected
neighbours, else the scene mean) touches a handful of segments. Each zero
segment uses its own neighbours, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from unscene3d_torch.ops.segment_ops import segment_max, segment_mean


def aggregate_features(encoded_features, segment_ids, connectivity,
                       aggregation_mode: str = "mean"):
    """encoded_features: (P, D) voxel features; segment_ids: (P,) raw ids;
    connectivity: (E, 2) raw id pairs. Returns (segment_feats (S, D) f32,
    unique_segments (S,))."""
    unique_segments, local = np.unique(np.asarray(segment_ids),
                                       return_inverse=True)
    s = len(unique_segments)
    feats = torch.from_numpy(np.ascontiguousarray(encoded_features,
                                                  np.float32))
    ids = torch.from_numpy(local.reshape(-1).astype(np.int64))
    # only voxels with any nonzero feature are aggregated
    valid = (feats != 0).any(dim=-1)
    reduce = segment_max if aggregation_mode == "max" else segment_mean
    seg = reduce(feats, ids, s, valid).numpy()

    zero = ~np.any(seg != 0, axis=-1)
    if zero.any():
        conn = np.asarray(connectivity)
        id_to_local = {int(u): i for i, u in enumerate(unique_segments)}
        scene_mean = (seg[~zero].mean(0) if (~zero).any()
                      else np.zeros(seg.shape[1]))
        filled = seg.copy()
        for li in np.nonzero(zero)[0]:
            sid = int(unique_segments[li])
            nbrs = conn[conn[:, 0] == sid][:, 1] if len(conn) else []
            nbr_feats = [seg[id_to_local[int(n)]] for n in nbrs
                         if int(n) in id_to_local
                         and not zero[id_to_local[int(n)]]]
            filled[li] = np.mean(nbr_feats, axis=0) if nbr_feats else scene_mean
        seg = filled
    return seg, unique_segments
