"""Query-key similarity pseudo-mask generator (counterpart of
unscene3d_tpu/pseudo/freemask_query.py), numpy on the host.

Queries = per-segment mean features, or with `use_fps_sampling` the
`fps_num_samples` segments that furthest point sampling picks (native C++,
`native.furthest_point_sample`) when there are more segments than that;
soft masks = min-max-normalized cosine similarity between queries and
segment features; hard threshold -> connectivity separation -> XY-extent
filter -> matrix-NMS maskness ranking -> top-K and score threshold.
"""

from __future__ import annotations

import numpy as np

from unscene3d_torch import native
from unscene3d_torch.eval.nms import matrix_nms
from unscene3d_torch.eval.postprocess import separate_segments
from unscene3d_torch.pseudo.freemask_utils import cosine_sim


def freemask_query_masks(
    segment_feats: np.ndarray,      # (S, D)
    unique_segments: np.ndarray,    # (S,)
    connectivity: np.ndarray,       # (E, 2)
    segment_coords: np.ndarray,     # (S, 3) segment centroids
    scene_extent: np.ndarray,       # (3,)
    hard_mask_threshold: float = 0.35,
    min_segments: int = 3,
    instance_to_scene_max_ratio: float = 0.8,
    nms_maskness_threshold: float = 0.6,
    max_instance_num: int = 50,
    use_fps_sampling: bool = False,
    fps_num_samples: int = 100,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (masks (K, S) bool at segment level, maskness scores (K,)).

    FPS samples on the first three FEATURE channels, not on the segment
    centroids: a quirk of the reference (unscene3d_tpu/pseudo/
    freemask_query.py:48-50) that the port keeps."""
    queries = segment_feats
    if use_fps_sampling and len(segment_feats) > fps_num_samples:
        idx = native.furthest_point_sample(
            segment_feats[:, :3].astype(np.float32),
            np.ones(len(segment_feats), bool), fps_num_samples)
        queries = segment_feats[idx]
    soft = cosine_sim(queries, segment_feats)       # (Q, S)
    soft[:, ~np.any(segment_feats != 0, axis=-1)] = 0.0
    masks = soft >= hard_mask_threshold
    keep = masks.sum(1) > 2
    if not keep.any():
        return np.zeros((0, len(unique_segments)), bool), np.zeros(0)
    masks, soft = masks[keep], soft[keep]

    # connectivity separation: one candidate per connected component
    sep_masks, sep_soft = [], []
    for q in range(len(masks)):
        for comp in separate_segments(masks[q], unique_segments,
                                      connectivity):
            sel = np.isin(unique_segments, comp)
            if sel.sum() > min_segments:
                sep_masks.append(sel)
                sep_soft.append(np.where(sel, soft[q], 0.0))
    if not sep_masks:
        return np.zeros((0, len(unique_segments)), bool), np.zeros(0)
    masks = np.stack(sep_masks)
    soft = np.stack(sep_soft)

    # XY-extent filter
    keep = []
    for k in range(len(masks)):
        ext = (segment_coords[masks[k]].max(0)
               - segment_coords[masks[k]].min(0))
        if not np.any(ext[:2] / np.maximum(scene_extent[:2], 1e-9)
                      > instance_to_scene_max_ratio):
            keep.append(k)
    if keep:
        masks, soft = masks[keep], soft[keep]

    maskness = (soft * masks).sum(1) / np.maximum(masks.sum(1), 1)
    maskness = matrix_nms(masks, maskness, kernel="gauss", sigma=2.0)
    order = np.argsort(-maskness)[:max_instance_num]
    masks, maskness = masks[order], maskness[order]
    keep = maskness > nms_maskness_threshold
    return masks[keep], maskness[keep]
