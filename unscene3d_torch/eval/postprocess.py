"""Prediction post-processing on the host, numpy and scipy only (the port's
own copy of what `eval_scene_predictions` of
unscene3d_tpu/eval/postprocess.py needs; tests/test_torch_mask3d.py holds
the two to exactly equal outputs on the same inputs).

Top-k query/class scoring with mask-confidence weighting, voxel -> full-res
mapping with segment majority voting, score/overlap instance filtering and
connectivity-based instance separation. Not copied: the DBSCAN query split
and the device-packed segment-space variant, which `inference.py` does not
call.
"""

from __future__ import annotations

import numpy as np


def _topk_query_classes(cls_probs: np.ndarray, topk_per_image: int):
    """Flattened stable top-k over the (Q, C-1) class-score grid (reference
    trainer.py:456-477). Returns (class scores, class ids, query ids)."""
    num_queries, num_classes = cls_probs.shape
    k = num_queries if topk_per_image == -1 else topk_per_image
    flat = cls_probs.reshape(-1)
    topk_indices = np.argsort(-flat, kind="stable")[:k]
    return (flat[topk_indices], topk_indices % num_classes,
            topk_indices // num_classes)


def get_mask_and_scores(cls_probs: np.ndarray, mask_pred: np.ndarray,
                        topk_per_image: int = -1):
    """cls_probs: (Q, C-1) softmax scores without the no-object column.
    mask_pred: (N, Q) mask logits. Returns (scores, binary masks (N,K),
    classes (K,), heatmap (N,K))."""
    scores_per_query, labels_per_query, query_idx = _topk_query_classes(
        cls_probs, topk_per_image)

    mask_pred = mask_pred[:, query_idx]
    result_pred_mask = (mask_pred > 0).astype(np.float32)
    heatmap = 1.0 / (1.0 + np.exp(-mask_pred.astype(np.float64)))

    mask_scores = (heatmap * result_pred_mask).sum(0) / (result_pred_mask.sum(0) + 1e-6)
    score = scores_per_query * mask_scores
    return score, result_pred_mask, labels_per_query, heatmap


def get_full_res_mask(mask: np.ndarray, inverse_map: np.ndarray,
                      point2segment_full: np.ndarray | None,
                      eval_on_segments: bool = True,
                      is_heatmap: bool = False) -> np.ndarray:
    """Voxel (N_vox, K) -> full-res points via inverse_map; optionally
    majority-vote per full-res segment (reference :445-453)."""
    full = mask[inverse_map]
    if eval_on_segments and not is_heatmap and point2segment_full is not None:
        n_seg = int(point2segment_full.max()) + 1
        sums = np.zeros((n_seg, full.shape[1]), np.float64)
        np.add.at(sums, point2segment_full, full)
        counts = np.bincount(point2segment_full, minlength=n_seg).astype(np.float64)
        seg_mean = sums / np.maximum(counts, 1)[:, None]
        full = (seg_mean > 0.5).astype(np.float32)[point2segment_full]
    return full


def filter_out_instances(sorted_masks: np.ndarray, sort_scores: np.ndarray,
                         iou_threshold: float = 1.0,
                         scores_threshold: float = 0.0) -> list[int]:
    """Score threshold + pairwise-overlap dedup (reference :586-607).
    sorted_masks: (N, K) in decreasing score order."""
    pairwise = sorted_masks.T @ sorted_masks
    norm = pairwise / (pairwise.max(axis=0) + 1e-8)
    keep = []
    for i in range(norm.shape[0]):
        if sort_scores[i] < scores_threshold:
            continue
        if sorted_masks[:, i].sum() == 0.0:
            continue
        overlap_ids = np.nonzero(norm[i] > iou_threshold)[0]
        if len(overlap_ids) == 0 or i == overlap_ids.min():
            keep.append(i)
    return keep


def separate_segments(foreground: np.ndarray, unique_segments: np.ndarray,
                      connectivity: np.ndarray) -> list[np.ndarray]:
    """Split a segment-level mask into connected components under the segment
    adjacency graph. Same result as the reference's iterative blob fusion
    (utils/point_cloud_utils.py:82-121) via union-find.

    foreground: (S,) bool over unique_segments; connectivity: (E, 2) segment
    id pairs. Returns list of arrays of segment ids."""
    fg_ids = np.asarray(unique_segments)[np.asarray(foreground)]
    n = len(fg_ids)
    if n == 0:
        return []
    conn = np.asarray(connectivity).reshape(-1, 2)
    # map arbitrary segment ids -> fg positions (vectorized; the per-edge
    # Python loop dominated the NCut batch at ~1.1ms x scenes x iterations)
    sorter = np.argsort(fg_ids, kind="stable")
    sorted_ids = fg_ids[sorter]

    def to_pos(ids):
        p = np.searchsorted(sorted_ids, ids)
        p_clip = np.minimum(p, n - 1)
        ok = sorted_ids[p_clip] == ids
        return sorter[p_clip], ok

    if conn.size:
        pa, ok_a = to_pos(conn[:, 0])
        pb, ok_b = to_pos(conn[:, 1])
        keep = ok_a & ok_b
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components

        g = sp.coo_matrix(
            (np.ones(int(keep.sum()), np.int8), (pa[keep], pb[keep])),
            shape=(n, n))
        _, labels = connected_components(g, directed=False)
    else:
        labels = np.arange(n)
    # component order = first occurrence in fg order (matches the reference's
    # blob-creation order and the previous union-find's dict insertion order)
    uniq_labs, first_idx = np.unique(labels, return_index=True)
    order = uniq_labs[np.argsort(first_idx, kind="stable")]
    return [fg_ids[labels == lab] for lab in order]


def eval_scene_predictions(
    pred_logits: np.ndarray,       # (Q, C)
    vox_masks: np.ndarray,         # (N_vox, Q) logits (already segment-pooled)
    inverse_map: np.ndarray,
    point2segment_full: np.ndarray | None,
    eval_on_segments: bool = True,
    topk_per_image: int = -1,
    filter_instances: bool = False,
    iou_threshold: float = 1.0,
    scores_threshold: float = 0.0,
    separate_instances: bool = False,
    segment_connectivity: np.ndarray | None = None,
) -> dict:
    """Full single-scene post-processing: returns dict(masks (P,K) bool,
    classes (K,), scores (K,)) for the AP evaluator."""
    probs = _softmax(pred_logits)[:, :-1]
    scores, masks, classes, _ = get_mask_and_scores(
        probs, vox_masks, topk_per_image)
    return _postprocess_tail(
        scores, masks, classes, inverse_map, point2segment_full,
        eval_on_segments, filter_instances, iou_threshold, scores_threshold,
        separate_instances, segment_connectivity)


def _postprocess_tail(scores, masks, classes, inverse_map,
                      point2segment_full, eval_on_segments, filter_instances,
                      iou_threshold, scores_threshold, separate_instances,
                      segment_connectivity):
    masks = get_full_res_mask(masks, inverse_map, point2segment_full,
                              eval_on_segments)

    order = np.argsort(-scores, kind="stable")
    scores, classes = scores[order], classes[order]
    masks = masks[:, order]

    if filter_instances:
        keep = filter_out_instances(masks, scores, iou_threshold, scores_threshold)
        if separate_instances and segment_connectivity is not None and \
                point2segment_full is not None:
            uniq = np.unique(point2segment_full)
            out_masks, out_scores, out_classes = [], [], []
            for i in keep:
                seg_mask = np.zeros(len(uniq), bool)
                seg_mask[np.unique(point2segment_full[masks[:, i].astype(bool)])] = True
                for comp in separate_segments(seg_mask, uniq, segment_connectivity):
                    out_masks.append(np.isin(point2segment_full, comp))
                    out_scores.append(scores[i])
                    out_classes.append(classes[i])
            if out_masks:
                masks = np.stack(out_masks, axis=1)
                scores = np.asarray(out_scores)
                classes = np.asarray(out_classes)
            else:
                masks = np.zeros((masks.shape[0], 0), np.float32)
                scores = np.zeros((0,))
                classes = np.zeros((0,), np.int64)
        else:
            masks, scores, classes = masks[:, keep], scores[keep], classes[keep]

    return {"masks": masks.astype(bool), "classes": classes, "scores": scores}


def _softmax(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)
