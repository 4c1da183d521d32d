"""Prediction post-processing on the host, numpy and scipy only (the port's
own copy of unscene3d_tpu/eval/postprocess.py's `eval_scene_predictions`,
`eval_scene_predictions_packed` and what they need; tests/test_torch_mask3d.py
and tests/test_torch_device_post.py hold the two to equal outputs on the same
inputs).

Top-k query/class scoring with mask-confidence weighting, voxel -> full-res
mapping with segment majority voting, score/overlap instance filtering and
connectivity-based instance separation. Two routes, as the reference has
them: `eval_scene_predictions` over the (N, Q) voxel logits (with the DBSCAN
query split when asked), and `eval_scene_predictions_packed` over what
`eval/device_post.py` computes on the device (class probabilities, mask
scores, bit-packed masks), whose tail runs in segment space through one
sparse matrix (`SegmentVote`). Not copied: sklearn. `dbscan_split_queries`
runs its own DBSCAN on scipy (`dbscan_labels`), with sklearn's labels.
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


class SegmentVote:
    """Per-scene (segment, voxel) point-count matrix: row s, col v = how many
    full-res points of segment s map to voxel v. Segment majority voting of
    any voxel mask set is then one sparse matmul (W @ masks) / counts,
    numerically identical to gathering masks to full resolution and
    averaging per segment (get_full_res_mask), without the per-point
    `np.add.at`. Build once per scene."""

    def __init__(self, inverse_map: np.ndarray,
                 point2segment_full: np.ndarray):
        import scipy.sparse as sp

        p2s = np.asarray(point2segment_full)
        inv = np.asarray(inverse_map)
        self.n_seg = int(p2s.max()) + 1 if len(p2s) else 0
        n_vox = int(inv.max()) + 1 if len(inv) else 0
        self.counts = np.bincount(p2s, minlength=self.n_seg).astype(np.float64)
        self.w = sp.coo_matrix(
            (np.ones(len(p2s), np.float32), (p2s, inv)),
            shape=(self.n_seg, n_vox)).tocsr()
        self.p2s = p2s

    def vote(self, vox_masks: np.ndarray) -> np.ndarray:
        """(n_vox, K) 0/1 -> (S, K) bool majority-voted segment masks."""
        sums = self.w @ vox_masks.astype(np.float32)
        return (sums.astype(np.float64)
                / np.maximum(self.counts, 1)[:, None]) > 0.5


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


def _components(n: int, pairs: np.ndarray) -> np.ndarray:
    """Connected-component id of each of n nodes joined by (E, 2) pairs."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    g = sp.coo_matrix((np.ones(len(pairs), np.int8),
                       (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    return connected_components(g, directed=False)[1]


def _cells_linked(x, cell_of, n_cells, pairs, eps) -> np.ndarray:
    """(E,) bool: whether some point of cell pairs[e, 0] and some point of
    cell pairs[e, 1] lie within eps. Each point of the smaller cell asks a
    4-d KD-tree for its nearest point of the other cell: the fourth
    coordinate, 2 eps x the cell id, puts every other cell out of reach."""
    from scipy.spatial import cKDTree

    size = np.bincount(cell_of, minlength=n_cells)
    order = np.argsort(cell_of, kind="stable")
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    a, b = pairs[:, 0], pairs[:, 1]
    swap = size[a] > size[b]
    ask, other = np.where(swap, b, a), np.where(swap, a, b)
    reps = size[ask]
    pair_of = np.repeat(np.arange(len(pairs)), reps)
    rank = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
    pts = order[start[ask][pair_of] + rank]
    tag = 2.0 * eps
    tree = cKDTree(np.column_stack([x, tag * cell_of]))
    d, _ = tree.query(np.column_stack([x[pts], tag * other[pair_of]]), k=1,
                      distance_upper_bound=np.nextafter(eps, np.inf))
    return np.bincount(pair_of[d <= eps], minlength=len(pairs)) > 0


def _eps_components(x: np.ndarray, eps: float) -> np.ndarray:
    """Connected-component id of each point of the graph that joins two
    points at most eps apart, without listing its edges. Points fall into
    cubic cells of side eps / (2 sqrt 3) (a hair less): two points in one
    cell or in two touching cells (26-neighbourhood) are closer than eps, so
    touching cells merge outright. Cells up to 4 apart whose boxes come
    within eps and whose components still differ are then tested point
    against point (`_cells_linked`)."""
    from scipy.spatial import cKDTree

    s = eps / (2.0 * np.sqrt(3.0)) * (1.0 - 1e-9)
    cells = np.floor(x / s).astype(np.int64)
    cells -= cells.min(axis=0)
    span = cells.max(axis=0) + 1
    keys = (cells[:, 0] * span[1] + cells[:, 1]) * span[2] + cells[:, 2]
    ukeys, cell_of = np.unique(keys, return_inverse=True)
    cell_of = cell_of.reshape(-1)
    uniq = np.column_stack([ukeys // (span[1] * span[2]),
                            ukeys // span[2] % span[1], ukeys % span[2]])
    ctree = cKDTree(uniq)
    touch = ctree.query_pairs(1, p=np.inf, output_type="ndarray")
    comp = _components(len(uniq), touch)
    near = ctree.query_pairs(int(np.ceil(eps / s)), p=np.inf,
                             output_type="ndarray")
    gap = np.maximum(np.abs(uniq[near[:, 0]] - uniq[near[:, 1]]) - 1, 0) * s
    near = near[(comp[near[:, 0]] != comp[near[:, 1]])
                & ((gap ** 2).sum(axis=1) <= eps ** 2)]
    if len(near):
        linked = near[_cells_linked(x, cell_of, len(uniq), near, eps)]
        comp = _components(len(uniq), np.concatenate([touch, linked]))
    return comp[cell_of]


def dbscan_labels(x: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """sklearn.cluster.DBSCAN(eps, min_samples=min_points).fit(x).labels_,
    on scipy. Neighbourhoods are inclusive (distance <= eps, in f64) and
    count the point itself; a core point has at least `min_points`.
    Clusters are the connected components of the core points, numbered in
    order of their smallest core index (sklearn's visiting order); a border
    point takes the smallest-numbered cluster among its core neighbours;
    everything else is noise (-1). With min_points <= 1 every point is a
    core point."""
    from scipy.spatial import cKDTree

    x = np.asarray(x, np.float64)
    labels = np.full(len(x), -1, np.int64)
    if len(x) == 0:
        return labels
    if min_points <= 1:
        core = np.ones(len(x), bool)
    else:
        core = cKDTree(x).query_ball_point(x, eps, return_length=True) \
            >= min_points
    ci = np.nonzero(core)[0]
    if len(ci) == 0:
        return labels
    _, first, inv = np.unique(_eps_components(x[ci], eps), return_index=True,
                              return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    labels[ci] = rank[inv.reshape(-1)]
    border = np.nonzero(~core)[0]
    if len(border):
        # a non-core point has fewer than min_points neighbours: short lists
        near = cKDTree(x[ci]).query_ball_point(x[border], eps)
        for j, lst in zip(border, near):
            if lst:
                labels[j] = labels[ci[lst]].min()
    return labels


def dbscan_split_queries(vox_masks: np.ndarray, pred_logits: np.ndarray,
                         vox_coords: np.ndarray, eps: float = 0.95,
                         min_points: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Split each query's positive region into DBSCAN clusters, one
    prediction per cluster (reference trainer/trainer.py:507-539).
    Returns (new vox_masks (N, K'), new logits (K', C))."""
    new_masks, new_logits = [], []
    for q in range(vox_masks.shape[1]):
        pos = vox_masks[:, q] > 0
        if pos.sum() == 0:
            continue
        labels = dbscan_labels(vox_coords[pos], eps, min_points)
        full = np.full(len(vox_masks), -1, np.int64)
        full[pos] = labels
        for cid in np.unique(labels):
            if cid == -1:
                continue
            new_masks.append(np.where(full == cid, vox_masks[:, q], -1e4))
            new_logits.append(pred_logits[q])
    if not new_masks:
        return vox_masks, pred_logits
    return np.stack(new_masks, 1), np.stack(new_logits, 0)


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
    use_dbscan: bool = False,
    vox_coords: np.ndarray | None = None,
    dbscan_eps: float = 0.95,
    dbscan_min_points: int = 1,
) -> dict:
    """Full single-scene post-processing: returns dict(masks (P,K) bool,
    classes (K,), scores (K,)) for the AP evaluator."""
    if use_dbscan and vox_coords is not None:
        vox_masks, pred_logits = dbscan_split_queries(
            vox_masks, pred_logits, vox_coords, dbscan_eps, dbscan_min_points)
    probs = _softmax(pred_logits)[:, :-1]
    scores, masks, classes, _ = get_mask_and_scores(
        probs, vox_masks, topk_per_image)
    return _postprocess_tail(
        scores, masks, classes, inverse_map, point2segment_full,
        eval_on_segments, filter_instances, iou_threshold, scores_threshold,
        separate_instances, segment_connectivity)


def eval_scene_predictions_packed(
    probs: np.ndarray,             # (Q, C) device softmax incl no-object col
    mask_scores: np.ndarray,       # (Q,) device sigmoid mask scores
    packed_masks: np.ndarray,      # (ceil(N_pad/8), Q) uint8 device-packed
    n_vox: int,
    inverse_map: np.ndarray,
    point2segment_full: np.ndarray | None,
    eval_on_segments: bool = True,
    topk_per_image: int = -1,
    filter_instances: bool = False,
    iou_threshold: float = 1.0,
    scores_threshold: float = 0.0,
    separate_instances: bool = False,
    segment_connectivity: np.ndarray | None = None,
    seg_vote: SegmentVote | None = None,
) -> dict:
    """eval_scene_predictions over the device-post-processed outputs
    (`eval/device_post.py:pack_eval_outputs`): the host unpacks the bits
    and runs the top-k and the filtering. With eval_on_segments the tail
    runs in segment space (S segments instead of P points; the vote, the
    pairwise overlaps and the separation all factor exactly through the
    per-segment point counts)."""
    cls = np.asarray(probs, np.float64)[:, :-1]
    cls_scores, classes, query_idx = _topk_query_classes(cls, topk_per_image)
    scores = cls_scores * np.asarray(mask_scores, np.float64)[query_idx]
    binary = np.unpackbits(np.asarray(packed_masks), axis=0, count=n_vox)
    if eval_on_segments and point2segment_full is not None:
        if seg_vote is None:
            seg_vote = SegmentVote(inverse_map, point2segment_full)
        seg_masks = seg_vote.vote(binary[:, query_idx])
        return _postprocess_tail_segments(
            scores, seg_masks, classes, seg_vote, filter_instances,
            iou_threshold, scores_threshold, separate_instances,
            segment_connectivity)
    masks = binary[:, query_idx].astype(np.float32)
    return _postprocess_tail(
        scores, masks, classes, inverse_map, point2segment_full,
        eval_on_segments, filter_instances, iou_threshold, scores_threshold,
        separate_instances, segment_connectivity)


def _postprocess_tail_segments(scores, seg_masks, classes, sv: SegmentVote,
                               filter_instances, iou_threshold,
                               scores_threshold, separate_instances,
                               segment_connectivity):
    """_postprocess_tail in segment space. Numerically identical to the
    full-res path: full-res masks are seg_masks gathered by p2s, so their
    pairwise products are (seg_masks * counts)^T @ seg_masks with exact
    integer counts (f32-exact below 2^24 points); emptiness and separation
    factor the same way."""
    order = np.argsort(-scores, kind="stable")
    scores, classes = scores[order], classes[order]
    seg_masks = seg_masks[:, order]

    if filter_instances:
        m32 = seg_masks.astype(np.float32)
        weighted = m32 * sv.counts.astype(np.float32)[:, None]
        pairwise = weighted.T @ m32
        norm = pairwise / (pairwise.max(axis=0) + 1e-8)
        sizes = weighted.sum(axis=0)
        keep = []
        for i in range(norm.shape[0]):
            if scores[i] < scores_threshold:
                continue
            if sizes[i] == 0.0:
                continue
            overlap_ids = np.nonzero(norm[i] > iou_threshold)[0]
            if len(overlap_ids) == 0 or i == overlap_ids.min():
                keep.append(i)
        if separate_instances and segment_connectivity is not None:
            uniq = np.arange(sv.n_seg)
            out_masks, out_scores, out_classes = [], [], []
            for i in keep:
                for comp in separate_segments(seg_masks[:, i], uniq,
                                              segment_connectivity):
                    m = np.zeros(sv.n_seg, bool)
                    m[comp] = True
                    out_masks.append(m)
                    out_scores.append(scores[i])
                    out_classes.append(classes[i])
            if out_masks:
                seg_masks = np.stack(out_masks, axis=1)
                scores = np.asarray(out_scores)
                classes = np.asarray(out_classes)
            else:
                seg_masks = np.zeros((sv.n_seg, 0), bool)
                scores = np.zeros((0,))
                classes = np.zeros((0,), np.int64)
        else:
            seg_masks = seg_masks[:, keep]
            scores, classes = scores[keep], classes[keep]

    return {"masks": seg_masks[sv.p2s], "classes": classes, "scores": scores}


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
