"""ScanNet-benchmark instance segmentation AP (numpy, host-side; the port's
own copy of unscene3d_tpu/eval/instance_eval.py's `evaluate_instances`).

The protocol of the reference's evaluator
(benchmark/evaluate_semantic_instance.py:81-543): per-class greedy matching of
predictions to GT instances at IoU overlaps {0.5:0.05:0.95} + {0.25}, with
void-region crediting, duplicate-match false positives, hard false negatives,
min-region-size filtering, and the benchmark's step-width precision/recall
integration. The default is the 'freemask' preset: one class-agnostic
'foreground' class (reference :535-543).

GT encoding matches the reference's on-disk format: per-point integer id
``semantic_label * 1000 + instance_index + 1``; ids whose semantic label is
not in `valid_class_ids` count as void.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FREEMASK_CLASS_LABELS = ("foreground",)
FREEMASK_VALID_CLASS_IDS = (1,)

DEFAULT_OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)


@dataclasses.dataclass
class _GtInstance:
    instance_id: int
    label_id: int
    vert_count: int
    matched_preds: list


@dataclasses.dataclass
class _PredInstance:
    confidence: float
    label_id: int
    vert_count: int
    void_intersection: int
    matched_gts: list  # (gt, intersection)


def _collect_scene(pred_masks, pred_classes, pred_scores, gt_ids,
                   valid_class_ids, min_region_size):
    """Build per-class GT/pred instance records with pairwise intersections."""
    gt_sem = gt_ids // 1000
    void_mask = ~np.isin(gt_sem, valid_class_ids)

    gt_by_class = {c: [] for c in valid_class_ids}
    uniq = np.unique(gt_ids)
    gt_masks = {}
    for gid in uniq:
        sem = gid // 1000
        if sem not in valid_class_ids:
            continue
        m = gt_ids == gid
        inst = _GtInstance(int(gid), int(sem), int(m.sum()), [])
        gt_by_class[sem].append(inst)
        gt_masks[gid] = m

    pred_by_class = {c: [] for c in valid_class_ids}
    for k in range(pred_masks.shape[1]):
        c = int(pred_classes[k])
        if c not in valid_class_ids:
            continue
        pm = pred_masks[:, k].astype(bool)
        vc = int(pm.sum())
        if vc < min_region_size:
            # the reference skips SMALL PREDICTIONS too, not just small GT
            # (benchmark/evaluate_semantic_instance.py:308)
            continue
        void_inter = int((pm & void_mask).sum())
        pred = _PredInstance(float(pred_scores[k]), c, vc, void_inter, [])
        for gt in gt_by_class[c]:
            inter = int((pm & gt_masks[gt.instance_id]).sum())
            if inter > 0:
                pred.matched_gts.append((gt, inter))
                gt.matched_preds.append((pred, inter))
        pred_by_class[c].append(pred)
    return gt_by_class, pred_by_class


def evaluate_instances(
    preds: dict,
    gts: dict,
    valid_class_ids=FREEMASK_VALID_CLASS_IDS,
    class_labels=FREEMASK_CLASS_LABELS,
    overlaps=DEFAULT_OVERLAPS,
    min_region_size: int = 100,
) -> dict:
    """preds[scene] = dict(masks (P,K) bool, classes (K,), scores (K,));
    gts[scene] = (P,) int gt ids. Returns AP metrics dict."""
    valid_class_ids = tuple(int(c) for c in valid_class_ids)
    scenes = sorted(preds.keys())
    per_scene = {}
    for s in scenes:
        p = preds[s]
        per_scene[s] = _collect_scene(
            np.asarray(p["masks"]), np.asarray(p["classes"]),
            np.asarray(p["scores"]), np.asarray(gts[s]),
            valid_class_ids, min_region_size,
        )

    n_classes = len(valid_class_ids)
    ap_table = np.full((n_classes, len(overlaps)), np.nan)

    for ci, c in enumerate(valid_class_ids):
        for oi, overlap_th in enumerate(overlaps):
            y_true, y_score = [], []
            hard_fns = 0
            has_gt = has_pred = False
            for s in scenes:
                gt_by_class, pred_by_class = per_scene[s]
                gt_list = [g for g in gt_by_class[c] if g.vert_count >= min_region_size]
                pred_list = pred_by_class[c]
                if gt_list:
                    has_gt = True
                if pred_list:
                    has_pred = True

                # greedy assignment with the benchmark's visited rule
                # (evaluate_semantic_instance.py:124,144): a prediction
                # first-matched to one GT is skipped for later GTs, so one
                # mask cannot be a true positive for two instances (matters
                # at the 0.25 threshold); duplicate matches to the SAME GT
                # count the lower-confidence one as a FP and do not mark the
                # prediction visited.
                pred_visited = set()
                cur_match = np.zeros(len(gt_list), bool)
                cur_score = np.full(len(gt_list), -np.inf)
                for gi, gt in enumerate(gt_list):
                    found = False
                    for pred, inter in gt.matched_preds:
                        if id(pred) in pred_visited:
                            continue
                        iou = inter / (gt.vert_count + pred.vert_count - inter)
                        if iou > overlap_th:
                            conf = pred.confidence
                            if cur_match[gi]:
                                # duplicate match: lower-confidence one is a FP
                                mx, mn = max(cur_score[gi], conf), min(cur_score[gi], conf)
                                cur_score[gi] = mx
                                y_true.append(0)
                                y_score.append(mn)
                            else:
                                found = True
                                cur_match[gi] = True
                                cur_score[gi] = conf
                                pred_visited.add(id(pred))
                    if not found:
                        hard_fns += 1
                y_true.extend([1] * int(cur_match.sum()))
                y_score.extend(list(cur_score[cur_match]))

                for pred in pred_list:
                    if id(pred) in pred_visited:
                        continue
                    found_gt = False
                    for gt, inter in pred.matched_gts:
                        iou = inter / (gt.vert_count + pred.vert_count - inter)
                        if iou > overlap_th:
                            found_gt = True
                            break
                    if found_gt:
                        continue
                    # credit overlap with void and too-small GT regions
                    num_ignore = pred.void_intersection
                    for gt, inter in pred.matched_gts:
                        if gt.vert_count < min_region_size:
                            num_ignore += inter
                    if num_ignore / pred.vert_count <= overlap_th:
                        y_true.append(0)
                        y_score.append(pred.confidence)

            if has_gt and has_pred:
                ap_table[ci, oi] = _average_precision(
                    np.asarray(y_true), np.asarray(y_score), hard_fns
                )
            elif has_gt:
                ap_table[ci, oi] = 0.0

    o50 = np.isclose(overlaps, 0.5)
    o25 = np.isclose(overlaps, 0.25)
    o_mean = ~o25  # benchmark averages over 0.5:0.95 (reference :247-249)
    result = {
        "all_ap": float(np.nanmean(ap_table[:, o_mean])),
        "all_ap_50%": float(np.nanmean(ap_table[:, o50])),
        "all_ap_25%": float(np.nanmean(ap_table[:, o25])),
        "classes": {},
    }
    for ci, label in enumerate(class_labels):
        result["classes"][label] = {
            "ap": float(np.nanmean(ap_table[ci, o_mean])),
            "ap50%": float(np.nanmean(ap_table[ci, o50])),
            "ap25%": float(np.nanmean(ap_table[ci, o25])),
        }
    return result


def _average_precision(y_true: np.ndarray, y_score: np.ndarray, hard_fns: int) -> float:
    """The benchmark's PR integration (reference :190-242)."""
    if len(y_true) == 0:
        return 0.0 if hard_fns > 0 else float("nan")
    order = np.argsort(y_score)
    y_score, y_true = y_score[order], y_true[order]
    cumsum = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    num_pr = len(unique_idx) + 1
    num_examples = len(y_score)
    num_true = cumsum[-1]
    precision = np.zeros(num_pr)
    recall = np.zeros(num_pr)
    for i, idx in enumerate(unique_idx):
        below = cumsum[idx - 1] if idx > 0 else 0
        tp = num_true - below
        fp = num_examples - idx - tp
        fn = below + hard_fns
        precision[i] = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall[i] = tp / (tp + fn) if tp + fn > 0 else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0
    # integrate with centered step widths
    recall_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))
