"""VOC-style 3D box AP (the port's own copy of unscene3d_tpu/eval/box_eval.py;
reference utils/votenet_utils/eval_det.py:168, called from
trainer/trainer.py:791-796 with axis-aligned boxes derived from instance
masks)."""

from __future__ import annotations

import numpy as np


def box3d_iou_aabb(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Boxes as (cx, cy, cz, dx, dy, dz)."""
    a_min = box_a[:3] - box_a[3:] / 2
    a_max = box_a[:3] + box_a[3:] / 2
    b_min = box_b[:3] - box_b[3:] / 2
    b_max = box_b[:3] + box_b[3:] / 2
    inter = np.prod(np.maximum(np.minimum(a_max, b_max) - np.maximum(a_min, b_min), 0))
    vol_a = np.prod(np.maximum(a_max - a_min, 0))
    vol_b = np.prod(np.maximum(b_max - b_min, 0))
    union = vol_a + vol_b - inter
    return float(inter / union) if union > 0 else 0.0


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """All-point interpolation (VOC post-2010 style, as votenet uses)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det(pred_all: dict, gt_all: dict, ovthresh: float = 0.25) -> tuple[dict, dict]:
    """pred_all[scene] = [(classname, box(6,), score)], gt_all[scene] =
    [(classname, box(6,))]. Returns (recall per class, AP per class)."""
    classes = {c for preds in pred_all.values() for c, _, _ in preds}
    classes |= {c for gts in gt_all.values() for c, _ in gts}
    rec_out, ap_out = {}, {}
    for cls in classes:
        gt_by_scene = {
            s: [np.asarray(b) for c, b in gts if c == cls]
            for s, gts in gt_all.items()
        }
        npos = sum(len(v) for v in gt_by_scene.values())
        records = []
        for s, preds in pred_all.items():
            for c, box, score in preds:
                if c == cls:
                    records.append((s, np.asarray(box), float(score)))
        records.sort(key=lambda r: -r[2])
        matched = {s: np.zeros(len(v), bool) for s, v in gt_by_scene.items()}
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for i, (s, box, _) in enumerate(records):
            gts = gt_by_scene.get(s, [])
            best_iou, best_j = -1.0, -1
            for j, g in enumerate(gts):
                iou = box3d_iou_aabb(box, g)
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou > ovthresh and not matched[s][best_j]:
                tp[i] = 1
                matched[s][best_j] = True
            else:
                fp[i] = 1
        cum_tp, cum_fp = np.cumsum(tp), np.cumsum(fp)
        rec = cum_tp / max(npos, 1)
        prec = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
        rec_out[cls] = rec[-1] if len(rec) else 0.0
        ap_out[cls] = voc_ap(rec, prec) if len(rec) else 0.0
    return rec_out, ap_out


def boxes_from_masks(coords: np.ndarray, masks: np.ndarray,
                     classes: np.ndarray, scores: np.ndarray | None = None):
    """Axis-aligned boxes from instance masks (trainer/trainer.py:669-698)."""
    out = []
    for k in range(masks.shape[1]):
        pts = coords[masks[:, k].astype(bool)]
        if len(pts) == 0:
            continue
        center = pts.mean(0)
        size = pts.max(0) - pts.min(0)
        box = np.concatenate([center, size])
        if scores is None:
            out.append((int(classes[k]), box))
        else:
            out.append((int(classes[k]), box, float(scores[k])))
    return out
