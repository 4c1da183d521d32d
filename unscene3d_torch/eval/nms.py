"""SOLO-style Matrix NMS over binary masks (the port's numpy copy of
unscene3d_tpu/eval/nms.py), used by the query-key pseudo-mask generator."""

from __future__ import annotations

import numpy as np


def matrix_nms(masks: np.ndarray, scores: np.ndarray, kernel: str = "gauss",
               sigma: float = 2.0) -> np.ndarray:
    """masks: (K, P) bool, scores: (K,). Returns decayed scores (K,).

    Masks are taken in descending score order; each mask's score is decayed
    by its IoU with every higher-scored mask, compensated by how suppressed
    those masks already are (the SOLOv2 matrix formulation)."""
    k = len(scores)
    if k == 0:
        return scores.copy()
    order = np.argsort(-scores, kind="stable")
    m = masks[order].astype(np.float32)
    s = scores[order].astype(np.float32)

    inter = m @ m.T
    areas = m.sum(1)
    union = areas[:, None] + areas[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)
    iou = np.triu(iou, k=1)  # iou[i, j] for i < j (i higher scored)

    # how much each higher-scored mask is itself overlapped
    compensate = iou.max(axis=0)
    compensate_mat = np.tile(compensate[:, None], (1, k))

    if kernel == "gauss":
        decay = np.exp(-(iou ** 2 - compensate_mat ** 2) * sigma)
    elif kernel == "linear":
        decay = (1 - iou) / np.maximum(1 - compensate_mat, 1e-9)
    else:
        raise ValueError(kernel)
    decay = np.where(iou > 0, decay, 1.0)
    decay_factor = decay.min(axis=0)
    out = np.empty_like(scores, dtype=np.float32)
    out[order] = s * decay_factor
    return out
