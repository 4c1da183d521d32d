"""Similarity, whitening and the geometric clustering baseline (the port's
own copy of unscene3d_tpu/pseudo/freemask_utils.py; reference
utils/freemask_utils.py:8-91 and pseudo_masks/unscene3d_pseudo_main.py:
156-178).

`lidar_3duis` clusters with the port's HDBSCAN (pseudo/hdbscan.py), whose
labels equal scikit-learn's `HDBSCAN` at its defaults: the GPU machine has
no scikit-learn.
"""

from __future__ import annotations

import numpy as np

from unscene3d_torch.pseudo.hdbscan import hdbscan_labels


def cosine_sim(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Min-max-normalized cosine similarity of the rows of a (A, D) with
    those of b (B, D): (A, B) (utils/freemask_utils.py:8-18)."""
    an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    s = an @ bn.T
    s = s - s.min()
    return s / max(s.max(), 1e-12)


def l2_sim(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Min-max-normalized negative L2 distance (freemask_utils.py:20)."""
    d = ((a[:, None] - b[None]) ** 2).sum(-1)
    s = -d
    s = s - s.min()
    return s / max(s.max(), 1e-12)


def whiten_feats(feats: np.ndarray) -> np.ndarray:
    """ZCA whitening (reference unscene3d_pseudo_main.py:163-178): normalize,
    demean, whiten with U diag(lambda^-1/2) U^T, re-add the mean, scale to
    unit max magnitude."""
    f = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12)
    y = f.T + 1e-7                       # (D, N)
    mu = y.mean(-1, keepdims=True)
    y = y - mu
    n = y.shape[-1]
    cov = (y @ y.T) / (n - 1)
    u, lam, _ = np.linalg.svd(cov)
    zca = u @ np.diag(lam ** -0.5) @ u.T
    z = zca @ y
    white = (mu + z).T
    return white / np.abs(white).max()


def lidar_3duis(coords: np.ndarray, min_cluster_size: int = 20) -> np.ndarray:
    """HDBSCAN geometric clustering baseline (freemask_utils.py:38): -1 for
    noise, else the cluster id."""
    return hdbscan_labels(coords, min_cluster_size)
