"""Visualization export: colored PLY point clouds and one HTML viewer per
scene (the port's own copy of unscene3d_tpu/eval/visualize.py).

In place of the reference's pyviz3d exports (trainer/trainer.py:197-357,
unscene3d_pseudo_main.py:601-644): input RGB, segments, instance masks and
feature PCA as self-contained PLY files, viewable in any mesh tool, and
`{scene}.html` (eval/html_viewer.py). `Experiment.evaluate` and
`PseudoMaskPipeline` write them under `visualizations/` when
`save_visualizations` is set. The files equal the JAX module's byte for
byte on the same inputs.
"""

from __future__ import annotations

import os

import numpy as np

from unscene3d_torch.data.ply import write_ply
from unscene3d_torch.eval.html_viewer import save_scene_html


def _id_colors(ids: np.ndarray) -> np.ndarray:
    ids = np.asarray(ids, np.int64)
    return np.stack([(ids * 217) % 256, (ids * 217) % 311 % 256,
                     (ids * 217) % 541 % 256], axis=1).astype(np.uint8)


def _instance_colors(masks: np.ndarray, seed: int = 0) -> np.ndarray:
    r = np.random.RandomState(seed)
    colors = np.zeros((masks.shape[0], 3), np.uint8)
    for k in reversed(range(masks.shape[1])):
        colors[masks[:, k].astype(bool)] = r.randint(0, 255, 3)
    return colors


def pca_colors(features: np.ndarray) -> np.ndarray:
    """(N, 3) uint8: the features' top three principal components, each
    scaled to [0, 255]."""
    x = features - features.mean(0)
    cov = (x.T @ x) / max(len(x) - 1, 1)
    _, vecs = np.linalg.eigh(cov)
    proj = x @ vecs[:, -3:]
    proj = proj - proj.min(0)
    proj = proj / np.maximum(proj.max(0), 1e-9)
    return (proj * 255).astype(np.uint8)


def save_scene_visualization(
    out_dir: str,
    scene_name: str,
    coords: np.ndarray,
    colors: np.ndarray | None = None,
    segments: np.ndarray | None = None,
    masks: np.ndarray | None = None,
    features: np.ndarray | None = None,
    html: bool = True,
):
    """Write `{scene}_rgb.ply`, `_segments.ply`, `_instances.ply` and
    `_pca.ply` for the layers given (masks only when there is one), and
    `{scene}.html` with all of them unless `html` is False."""
    os.makedirs(out_dir, exist_ok=True)
    layers: dict[str, np.ndarray] = {}
    if colors is not None:
        c = colors if colors.max() > 1.5 else colors * 255
        layers["rgb"] = c.astype(np.uint8)
    if segments is not None:
        layers["segments"] = _id_colors(segments)
    if masks is not None and masks.shape[1] > 0:
        layers["instances"] = _instance_colors(masks)
    if features is not None:
        layers["feature_pca"] = pca_colors(features)
    files = {"rgb": "rgb", "segments": "segments", "instances": "instances",
             "feature_pca": "pca"}
    for name, layer in layers.items():
        write_ply(os.path.join(out_dir, f"{scene_name}_{files[name]}.ply"),
                  coords, layer)
    if html and layers:
        save_scene_html(os.path.join(out_dir, f"{scene_name}.html"),
                        coords, layers)
