"""ScanNet-benchmark submission format writer (the port's own copy of
unscene3d_tpu/eval/benchmark_export.py:export_predictions; reference
trainer/trainer.py:168-187), for `general.export`.

On-disk layout, byte-compatible with the reference so its own evaluation
tooling can consume the predictions:

  {base}/{scene}.txt             lines: "pred_mask/{scene}_{i}.txt <label> <score>"
  {base}/pred_mask/{scene}_{i}.txt   one 0/1 per point line
"""

from __future__ import annotations

import os

import numpy as np


def export_predictions(base_path: str, scene: str, masks: np.ndarray,
                       classes: np.ndarray, scores: np.ndarray,
                       score_threshold: float = 0.0) -> None:
    """Write one scene's predictions in the reference's submission format.
    masks: (P, K) bool/uint8; classes/scores: (K,)."""
    pred_mask_path = os.path.join(base_path, "pred_mask")
    os.makedirs(pred_mask_path, exist_ok=True)
    with open(os.path.join(base_path, f"{scene}.txt"), "w") as fout:
        for i in range(masks.shape[1]):
            if scores[i] <= score_threshold and score_threshold > 0:
                continue
            np.savetxt(os.path.join(pred_mask_path, f"{scene}_{i}.txt"),
                       masks[:, i].astype(np.uint8), fmt="%d")
            fout.write(f"pred_mask/{scene}_{i}.txt {int(classes[i])} "
                       f"{float(scores[i])}\n")
