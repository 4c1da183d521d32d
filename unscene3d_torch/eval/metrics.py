"""Semantic metrics: confusion matrix and IoU (the port's own copy of
unscene3d_tpu/eval/metrics.py; reference models/metrics/confusionmatrix.py:
1-103, models/metrics/metrics.py:4). `conf/metrics/miou.yaml` names
`ConfusionMatrix`."""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.conf = np.zeros((num_classes, num_classes), np.int64)

    def reset(self):
        self.conf.fill(0)

    def add(self, predicted: np.ndarray, target: np.ndarray):
        """Count (target, predicted) pairs; ignored targets and labels
        outside [0, num_classes) are skipped."""
        predicted = np.asarray(predicted).reshape(-1)
        target = np.asarray(target).reshape(-1)
        keep = target != self.ignore_label
        predicted, target = predicted[keep], target[keep]
        keep = ((predicted >= 0) & (predicted < self.num_classes)
                & (target >= 0) & (target < self.num_classes))
        idx = target[keep] * self.num_classes + predicted[keep]
        self.conf += np.bincount(idx, minlength=self.num_classes ** 2
                                 ).reshape(self.num_classes, self.num_classes)

    def value(self) -> np.ndarray:
        return self.conf.copy()


def iou_from_confusion(conf: np.ndarray, ignore_index=None) -> np.ndarray:
    """Per-class IoU tp / (tp + fp + fn) (reference IoU metric); the rows
    and columns of `ignore_index` are zeroed first."""
    conf = np.asarray(conf, np.float64)
    if ignore_index is not None:
        conf = conf.copy()
        for i in np.atleast_1d(ignore_index):
            conf[:, i] = 0
            conf[i, :] = 0
    tp = np.diag(conf)
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        return tp / (tp + fp + fn)
