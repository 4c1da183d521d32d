"""Labeled instance-segmentation data sets (the port's own copy of
unscene3d_tpu/data/semseg_dataset.py; reference datasets/semseg.py:27 and
datasets/outdoor_semseg.py:14), the `_target_`s of conf/data/datasets/
scannet, scannet200, s3dis, matterport, matterport_scannet, rio, stpls3d
and semantic_kitti.

They read the Mask3D npy format of FreeMaskDataset (`{mode}_database.yaml`
plus 12-column scene `.npy`: xyz, rgb 0-255, normal, segment, label,
instance) and build the targets from the (label, instance) columns
(reference get_instance_masks, datasets/utils.py:529-613): one mask per
instance id != -1 with that instance's label, the classes of
`filter_out_classes` dropped, small ignore-label instances dropped, and
for `task="semantic_segmentation"` one mask per label.

One `RandomState` (from `seed`) serves the augmentations in the JAX
package's order, so both give the same scene for the same index and state;
`reseed(seed)` restarts it (a data-parallel rank other than 0 draws from
its own seed, train/experiment.py). Like the port's FreeMaskDataset, and
unlike the JAX one, a relative `filepath` that does not exist from the
working directory is read under `data_dir`.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import yaml

from unscene3d_torch.data.augmentations import (
    TrainAugmentation,
    append_unlabeled_scene,
    normalize_color,
    oversample_instances,
)
from unscene3d_torch.data.freemask_dataset import COLOR_MEAN, COLOR_STD


class SemanticSegmentationDataset:
    def __init__(
        self,
        data_dir: str,
        mode: str = "train",
        add_colors: bool = True,
        add_normals: bool = False,
        num_labels: int = 20,
        ignore_label: int = 255,
        filter_out_classes: tuple = (),
        ignore_class_threshold: int = 100,
        label_offset: int = 0,
        task: str = "instance_segmentation",
        augment: bool | None = None,
        seed: int = 0,
        flip_in_center: bool = False,
        point_per_cut: int = 0,
        max_cut_region: float = 0.0,
        resample_points: float = 0.0,
        noise_rate: float = 0.0,
        instance_oversampling: float = 0.0,
        place_around_existing: bool = False,
        add_unlabeled_pc: bool = False,
        volume_augmentations_path: str | None = None,
        image_augmentations_path: str | None = None,
        **_,
    ):
        self.data_dir = data_dir
        self.mode = mode
        self.add_colors = add_colors
        self.add_normals = add_normals
        self.num_labels = num_labels
        self.ignore_label = ignore_label
        self.filter_out_classes = set(filter_out_classes)
        self.ignore_class_threshold = ignore_class_threshold
        self.label_offset = label_offset
        self.task = task
        self.augment = ("train" in mode) if augment is None else augment
        self.seed = int(seed)
        self.reseed(self.seed)
        self.instance_oversampling = float(instance_oversampling)
        self.place_around_existing = bool(place_around_existing)
        self.add_unlabeled_pc = bool(add_unlabeled_pc)
        self.augmentation = TrainAugmentation(
            flip_in_center=bool(flip_in_center),
            point_per_cut=int(point_per_cut),
            max_cut_region=float(max_cut_region),
            resample_points=float(resample_points),
            noise_rate=float(noise_rate),
            ignore_label=int(ignore_label),
            volume_augmentations_path=volume_augmentations_path,
            image_augmentations_path=image_augmentations_path,
        )

        db_mode = {"train": "train", "validation": "validation",
                   "test": "validation"}.get(mode, mode)
        with open(os.path.join(data_dir, f"{db_mode}_database.yaml")) as f:
            self.data = yaml.safe_load(f)

    def reseed(self, seed: int) -> None:
        """Restart the augmentation draws from `seed`."""
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.data)

    def scene_sizes(self) -> list[int]:
        """Per-scene point counts from the database yaml (`file_len`), -1
        where it has none."""
        return [int(e.get("file_len", -1) or -1) for e in self.data]

    def _path(self, entry) -> str:
        path = entry["filepath"].replace("../../", "")
        if not os.path.isabs(path) and not os.path.exists(path):
            path = os.path.join(self.data_dir, path)
        return path

    def _load_points(self, entry) -> np.ndarray:
        return np.load(self._path(entry))

    def __getitem__(self, idx: int) -> dict:
        entry = self.data[idx % len(self.data)]
        path = self._path(entry)
        points = np.load(path)
        coords = points[:, :3].astype(np.float32)
        colors01 = points[:, 3:6].astype(np.float32) / 255.0
        normals = points[:, 6:9].astype(np.float32)
        segments = points[:, 9].astype(np.int64)
        labels = points[:, 10].astype(np.int64)
        instances = points[:, 11].astype(np.int64)

        masks, mask_labels = self._instance_masks(labels, instances)
        scene = dict(
            xyz=coords, colors=colors01, normals=normals, segments=segments,
            masks=masks, mask_labels=mask_labels,
            labels=labels, instances=instances,
            name=Path(entry.get("raw_filepath", path)).parent.name
            if entry.get("raw_filepath") else Path(path).stem,
        )
        if self.augment:
            if self.instance_oversampling > 0:
                scene = oversample_instances(
                    scene, self.data, self._load_points,
                    self.instance_oversampling, self.place_around_existing,
                    self.rng)
            scene = self.augmentation(scene, self.rng)
            if self.add_unlabeled_pc and self.rng.rand() < 0.8:
                scene = append_unlabeled_scene(
                    scene, self.data, self._load_points, self.rng,
                    self.ignore_label)
        else:
            scene["features"] = normalize_color(colors01, COLOR_MEAN, COLOR_STD)
        if self.add_normals:
            scene["features"] = np.hstack(
                [scene["features"], np.asarray(scene["normals"])])
        if not self.add_colors:
            scene["features"] = np.ones_like(scene["features"])
        return scene

    def _instance_masks(self, labels, instances):
        """(masks (P, K) bool, labels (K,) int64) of the scene's instances
        (reference get_instance_masks)."""
        mask_list, label_list = [], []
        for iid in np.unique(instances):
            if iid == -1:
                continue
            sel = instances == iid
            label = int(labels[sel][0])
            if label in self.filter_out_classes:
                continue
            if (255 in self.filter_out_classes and label == 255
                    and sel.sum() < self.ignore_class_threshold):
                continue
            mask_list.append(sel)
            label_list.append(max(label - self.label_offset, 0))
        if not mask_list:
            return np.zeros((len(labels), 0), bool), np.zeros(0, np.int64)
        masks = np.stack(mask_list, 1)
        out_labels = np.asarray(label_list, np.int64)
        if self.task == "semantic_segmentation":
            merged_m, merged_l = [], []
            for label in np.unique(out_labels):
                merged_m.append(masks[:, out_labels == label].any(1))
                merged_l.append(label)
            masks = np.stack(merged_m, 1)
            out_labels = np.asarray(merged_l, np.int64)
        return masks, out_labels


class LidarDataset(SemanticSegmentationDataset):
    """Outdoor LiDAR (SemanticKITTI) data set (reference
    datasets/outdoor_semseg.py:14): the same Mask3D npy layout, written by
    preprocessing/semantic_kitti_preprocessing.py with the remission in the
    color columns; the augmentation skips the color jitter and the elastic
    distortion."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.augmentation.color_jitter_std = 0.0
        self.augmentation.elastic_p = 0.0
