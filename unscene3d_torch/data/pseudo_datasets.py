"""Pseudo-mask data sets (the port's own copy of
unscene3d_tpu/data/pseudo_datasets.py; host-side numpy and threads): the
augmenting preparer, the ScanNetFree / ARKit / Stanford data sets, the
infinite sampler and the loader factory.

- `ScenePreparer`: `VoxelizationDataset.prepare_scene_data`
  (pseudo_masks/datasets/scannet.py:235-284): prevoxelization downsample,
  prevoxel elastic distortion, the augmenting `Voxelizer`, and the camera
  poses moved with the voxel-grid augmentation (scannet.py:255-258).
- `ScanNetFreeDataset` (pseudo_masks/datasets/scannet_free.py:27-371):
  `{scene}_cloud.npy` + `{scene}_masks.npy` pseudo masks (or oracle masks
  from the GT), the XY extent filter, FG/BG labels, instance ids and the
  SOLO-style grid targets.
- `ARKitPseudoDataset` (pseudo_masks/datasets/arkit.py:3-180): raw meshes,
  unreferenced-vertex cleanup, Felzenszwalb segments at several thresholds.
- `StanfordPseudoDataset` (pseudo_masks/datasets/s3dis.py): S3DIS plys with
  label / instance / segment properties, area splits, centered coordinates
  appended to the features.
- `InfSampler`, `PseudoDataLoader` and `initialize_data_loader`
  (pseudo_masks/datasets/dataloader.py:12-41, dataset.py:495-558).

The reference's quirks are kept, as the JAX module keeps them: ARKit's
vertex filter is the LAST threshold's segment validity alone
(arkit.py:118-127), and a `val` phase of ScanNetFree uses the oracle GT
masks unless `oracle_mode` says otherwise (scannet_free.py:89).

Unlike the JAX module, whose transforms and preparer draw from the global
`random` and `np.random` states, the draws come from one
`pseudo_transforms.HostRandom` (`ScenePreparer(rng=...)`,
`initialize_data_loader(rng=...)`, by default `HostRandom(seed)`): at
`num_workers=0` the items equal the JAX module's after
`random.seed(s); np.random.seed(s)` bitwise. `PseudoDataLoader` with
`num_workers > 0` runs `__getitem__` on worker threads that share that one
generator, so the order of the draws (and the items) then follows the
threads' schedule and may differ from `num_workers=0`; the JAX loader's
threads share the global state the same way.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from unscene3d_torch import native
from unscene3d_torch.data import pseudo_transforms as t
from unscene3d_torch.data.ply import read_ply
from unscene3d_torch.data.scannet_constants import VALID_CLASS_IDS_20
from unscene3d_torch.data.scannet_pseudo import ScanNetPseudoDataset
from unscene3d_torch.ops.hashing import sparse_quantize


# ---------------------------------------------------------------------------
# augmenting preparation (shared by every pseudo dataset)
# ---------------------------------------------------------------------------


class ScenePreparer:
    """prepare_scene_data (scannet.py:235-284): prevoxel downsample +
    distortion, augmenting voxelization, aug-consistent camera poses, label
    mapping, color normalization. The voxelizer and the random shift draw
    from `rng`."""

    def __init__(self, voxel_size: float = 0.02,
                 clip_bound=None,
                 use_augmentation: bool = False,
                 scale_augmentation_bound=(0.9, 1.1),
                 rotation_augmentation_bound=((-np.pi / 64, np.pi / 64),
                                              (-np.pi / 64, np.pi / 64),
                                              (-np.pi, np.pi)),
                 translation_augmentation_ratio_bound=((-0.2, 0.2),
                                                       (-0.2, 0.2),
                                                       (0, 0)),
                 prevoxelization_voxel_size: float | None = None,
                 prevoxel_transform=None,
                 input_transform=None,
                 target_transform=None,
                 label_mapper=None,
                 ignore_label: int = 255,
                 normalize_colors: bool = True,
                 rng: t.HostRandom | None = None):
        self.rng = rng if rng is not None else t.HostRandom()
        self.voxelizer = t.Voxelizer(
            voxel_size=voxel_size,
            clip_bound=clip_bound,
            use_augmentation=use_augmentation,
            scale_augmentation_bound=scale_augmentation_bound,
            rotation_augmentation_bound=rotation_augmentation_bound,
            translation_augmentation_ratio_bound=translation_augmentation_ratio_bound,
            ignore_label=ignore_label, rng=self.rng)
        self.prevoxelization_voxel_size = prevoxelization_voxel_size
        self.prevoxel_transform = prevoxel_transform
        self.input_transform = input_transform
        self.target_transform = target_transform
        self.label_mapper = label_mapper
        self.normalize_colors = normalize_colors

    def __call__(self, coords, feats, labels, instance_ids,
                 camera_poses=None, segment_ids=None):
        coords = np.asarray(coords, np.float64)
        feats = np.asarray(feats, np.float64)
        if self.prevoxelization_voxel_size is not None:
            _, inds, _ = sparse_quantize(coords, self.prevoxelization_voxel_size)
            coords, feats = coords[inds], feats[inds]
            labels = labels[inds]
            instance_ids = instance_ids[inds] if instance_ids is not None else None
            segment_ids = segment_ids[inds] if segment_ids is not None else None

        if self.prevoxel_transform is not None:
            coords, feats, _ = self.prevoxel_transform(
                coords, feats, np.arange(coords.shape[0]))

        coords, feats, vox_inds, transformations = self.voxelizer.voxelize(coords, feats)
        labels = labels[vox_inds]
        instance_ids = instance_ids[vox_inds] if instance_ids is not None else None
        segment_ids = segment_ids[vox_inds] if segment_ids is not None else None

        if camera_poses is not None:
            # keep poses consistent with the voxel-grid augmentation
            # (scannet.py:255-258): translation through the full M_v @ M_r,
            # orientation through the rotation only
            m_v, m_r = transformations
            camera_poses = np.array(camera_poses, np.float64)
            camera_poses[:, :, 3] = camera_poses[:, :, 3] @ (m_v @ m_r).T
            camera_poses[:, :3, :3] = m_r[:3, :3] @ camera_poses[:, :3, :3]

        if self.input_transform is not None:
            coords, feats, keep = self.input_transform(
                coords, feats, np.arange(coords.shape[0]))
            labels = labels[keep]
            instance_ids = instance_ids[keep] if instance_ids is not None else None
            segment_ids = segment_ids[keep] if segment_ids is not None else None
            rand_shift = (self.rng.np.rand(3) * 100).astype(coords.dtype)
            coords = coords + rand_shift
            if camera_poses is not None:
                camera_poses[:, :3, 3] += rand_shift

        if self.target_transform is not None:
            coords, feats, keep = self.target_transform(
                coords, feats, np.arange(coords.shape[0]))
            labels = labels[keep]
            instance_ids = instance_ids[keep] if instance_ids is not None else None
            segment_ids = segment_ids[keep] if segment_ids is not None else None

        if self.label_mapper is not None:
            labels = self.label_mapper(labels)
        if self.normalize_colors:
            feats = feats / 255.0 - 0.5
        return (coords.astype(np.float32), feats.astype(np.float32), labels,
                instance_ids, camera_poses, segment_ids, transformations)


# ---------------------------------------------------------------------------
# ScanNetFree: pseudo-mask / oracle FG-BG dataset
# ---------------------------------------------------------------------------


class ScanNetFreeDataset(ScanNetPseudoDataset):
    """FG/BG dataset over exported pseudo masks
    (pseudo_masks/datasets/scannet_free.py:27-371).

    Scenes are `{scene}_cloud.npy` (xyz+rgb columns) + `{scene}_masks.npy`
    (N, K) soft masks; oracle mode instead builds hard masks from the GT
    insseg instances whose mapped nyu40 label is not wall/floor/ignore.
    """

    CLASS_LABELS = ("background", "foreground")
    VALID_CLASS_IDS = (0, 1)
    INSTANCE_IGNORE_LABELS = (1, 2)        # nyu40 wall + floor
    ORACLE_INSTANCE_IGNORE_LABELS = (-1, 0, 1, 2)

    def __init__(self, masks_path: str, scannet_insseg_path: str,
                 scans_path: str | None = None, phase: str = "val",
                 oracle_mode: bool | None = None,
                 hard_mask_threshold: float = 0.5,
                 instance_to_scene_max_ratio: float = 0.8,
                 preparer: ScenePreparer | None = None,
                 label_tsv: str | None = None, **kw):
        super().__init__(scannet_insseg_path=scannet_insseg_path,
                         scans_path=scans_path, phase=phase, **kw)
        self.masks_path = masks_path
        # reference behavior: val phases always use oracle GT masks
        # (scannet_free.py:89); pass an explicit bool to override
        self.oracle_mode = (bool(oracle_mode) if oracle_mode is not None
                            else "val" in phase)
        self.hard_mask_threshold = hard_mask_threshold
        self.instance_to_scene_max_ratio = instance_to_scene_max_ratio
        self.preparer = preparer or ScenePreparer()
        # oracle label map: raw ScanNet id -> nyu40 id for the 20-class set
        # (scannet_free.py:88-103); identity-to-ignore outside it
        self._oracle_map = None
        if label_tsv and os.path.exists(label_tsv):
            import csv

            raw2nyu = {}
            with open(label_tsv, newline="") as f:
                for row in csv.DictReader(f, delimiter="\t"):
                    try:
                        nyu = int(row["nyu40id"])
                        raw2nyu[int(row["id"])] = (
                            nyu if nyu in VALID_CLASS_IDS_20 else -1)
                    except (KeyError, ValueError):
                        continue
            self._oracle_map = raw2nyu

    def _oracle_masks(self, scene_name):
        points, colors, sem, inst = self.get_full_cloud(scene_name)
        if self._oracle_map is not None:
            mapped = np.array([self._oracle_map.get(int(s), -1) for s in sem])
        else:
            # insseg .pth labels are already ScanNet200/nyu40-ish ids; treat
            # wall=1, floor=2 (+ negatives) as non-instances
            mapped = np.asarray(sem)
        valid = (~np.isin(mapped, self.ORACLE_INSTANCE_IGNORE_LABELS)) & (np.asarray(inst) >= 0)
        uniq = np.unique(np.asarray(inst)[valid])
        hard = np.zeros((len(points), len(uniq)), bool)
        for k, u in enumerate(uniq):
            hard[:, k] = np.asarray(inst) == u
        return points, colors, hard

    def load_unsupervised_scene(self, scene_name):
        """(scannet_free.py:264-353): cloud + hard masks + FG/BG labels."""
        if self.oracle_mode:
            coords, colors, hard = self._oracle_masks(scene_name)
        else:
            base = os.path.join(self.masks_path, scene_name)
            cloud = np.load(f"{base}_cloud.npy")
            coords = cloud[:, :3].astype(np.float32)
            # both exporters (ours and the reference, whose rgb concat is
            # commented out at trainer.py:755) save xyz-only clouds; fall
            # back to zero colors then
            colors = (cloud[:, 3:6].astype(np.float64)
                      if cloud.shape[1] >= 6 else
                      np.zeros((len(coords), 3), np.float64))
            soft = np.load(f"{base}_masks.npy")
            if soft.ndim == 1:
                soft = soft[:, None]
            hard = soft >= self.hard_mask_threshold

        # XY extent-ratio filter (scannet_free.py:322-338)
        keep_cols = []
        extents = coords.max(0) - coords.min(0)
        for k in range(hard.shape[1]):
            if not hard[:, k].any():
                continue
            inst_extent = coords[hard[:, k]].max(0) - coords[hard[:, k]].min(0)
            if np.any((inst_extent / np.maximum(extents, 1e-9))[:2] >
                      self.instance_to_scene_max_ratio):
                continue
            keep_cols.append(k)
        hard = hard[:, keep_cols]

        labels = np.zeros(len(coords), int)
        labels[hard.sum(-1) != 0] = 1
        instance_ids = np.zeros(len(coords), int)
        for k in range(hard.shape[1]):
            instance_ids[hard[:, k]] = k + 1
        return coords, colors, labels, instance_ids, hard

    def __getitem__(self, idx):
        scene_name = self.scenes[idx]
        coords, colors, labels, instance_ids, hard = \
            self.load_unsupervised_scene(scene_name)
        segment_ids, connectivity = None, None
        try:
            segs, connectivity = self.oversegment(scene_name, coords)
            segment_ids = np.stack(segs, axis=-1)
        except FileNotFoundError:
            pass
        colors = np.asarray(colors, np.float64)
        if colors.size and colors.max() <= 1.5:
            # insseg .pth files commonly store unit-scale colors
            # (scannet_pseudo.py:167-168 defends the same way)
            colors = colors * 255.0
        coords_v, feats, labels, instance_ids, poses, segment_ids, transforms = \
            self.preparer(coords, colors, labels,
                          instance_ids, None, segment_ids)
        return dict(scene_name=scene_name, coords=coords_v, feats=feats,
                    labels=labels, instance_ids=instance_ids,
                    segment_ids=segment_ids, segment_connectivity=connectivity,
                    transform=np.asarray(transforms[1], np.float32))

    # -- SOLO-style grid targets (scannet_free.py:104-261), segment branch --
    def generate_grid_targets(self, coords, labels, instance_ids, segment_ids,
                              min_grid_points: int = 10, ignore_label: int = -1):
        """Per-resolution grid proposals from segments: each sufficiently
        large segment becomes a grid cell labeled by its majority instance
        (or majority semantic label when no instance covers it)."""
        valid_inst = np.unique(instance_ids[(instance_ids > 0)])
        grid_dicts = []
        seg2d = segment_ids if segment_ids.ndim == 2 else segment_ids[:, None]
        grid_indices = np.full((coords.shape[0], seg2d.shape[1]), ignore_label, int)
        for res in range(seg2d.shape[1]):
            grid_d = {}
            for seg in np.unique(seg2d[:, res]):
                in_seg = seg2d[:, res] == seg
                if in_seg.sum() < min_grid_points:
                    continue
                grid_indices[in_seg, res] = seg
                best, best_n = None, 0
                for inst in np.intersect1d(np.unique(instance_ids[in_seg]), valid_inst):
                    n = int((in_seg & (instance_ids == inst)).sum())
                    if n > best_n:
                        best, best_n = inst, n
                if best is not None:
                    grid_d[int(seg)] = dict(label=1, inst_id=int(best),
                                            mask=instance_ids == best,
                                            grid_index=int(seg))
                else:
                    lab = labels[in_seg & (labels != ignore_label)]
                    if len(lab):
                        grid_d[int(seg)] = dict(
                            label=int(np.bincount(lab).argmax()),
                            mask=np.zeros(coords.shape[0], bool),
                            grid_index=int(seg))
            grid_dicts.append(grid_d)
        return grid_dicts, grid_indices


# ---------------------------------------------------------------------------
# ARKitScenes: raw meshes, no labels / images
# ---------------------------------------------------------------------------


class ARKitPseudoDataset:
    """ARKit mesh scenes (pseudo_masks/datasets/arkit.py:3-180)."""

    CLASS_LABELS = ("background", "foreground")
    VALID_CLASS_IDS = (0, 1)
    VOXEL_SIZE = 0.02

    def __init__(self, data_root: str, phase: str = "train",
                 segmentation_threshold: float = 0.005,
                 segments_min_vert_nums=(50,),
                 preparer: ScenePreparer | None = None):
        self.data_root = Path(data_root)
        split = self.data_root / f"{phase}.txt"
        if split.exists():
            self.data_paths = sorted(l.strip() for l in split.read_text().splitlines() if l.strip())
        else:
            self.data_paths = sorted(p.name for p in self.data_root.glob("*.ply"))
        self.scene_names = [Path(p).stem for p in self.data_paths]
        self.seg_threshold = segmentation_threshold
        self.seg_min_verts = tuple(segments_min_vert_nums)
        self.preparer = preparer or ScenePreparer(voxel_size=self.VOXEL_SIZE)

    def __len__(self):
        return len(self.data_paths)

    @staticmethod
    def clean_mesh(vertices, colors, faces):
        """Drop vertices unreferenced by any face and reindex
        (arkit.py:62-86)."""
        valid = np.unique(faces)
        removed = np.ones(len(vertices), bool)
        removed[valid] = False
        shift = np.cumsum(removed)
        faces = (faces - shift[faces]).astype(np.intc)
        return vertices[valid], colors[valid], faces

    @staticmethod
    def clean_segments(comps, min_vert_num=500):
        """(arkit.py:88-92): mask of vertices in sufficiently large segments."""
        uniq, counts = np.unique(comps, return_counts=True)
        invalid = uniq[counts < min_vert_num]
        return ~np.isin(comps, invalid)

    def load_scene_data(self, index):
        path = self.data_root / self.data_paths[index]
        mesh = read_ply(str(path))
        vertices = mesh["vertices"].astype(np.float32)
        colors = mesh.get("colors")
        colors = (colors.astype(np.float32) if colors is not None
                  else np.zeros((len(vertices), 3), np.float32))
        faces = mesh["faces"].astype(np.intc)
        vertices, colors, faces = self.clean_mesh(vertices, colors, faces)

        seg_list, conn_list = [], []
        valid = None
        for min_verts in self.seg_min_verts:
            seg, conn = native.segment_mesh(vertices, faces, colors / 255.0,
                                            self.seg_threshold,
                                            int(min_verts))
            seg_list.append(seg)
            conn_list.append(conn)
            # NOTE: only the LAST threshold's validity filters vertices —
            # replicating the reference verbatim (arkit.py:118-127 overwrites
            # valid_seg_indices each loop iteration the same way)
            valid = self.clean_segments(seg, min_vert_num=int(min_verts))
        segment_ids = np.stack(seg_list, axis=-1)

        vertices = vertices[valid]
        colors = colors[valid]
        segment_ids = segment_ids[valid]
        vertices = vertices - vertices.min(0)
        zeros = np.zeros(len(vertices), int)
        return (vertices, colors, zeros, zeros.copy(),
                self.scene_names[index], segment_ids, conn_list)

    def __getitem__(self, index):
        (coords, colors, labels, instance_ids, scene_name, segment_ids,
         connectivity) = self.load_scene_data(index)
        coords_v, feats, labels, instance_ids, _, segment_ids, transforms = \
            self.preparer(coords, np.asarray(colors, np.float64), labels,
                          instance_ids, None, segment_ids)
        return dict(scene_name=scene_name, coords=coords_v, feats=feats,
                    labels=labels, instance_ids=instance_ids,
                    segment_ids=segment_ids, segment_connectivity=connectivity,
                    transform=np.asarray(transforms[1], np.float32))


# ---------------------------------------------------------------------------
# Stanford / S3DIS
# ---------------------------------------------------------------------------


class StanfordPseudoDataset:
    """S3DIS areas (pseudo_masks/datasets/s3dis.py): ply scenes with
    label/instance_id/segment_id vertex properties; area-5 validation. The
    default preparer draws from `rng`."""

    NUM_LABELS = 14
    IGNORE_LABELS = (10,)  # stairs, following SegCloud
    VOXEL_SIZE = 0.05
    CLIP_BOUND = 4
    ROTATION_AUGMENTATION_BOUND = ((-np.pi / 32, np.pi / 32),
                                   (-np.pi / 32, np.pi / 32),
                                   (-np.pi, np.pi))
    TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.2, 0.2),
                                            (-0.05, 0.05))
    AUGMENT_COORDS_TO_FEATS = True

    PHASE_AREAS = {
        "train": ("area1", "area2", "area3", "area4", "area6"),
        "trainval": ("area1", "area2", "area3", "area4", "area5", "area6"),
        "val": ("area5",),
        "test": ("area5",),
    }

    def __init__(self, data_root: str, phase: str = "train",
                 preparer: ScenePreparer | None = None,
                 augment_data: bool = False,
                 rng: t.HostRandom | None = None):
        self.data_root = Path(data_root)
        paths = []
        for area in self.PHASE_AREAS[phase if phase in self.PHASE_AREAS else "train"]:
            split = self.data_root / f"{area}.txt"
            if split.exists():
                paths += [l.strip() for l in split.read_text().splitlines() if l.strip()]
            else:
                paths += sorted(str(p.relative_to(self.data_root))
                                for p in self.data_root.glob(f"{area}/*.ply"))
        self.data_paths = paths
        self.scene_names = [p.replace("/", "_").replace(".ply", "") for p in paths]
        clip = self.CLIP_BOUND if "train" in phase else None
        self.preparer = preparer or ScenePreparer(
            voxel_size=self.VOXEL_SIZE, clip_bound=clip,
            use_augmentation=augment_data,
            rotation_augmentation_bound=self.ROTATION_AUGMENTATION_BOUND,
            translation_augmentation_ratio_bound=self.TRANSLATION_AUGMENTATION_RATIO_BOUND,
            label_mapper=self._map_labels, rng=rng)
        # label remap: valid ids -> contiguous, ignore stairs
        remap = {}
        out = 0
        for lab in range(self.NUM_LABELS):
            if lab in self.IGNORE_LABELS:
                remap[lab] = 255
            else:
                remap[lab] = out
                out += 1
        self._remap = remap

    def _map_labels(self, labels):
        return np.vectorize(lambda x: self._remap.get(int(x), 255))(labels)

    def __len__(self):
        return len(self.data_paths)

    def load_ply(self, index):
        path = self.data_root / self.data_paths[index]
        ply = read_ply(str(path))
        coords = ply["vertices"].astype(np.float32)
        feats = ply.get("colors")
        feats = (feats.astype(np.float32) if feats is not None
                 else np.zeros((len(coords), 3), np.float32))
        vd = ply.get("vertex_data")
        names = vd.dtype.names if vd is not None else ()

        def field(name):
            if name in names:
                return np.asarray(vd[name], np.int32)
            return np.zeros(len(coords), np.int32)

        labels = field("label")
        instances = field("instance_id")
        segments = field("segment_id")
        coords -= coords.min(0, keepdims=True)
        return coords, feats, labels, instances, segments

    @staticmethod
    def augment_coords_to_feats(coords, feats):
        """Append xy-centered coordinates to the features
        (s3dis.py:35-40)."""
        center = coords.mean(0, keepdims=True).copy()
        center[0, 2] = 0
        return np.concatenate([feats, coords - center], 1)

    def __getitem__(self, index):
        coords, feats, labels, instances, segments = self.load_ply(index)
        coords_v, feats_v, labels, instances, _, segments, transforms = \
            self.preparer(coords, np.asarray(feats, np.float64), labels,
                          instances, None, segments)
        if self.AUGMENT_COORDS_TO_FEATS:
            feats_v = self.augment_coords_to_feats(coords_v, feats_v).astype(np.float32)
        return dict(scene_name=self.scene_names[index], coords=coords_v,
                    feats=feats_v, labels=labels, instance_ids=instances,
                    segment_ids=segments, segment_connectivity=None,
                    transform=np.asarray(transforms[1], np.float32))


# ---------------------------------------------------------------------------
# sampler + loader factory
# ---------------------------------------------------------------------------


class InfSampler:
    """Infinite shuffled index stream without replacement per cycle
    (pseudo_masks/datasets/dataloader.py:12-41)."""

    def __init__(self, data_source, shuffle=False, seed=None):
        self.n = len(data_source)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._reset()

    def _reset(self):
        # pop() draws from the tail (reference dataloader.py:32-36), so the
        # non-shuffle order is stored reversed to stream ascending
        self._perm = (list(self._rng.permutation(self.n)) if self.shuffle
                      else list(range(self.n - 1, -1, -1)))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._perm:
            self._reset()
        return int(self._perm.pop())

    def __len__(self):
        return self.n


class PseudoDataLoader:
    """Thread-pooled batched loader (the torch-DataLoader role,
    dataset.py:545-557): workers run the numpy __getitem__ concurrently,
    batches are lists of scene dicts (the consumer collates them)."""

    def __init__(self, dataset, batch_size=1, num_workers=0, shuffle=False,
                 repeat=False, seed=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.repeat = repeat
        self.sampler = InfSampler(dataset, shuffle, seed) if repeat else None
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def _indices(self):
        if self.repeat:
            while True:
                yield next(self.sampler)
        else:
            order = (self._rng.permutation(len(self.dataset)) if self.shuffle
                     else range(len(self.dataset)))
            yield from order

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        batch_idx = []
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.num_workers) as pool:
                pending = []
                for i in self._indices():
                    pending.append(pool.submit(self.dataset.__getitem__, int(i)))
                    if len(pending) == self.batch_size:
                        yield [f.result() for f in pending]
                        pending = []
                if pending:
                    yield [f.result() for f in pending]
        else:
            for i in self._indices():
                batch_idx.append(self.dataset[int(i)])
                if len(batch_idx) == self.batch_size:
                    yield batch_idx
                    batch_idx = []
            if batch_idx:
                yield batch_idx


DATASETS = {
    "ScanNetPseudoDataset": ScanNetPseudoDataset,
    "ScanNetFreeDataset": ScanNetFreeDataset,
    "ScanNetFree_2cmDataset": ScanNetFreeDataset,
    "ARKitPseudoDataset": ARKitPseudoDataset,
    "ARKit_2cmDataset": ARKitPseudoDataset,
    "StanfordPseudoDataset": StanfordPseudoDataset,
    # the reference's 5cm variant IS the base config (s3dis.py VOXEL_SIZE)
    "Stanford5cmPseudoDataset": StanfordPseudoDataset,
}


def load_dataset(name: str):
    if name not in DATASETS:
        raise KeyError(f"unknown pseudo dataset {name!r}; known: {sorted(DATASETS)}")
    return DATASETS[name]


def initialize_data_loader(DatasetClass, phase, num_workers, shuffle, repeat,
                           augment_data, batch_size, dataset_kwargs=None,
                           elastic_distortion_params=((0.2, 0.4), (0.8, 1.6)),
                           color_trans_ratio=0.1, color_jitter_std=0.05,
                           hue_max=0.5, saturation_max=0.2, seed=None,
                           rng: t.HostRandom | None = None):
    """Wire the reference's transform stack (dataset.py:495-558) and return a
    PseudoDataLoader. The transforms and the preparer draw from `rng`
    (default `HostRandom(seed)`); `seed` also seeds the loader's order."""
    rng = rng if rng is not None else t.HostRandom(seed)
    prevoxel = (t.Compose([t.ElasticDistortion(elastic_distortion_params,
                                               rng=rng)])
                if augment_data else None)
    input_tf = None
    if augment_data:
        input_tf = t.Compose([
            t.RandomDropout(0.2, rng=rng),
            t.RandomHorizontalFlip("z", False, rng=rng),
            t.ChromaticAutoContrast(rng=rng),
            t.ChromaticTranslation(color_trans_ratio, rng=rng),
            t.ChromaticJitter(color_jitter_std, rng=rng),
            t.HueSaturationTranslation(hue_max, saturation_max, rng=rng),
        ])
    kwargs = dict(dataset_kwargs or {})
    preparer = kwargs.pop("preparer", None)
    if preparer is None:
        voxel = kwargs.pop("voxel_size", getattr(DatasetClass, "VOXEL_SIZE", 0.02))
        preparer = ScenePreparer(voxel_size=voxel,
                                 use_augmentation=augment_data,
                                 prevoxel_transform=prevoxel,
                                 input_transform=input_tf, rng=rng)
    if "preparer" in DatasetClass.__init__.__code__.co_varnames:
        kwargs["preparer"] = preparer
    dataset = DatasetClass(phase=phase, **kwargs)
    return PseudoDataLoader(dataset, batch_size=batch_size,
                            num_workers=num_workers, shuffle=shuffle,
                            repeat=repeat, seed=seed)
