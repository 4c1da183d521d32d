"""ScanNet data set for pseudo-mask generation (the port's counterpart of
unscene3d_tpu/data/scannet_pseudo.py; numpy on the host).

Reference: pseudo_masks/datasets/scannet.py:126-296 (ScanNet_2cmDataset) and
pseudo_masks/datasets/dataset.py:234-384. Loads the scannet200_insseg `.pth`
scenes ((points, colors, sem_labels, instance_ids) tuples), axis-aligns them
with the scene's meta file, voxelizes at 2 cm, runs the Felzenszwalb mesh
oversegmentation (the native library's `segment_mesh`) and, for the 2D
modalities, loads the RGB frames, camera poses and scaled intrinsics.

Unlike the JAX package, `load_frames` raises when a scene has no `color/`
directory or PIL is missing: a scene that asks for images never goes on
without them.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
from scipy.spatial import KDTree

from unscene3d_torch import native
from unscene3d_torch.data.ply import read_ply
from unscene3d_torch.ops.hashing import sparse_quantize

VOXEL_SIZE = 0.02


def load_axis_alignment(meta_file: str) -> np.ndarray | None:
    """The 4 x 4 axisAlignment of a ScanNet `scene*.txt` meta file, or None
    when the file or the line is absent."""
    if not os.path.exists(meta_file):
        return None
    with open(meta_file) as f:
        for line in f:
            if line.startswith("axisAlignment"):
                vals = [float(x) for x in line.split("=")[1].split()]
                return np.asarray(vals, np.float64).reshape(4, 4)
    return None


def apply_alignment(points: np.ndarray, mat: np.ndarray | None) -> np.ndarray:
    if mat is None:
        return points
    homo = np.column_stack([points, np.ones(len(points))])
    return (homo @ mat.T)[:, :3]


class ScanNetPseudoDataset:
    def __init__(
        self,
        scannet_insseg_path: str,
        scans_path: str | None = None,
        phase: str = "train",
        align_scenes: bool = True,
        segmentation_threshold: float = 0.005,
        segments_min_vert_nums: tuple = (50,),
        use_images: bool = False,
        image_resolution: tuple = (480, 640),
        downsample_ratio: float = 0.4,
        frame_skip: int = 20,
    ):
        self.root = scannet_insseg_path
        self.scans_path = scans_path
        self.align_scenes = align_scenes
        self.seg_threshold = segmentation_threshold
        self.seg_min_verts = tuple(segments_min_vert_nums)
        self.use_images = use_images
        self.image_resolution = tuple(image_resolution)
        self.downsample_ratio = downsample_ratio
        self.frame_skip = frame_skip
        self.depth_shape = (
            int(image_resolution[0] * downsample_ratio),
            int(image_resolution[1] * downsample_ratio),
        )
        split_file = os.path.join(self.root, f"{phase}.txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                self.scenes = [ln.strip() for ln in f if ln.strip()]
        else:
            self.scenes = sorted(p.stem for p in Path(self.root).glob("*.pth"))

    def __len__(self):
        return len(self.scenes)

    def _meta(self, scene_name: str) -> str:
        return os.path.join(self.scans_path, scene_name, f"{scene_name}.txt")

    def get_full_cloud(self, scene_name: str):
        """(points (P, 3) f64, colors, semantic labels, instance ids) of the
        scene's `.pth`, axis-aligned when asked."""
        path = os.path.join(self.root, f"{scene_name}.pth")
        # the reference's format: a pickled tuple of numpy arrays
        data = torch.load(path, map_location="cpu", weights_only=False)
        points, colors, sem, inst = [np.asarray(x) for x in data[:4]]
        if self.align_scenes and self.scans_path:
            points = apply_alignment(points,
                                     load_axis_alignment(self._meta(scene_name)))
        return points, colors, sem, inst

    def oversegment(self, scene_name: str, points: np.ndarray):
        """Felzenszwalb oversegmentation of the scan mesh, one per
        `segments_min_vert_nums` entry, KD-tree matched to `points`
        (reference scannet.py:156-197). Returns (per-point segment ids,
        segment connectivity) lists."""
        mesh_path = None
        if self.scans_path:
            cand = os.path.join(self.scans_path, scene_name,
                                f"{scene_name}_vh_clean_2.ply")
            if os.path.exists(cand):
                mesh_path = cand
        if mesh_path is None:
            raise FileNotFoundError(f"no mesh for {scene_name}")
        mesh = read_ply(mesh_path)
        verts = mesh["vertices"].astype(np.float32)
        if self.align_scenes:
            verts = apply_alignment(
                verts, load_axis_alignment(self._meta(scene_name))
            ).astype(np.float32)
        colors = mesh.get("colors")
        colors = (colors.astype(np.float32) / 255.0 if colors is not None
                  else np.zeros((len(verts), 3), np.float32))
        seg_list, conn_list = [], []
        for min_verts in self.seg_min_verts:
            seg, conn = native.segment_mesh(
                verts, mesh["faces"].astype(np.int32), colors,
                self.seg_threshold, int(min_verts))
            seg_list.append(seg)
            conn_list.append(conn)
        _, match = KDTree(verts).query(points, k=1)
        return [s[match] for s in seg_list], conn_list

    def load_frames(self, scene_name: str):
        """(images (V, h, w, 3) f32 in [0, 1], camera-to-world poses
        (V, 4, 4), color intrinsics scaled to (h, w)) from the exported
        layout scans/{scene}/color/*.jpg, pose/*.txt,
        intrinsic/intrinsic_color.txt, every `frame_skip`-th frame
        (reference scannet.py:126-154). Raises when the scene has no
        `color/` directory or PIL is missing."""
        base = os.path.join(self.scans_path, scene_name)
        color_dir = os.path.join(base, "color")
        pose_dir = os.path.join(base, "pose")
        if not os.path.isdir(color_dir):
            raise FileNotFoundError(f"{scene_name}: no frame directory "
                                    f"{color_dir}")
        frames = sorted(os.listdir(color_dir))[:: self.frame_skip]
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"{scene_name}: reading its frames needs PIL"
                              ) from e
        h, w = self.depth_shape
        images, poses = [], []
        for fr in frames:
            img = Image.open(os.path.join(color_dir, fr)).resize((w, h))
            images.append(np.asarray(img, np.float32) / 255.0)
            poses.append(np.loadtxt(os.path.join(pose_dir,
                                                 Path(fr).stem + ".txt")))
        K = np.loadtxt(os.path.join(base, "intrinsic",
                                    "intrinsic_color.txt"))[:3, :3]
        scale = np.array([w / self.image_resolution[1],
                          h / self.image_resolution[0], 1.0])
        return np.stack(images), np.stack(poses), K * scale[:, None]

    def __getitem__(self, idx: int) -> dict:
        scene_name = self.scenes[idx]
        points, colors, sem, inst = self.get_full_cloud(scene_name)
        vox_coords, unique_map, inverse_map = sparse_quantize(points,
                                                              VOXEL_SIZE)
        segs_full, conns = self.oversegment(scene_name, points)
        out = dict(
            scene_name=scene_name,
            full_coords=points.astype(np.float32),
            full_colors=colors.astype(np.float32),
            full_labels=sem,
            full_instances=inst,
            coords=vox_coords,
            feats=(colors[unique_map].astype(np.float32) / 255.0 - 0.5)
            if colors.max() > 1.5 else colors[unique_map] - 0.5,
            segment_ids=[s[unique_map] for s in segs_full],
            segment_connectivity=conns,
            inverse_map=inverse_map,
            unique_map=unique_map,
        )
        if self.use_images:
            images, poses, K = self.load_frames(scene_name)
            out.update(images=images, poses=poses, intrinsics=K)
        return out
