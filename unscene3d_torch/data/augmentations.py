"""Geometric + color augmentations (host-side numpy; the port's own copy of
unscene3d_tpu/data/augmentations.py).

The reference's train-time pipeline (datasets/freemask_semseg.py:334-406 +
datasets/semseg.py:651-707 + conf/augmentation yamls): recenter + random
shift, axis flips, two-scale elastic distortion, random z rotation / slight
xy tilts / uniform scale, color jitter, color normalization and color drop.
Every function draws from the `RandomState` it is given in the JAX
package's order, so the same state gives the same scene bitwise
(tests/test_torch_data.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.interpolate
import scipy.ndimage


def elastic_distortion(coords: np.ndarray, granularity: float, magnitude: float,
                       rng: np.random.RandomState) -> np.ndarray:
    """Standard sparse-conv elastic distortion (reference semseg.py:651-688):
    blurred Gaussian noise grid, trilinearly interpolated displacement."""
    blurs = [
        np.ones((3, 1, 1, 1), np.float32) / 3,
        np.ones((1, 3, 1, 1), np.float32) / 3,
        np.ones((1, 1, 3, 1), np.float32) / 3,
    ]
    coords_min = coords.min(0)
    noise_dim = ((coords - coords_min).max(0) // granularity).astype(int) + 3
    noise = rng.randn(*noise_dim, 3).astype(np.float32)
    for _ in range(2):
        for blur in blurs:
            noise = scipy.ndimage.convolve(noise, blur, mode="constant", cval=0)
    ax = [
        np.linspace(d_min, d_max, d)
        for d_min, d_max, d in zip(
            coords_min - granularity,
            coords_min + granularity * (noise_dim - 2),
            noise_dim,
        )
    ]
    interp = scipy.interpolate.RegularGridInterpolator(
        ax, noise, bounds_error=False, fill_value=0
    )
    return coords + interp(coords) * magnitude


def rotation_matrix(rng: np.random.RandomState, max_z=2 * np.pi,
                    max_xy=np.pi / 64) -> np.ndarray:
    """Random rotation: full range about z, slight tilts about x/y (matching
    the reference's volumentations config)."""
    az = rng.uniform(0, max_z)
    ax = rng.uniform(-max_xy, max_xy)
    ay = rng.uniform(-max_xy, max_xy)
    cz, sz = np.cos(az), np.sin(az)
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return rz @ ry @ rx


@dataclasses.dataclass
class TrainAugmentation:
    """Applies the reference's train pipeline to a scene dict.

    Option surface mirrors the reference dataset flags
    (datasets/semseg.py:386-455): flip_in_center, point_per_cut /
    max_cut_region, resample_points / noise_rate; plus optional yaml-driven
    volumentations / albumentations pipelines replacing the built-in
    rotate/scale and color-jitter defaults."""

    flip_p: float = 0.5
    elastic_p: float = 0.95
    elastic_params: tuple = ((0.2, 0.4), (0.8, 1.6))
    rotate: bool = True
    scale_range: tuple = (0.9, 1.1)
    color_jitter_std: float = 0.05
    color_drop_p: float = 0.0
    color_mean: tuple = (0.47793125906962, 0.4303257521323044, 0.3749598901421883)
    color_std: tuple = (0.2834475483823543, 0.27566157565723015, 0.27018971370874995)
    flip_in_center: bool = False
    point_per_cut: int = 0
    max_cut_region: float = 0.0
    resample_points: float = 0.0
    noise_rate: float = 0.0
    ignore_label: int = 255
    volume_augmentations_path: str | None = None
    image_augmentations_path: str | None = None

    def __post_init__(self):
        self._volume_augs = (VolumeAugmentations(self.volume_augmentations_path)
                             if self.volume_augmentations_path else None)
        self._image_augs = (ImageAugmentations(self.image_augmentations_path)
                            if self.image_augmentations_path else None)

    def __call__(self, scene: dict, rng: np.random.RandomState) -> dict:
        coords = np.asarray(scene["xyz"], np.float64).copy()
        colors = np.asarray(scene["colors"], np.float64).copy()

        orig_max = coords.max(0)
        coords -= coords.mean(0)
        coords += rng.uniform(coords.min(0), coords.max(0)) / 2

        if self.flip_in_center:
            coords = flip_in_center(coords)

        for i in (0, 1):  # axis flips (reference :349-352)
            if rng.rand() < self.flip_p:
                coords[:, i] = orig_max[i] - coords[:, i]

        if rng.rand() < self.elastic_p:
            for granularity, magnitude in self.elastic_params:
                coords = elastic_distortion(coords, granularity, magnitude, rng)

        if self._volume_augs is not None:
            coords = self._volume_augs(coords, rng)
        else:
            if self.rotate:
                coords = coords @ rotation_matrix(rng).T
            coords = coords * rng.uniform(*self.scale_range)

        if self._image_augs is not None:
            colors = self._image_augs(colors, rng)
        else:
            # color jitter (unit-scale colors in [0,1])
            colors = colors + rng.normal(0, self.color_jitter_std, colors.shape)
            colors = colors.clip(0, 1)
        if rng.rand() < self.color_drop_p:
            colors[:] = 1.0

        out = dict(scene)
        out["xyz"] = coords.astype(np.float32)
        out["colors"] = colors.astype(np.float32)

        if self.point_per_cut > 0:
            out = cut_point_regions(out, rng, self.point_per_cut,
                                    self.max_cut_region)
        if self.resample_points > 0 or self.noise_rate > 0:
            out = random_around_points(out, rng, self.resample_points,
                                       self.noise_rate, self.ignore_label)

        out["features"] = normalize_color(out["colors"], self.color_mean,
                                          self.color_std)
        return out


def normalize_color(colors01: np.ndarray, mean, std) -> np.ndarray:
    """albumentations.Normalize semantics on unit-scale colors."""
    return ((colors01 - np.asarray(mean)) / np.asarray(std)).astype(np.float32)


@dataclasses.dataclass
class RandomCuboid:
    """Random cuboid crop keeping a minimum fraction of points (reference
    datasets/random_cuboid.py:17): sample an axis-aligned XY crop whose size
    is a random fraction of the scene extent, retry until enough points (and
    optionally enough instance points) survive."""

    min_points: int = 30000
    crop_length: float = 6.0
    max_tries: int = 10

    def __call__(self, xyz: np.ndarray, rng: np.random.RandomState,
                 must_keep: np.ndarray | None = None) -> np.ndarray:
        """Returns a bool keep-mask over points."""
        for _ in range(self.max_tries):
            center = xyz[rng.randint(len(xyz))][:2]
            half = self.crop_length / 2
            keep = (np.abs(xyz[:, 0] - center[0]) < half) & \
                   (np.abs(xyz[:, 1] - center[1]) < half)
            if keep.sum() >= min(self.min_points, len(xyz)):
                if must_keep is None or (keep & must_keep).sum() > 0:
                    return keep
        return np.ones(len(xyz), bool)


# ---------------------------------------------------------------- option augs
PER_POINT_KEYS = ("xyz", "colors", "features", "normals", "segments",
                  "labels", "instances")


def subset_scene(scene: dict, keep: np.ndarray) -> dict:
    """Subset every per-point array (masks are (P, K))."""
    out = dict(scene)
    for k in PER_POINT_KEYS:
        if k in out and out[k] is not None:
            out[k] = np.asarray(out[k])[keep]
    if out.get("masks") is not None:
        out["masks"] = np.asarray(out["masks"])[keep]
    return out


def extend_scene(scene: dict, src_idx: np.ndarray, xyz_new: np.ndarray,
                 colors_new: np.ndarray | None = None,
                 noise: bool = False, ignore_label: int = 255,
                 rng: np.random.RandomState | None = None) -> dict:
    """Append new points whose attributes copy src_idx rows (or random noise
    attributes when noise=True, reference random_around_points semantics)."""
    out = dict(scene)
    out["xyz"] = np.vstack([np.asarray(scene["xyz"]), xyz_new]).astype(np.float32)
    for k in ("colors", "features", "normals", "segments", "labels",
              "instances"):
        if k in out and out[k] is not None:
            arr = np.asarray(out[k])
            if k == "colors" and noise:
                new = rng.rand(len(xyz_new), arr.shape[1]).astype(arr.dtype)
            elif k == "colors" and colors_new is not None:
                new = colors_new
            elif k == "normals" and noise:
                new = (rng.rand(len(xyz_new), arr.shape[1]) * 2 - 1).astype(arr.dtype)
            elif k == "labels" and noise:
                new = np.full(((len(xyz_new),) + arr.shape[1:]), ignore_label,
                              arr.dtype)
            else:
                new = arr[src_idx]
            out[k] = np.concatenate([arr, new])
    if out.get("masks") is not None:
        m = np.asarray(out["masks"])
        new = np.zeros((len(xyz_new), m.shape[1]), m.dtype) if noise \
            else m[src_idx]
        out["masks"] = np.vstack([m, new])
    return out


def flip_in_center(coords: np.ndarray, rng=None) -> np.ndarray:
    """Quadrant double-flip (reference datasets/semseg.py:718-760): recenter,
    mirror each XY quadrant in x and y within its own bounding box, and
    re-base quadrants 2-4 with the reference's min offsets."""
    coords = coords - coords.mean(0)
    out = coords.copy()

    def double_flip(pts):
        mn, mx = pts.min(0), pts.max(0)
        flipped = pts.copy()
        flipped[:, 0] = mn[0] + mx[0] - pts[:, 0]
        flipped[:, 1] = mn[1] + mx[1] - pts[:, 1]
        return flipped

    quads = [
        (coords[:, 0] > 0) & (coords[:, 1] > 0),
        (coords[:, 0] > 0) & (coords[:, 1] < 0),
        (coords[:, 0] < 0) & (coords[:, 1] > 0),
        (coords[:, 0] < 0) & (coords[:, 1] < 0),
    ]
    for qi, q in enumerate(quads):
        if q.sum() < 2:
            continue
        minimum = coords[q].min(0).copy()
        minimum[2] = 0
        if qi == 0:
            out[q] = double_flip(coords[q])
            continue
        if qi == 1:
            minimum[0] = 0
        elif qi == 2:
            minimum[1] = 0
        out[q] = double_flip(coords[q]) + minimum
    return out


def cut_point_regions(scene: dict, rng: np.random.RandomState,
                      point_per_cut: int, max_cut_region: float) -> dict:
    """Remove random cubic regions (reference datasets/semseg.py:417-439):
    one cut per `point_per_cut` points, cube edge U(0.05, max_cut_region)."""
    n_cuts = int(len(scene["xyz"]) / point_per_cut)
    for _ in range(n_cuts):
        xyz = np.asarray(scene["xyz"])
        size = rng.uniform(0.05, max(max_cut_region, 0.05))
        p = xyz[rng.randint(len(xyz))]
        # the reference crops [p - size, p - size + size) per axis
        inside = np.all((xyz >= p - size) & (xyz <= p), axis=1)
        if inside.all():
            continue
        scene = subset_scene(scene, ~inside)
    return scene


def random_around_points(scene: dict, rng: np.random.RandomState,
                         rate: float, noise_rate: float,
                         ignore_label: int = 255) -> dict:
    """Resample a fraction of points with positional jitter; with
    noise_rate > 0 the new points get random color/normals and ignore labels
    (reference datasets/semseg.py:763-793)."""
    xyz = np.asarray(scene["xyz"])
    k = int(len(xyz) * rate) if rate > 0 else int(len(xyz) * 0.2)
    if k == 0:
        return scene
    src = rng.choice(len(xyz), size=k, replace=False)
    new = xyz[src] + rng.uniform(-0.2 - noise_rate, 0.2 + noise_rate,
                                 size=(k, 3))
    return extend_scene(scene, src, new.astype(np.float32),
                        noise=noise_rate > 0, ignore_label=ignore_label,
                        rng=rng)


# ------------------------------------------------- yaml-driven aug pipelines
def _limit(entry, key, default):
    v = entry.get(key, default)
    if isinstance(v, (list, tuple)) and len(v) and isinstance(v[0], (list, tuple)):
        return [tuple(x) for x in v]
    return tuple(v) if isinstance(v, (list, tuple)) else v


class VolumeAugmentations:
    """Parser/executor for the reference's serialized volumentations
    pipelines (conf/augmentation/volumentations_aug.yaml): Scale3d,
    RotateAroundAxis3d, Flip3d, applied with their configured
    probabilities."""

    def __init__(self, path: str):
        import yaml

        with open(path) as f:
            spec = yaml.safe_load(f)
        self.transforms = list(spec["transform"]["transforms"])

    def __call__(self, coords: np.ndarray, rng: np.random.RandomState
                 ) -> np.ndarray:
        for t in self.transforms:
            name = t["__class_fullname__"].rsplit(".", 1)[-1]
            p = float(t.get("p", 1.0))
            if rng.rand() >= p:
                continue
            if name == "Scale3d":
                lim = _limit(t, "scale_limit", [(-0.1, 0.1)] * 3)
                s = np.array([1.0 + rng.uniform(*l) for l in lim])
                coords = coords * s
            elif name == "RotateAroundAxis3d":
                lo, hi = _limit(t, "rotation_limit", (-np.pi, np.pi))
                angle = rng.uniform(lo, hi)
                axis = np.asarray(t.get("axis", (0, 0, 1)), np.float64)
                axis = axis / max(np.linalg.norm(axis), 1e-12)
                c, s_ = np.cos(angle), np.sin(angle)
                K = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                R = np.eye(3) + s_ * K + (1 - c) * (K @ K)
                coords = coords @ R.T
            elif name == "Flip3d":
                axis = np.asarray(t.get("axis", (1, 0, 0)))
                for i in range(3):
                    if axis[i]:
                        mn, mx = coords[:, i].min(), coords[:, i].max()
                        coords[:, i] = mn + mx - coords[:, i]
        return coords


class ImageAugmentations:
    """Parser/executor for the reference's serialized albumentations color
    pipelines (RandomBrightnessContrast, RGBShift; Normalize is handled by
    the dataset's color mean/std). Operates on unit-scale colors."""

    def __init__(self, path: str):
        import yaml

        with open(path) as f:
            spec = yaml.safe_load(f)
        self.transforms = list(spec["transform"]["transforms"])

    def __call__(self, colors01: np.ndarray, rng: np.random.RandomState
                 ) -> np.ndarray:
        c = colors01.copy()
        for t in self.transforms:
            name = t["__class_fullname__"].rsplit(".", 1)[-1]
            p = float(t.get("p", 1.0))
            if rng.rand() >= p:
                continue
            if name == "RandomBrightnessContrast":
                blim = _limit(t, "brightness_limit", (-0.2, 0.2))
                clim = _limit(t, "contrast_limit", (-0.2, 0.2))
                alpha = 1.0 + rng.uniform(*clim)
                beta = rng.uniform(*blim)
                c = alpha * c + beta * (np.mean(c) if not t.get(
                    "brightness_by_max", True) else 1.0)
            elif name == "RGBShift":
                shifts = [rng.uniform(*_limit(t, f"{ch}_shift_limit",
                                              (-20, 20))) / 255.0
                          for ch in ("r", "g", "b")]
                c = c + np.asarray(shifts)
        return c.clip(0, 1)


def _paste_arrays(scene: dict, xyz, colors01, normals, segments, labels_val,
                  mask_col: bool):
    """Append a point group to every per-point array; optionally add a new
    mask column covering exactly the new points."""
    out = dict(scene)
    n_new = len(xyz)
    out["xyz"] = np.vstack([np.asarray(scene["xyz"]), xyz]).astype(np.float32)
    if out.get("colors") is not None:
        out["colors"] = np.vstack([np.asarray(scene["colors"]),
                                   colors01]).astype(np.float32)
    if out.get("normals") is not None:
        nrm = normals if normals is not None else np.zeros((n_new, 3))
        out["normals"] = np.vstack([np.asarray(scene["normals"]),
                                    nrm]).astype(np.float32)
    if out.get("features") is not None:
        # features are regenerated after augmentation; keep shapes consistent
        out["features"] = np.vstack([
            np.asarray(scene["features"]),
            np.zeros((n_new, np.asarray(scene["features"]).shape[1]),
                     np.float32)])
    if out.get("segments") is not None:
        seg = np.asarray(scene["segments"])
        out["segments"] = np.concatenate([seg, segments.astype(seg.dtype)])
    if out.get("labels") is not None:
        lab = np.asarray(scene["labels"])
        out["labels"] = np.concatenate([
            lab, np.full((n_new,) + lab.shape[1:], labels_val, lab.dtype)])
    if out.get("instances") is not None:
        inst = np.asarray(scene["instances"])
        nid = (inst.max() + 1) if len(inst) else 0
        out["instances"] = np.concatenate(
            [inst, np.full(n_new, nid if mask_col else -1, inst.dtype)])
    if out.get("masks") is not None:
        m = np.asarray(scene["masks"])
        grown = np.vstack([m, np.zeros((n_new, m.shape[1]), m.dtype)])
        if mask_col:
            col = np.zeros((len(grown), 1), m.dtype)
            col[len(m):] = 1
            grown = np.hstack([grown, col])
        out["masks"] = grown
    return out


def oversample_instances(scene: dict, database: list, load_points,
                         oversampling: float, place_around_existing: bool,
                         rng: np.random.RandomState) -> dict:
    """Paste augmented instance crops from other scenes (reference
    augment_individual_instance, datasets/semseg.py:612-648: random scale,
    +-pi/24 x/y tilts, full z rotation, centered at an existing point or a
    uniform location). Instances come from the database's instance column
    (the reference samples an instance databank built the same way at
    preprocessing time)."""
    masks = scene.get("masks")
    n_inst = masks.shape[1] if masks is not None else 1
    n_add = int(n_inst * oversampling)
    for _ in range(n_add):
        entry = database[rng.randint(len(database))]
        try:
            pts = load_points(entry)
        except (FileNotFoundError, OSError):
            continue
        if pts.shape[1] < 12:
            continue
        inst_col = pts[:, 11].astype(np.int64)
        ids = np.unique(inst_col[inst_col >= 0])
        if len(ids) == 0:
            continue
        sel = inst_col == ids[rng.randint(len(ids))]
        if sel.sum() < 10:
            continue
        ipts = pts[sel]
        coords = ipts[:, :3] - ipts[:, :3].mean(0)
        # reference aug: Scale3d + two pi/24 tilts + full z rotation
        coords = coords * (1.0 + rng.uniform(-0.1, 0.1, 3))
        coords = coords @ rotation_matrix(rng, max_z=np.pi * 2,
                                          max_xy=np.pi / 24).T
        if place_around_existing:
            center = np.asarray(scene["xyz"])[rng.randint(len(scene["xyz"]))]
        else:
            center = np.array([rng.uniform(-5, 5), rng.uniform(-5, 5),
                               rng.uniform(-0.5, 2)])
        coords = coords + center
        seg = np.asarray(scene.get("segments", np.zeros(0, np.int64)))
        new_seg_id = (seg.max() + 1) if seg.size else 0
        scene = _paste_arrays(
            scene, coords, ipts[:, 3:6] / 255.0, ipts[:, 6:9],
            np.full(len(coords), new_seg_id), labels_val=1, mask_col=True)
    return scene


def append_unlabeled_scene(scene: dict, database: list, load_points,
                           rng: np.random.RandomState,
                           ignore_label: int = 255) -> dict:
    """Concat a random other scene's points with ignore labels and no mask
    membership (reference add_unlabeled_pc, datasets/semseg.py:452-470)."""
    entry = database[rng.randint(len(database))]
    try:
        pts = load_points(entry)
    except (FileNotFoundError, OSError):
        return scene
    seg_src = pts[:, 9].astype(np.int64) if pts.shape[1] > 9 else \
        np.zeros(len(pts), np.int64)
    seg = np.asarray(scene.get("segments", np.zeros(0, np.int64)))
    base = (seg.max() + 1) if seg.size else 0
    _, seg_rel = np.unique(seg_src, return_inverse=True)
    return _paste_arrays(
        scene, pts[:, :3], pts[:, 3:6] / 255.0,
        pts[:, 6:9] if pts.shape[1] >= 9 else None,
        base + seg_rel, labels_val=ignore_label, mask_col=False)
