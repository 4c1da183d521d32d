"""Input transforms and the augmenting voxelizer of the pseudo-mask data sets
(the port's own copy of unscene3d_tpu/data/pseudo_transforms.py; host-side
numpy).

- the feature / coordinate transforms of `initialize_data_loader`
  (reference utils/transforms.py:23-210): chromatic translation, jitter and
  auto-contrast, hue-saturation shift, random dropout, horizontal flip,
  elastic distortion. They change [0, 255]-scale colors; the normalization
  to [-0.5, 0.5] comes later, in `ScenePreparer`.
- `Voxelizer` (reference pseudo_masks/datasets/voxelizer.py:13-148): random
  per-axis rotations composed in shuffled order, a random scale folded into
  the voxelization matrix, translation-jittered clipping, floor and unique
  quantization. It returns the (M_v, M_r) pair that keeps camera poses
  consistent with the augmented grid (pseudo_masks/datasets/scannet.py:
  255-258).

Unlike the JAX module, which draws from the global state of Python's
`random` and of numpy's `np.random`, every transform here draws from the
`HostRandom` it is given: a `random.Random` and a `np.random.RandomState`,
the same two streams. One `HostRandom(seed)` shared by a loader's
transforms and preparer makes the same draws, in the same order, as the
JAX module after `random.seed(seed); np.random.seed(seed)`.
"""

from __future__ import annotations

import random

import numpy as np

from unscene3d_torch.data.augmentations import elastic_distortion
from unscene3d_torch.ops.hashing import sparse_quantize


class HostRandom:
    """The two streams the reference's transforms draw from: `py` (Python's
    `random`: the gates and blend factors) and `np` (numpy's legacy
    generator: noise, choices and the voxelizer's matrices)."""

    def __init__(self, seed: int | None = None):
        self.py = random.Random(seed)
        self.np = np.random.RandomState(seed)


def _rng(rng: HostRandom | None) -> HostRandom:
    return rng if rng is not None else HostRandom()


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, coords, feats, indexes):
        for t in self.transforms:
            coords, feats, indexes = t(coords, feats, indexes)
        return coords, feats, indexes


class ChromaticTranslation:
    """Global random color shift (utils/transforms.py:23-37)."""

    def __init__(self, trans_range_ratio=0.1, rng: HostRandom | None = None):
        self.trans_range_ratio = trans_range_ratio
        self.rng = _rng(rng)

    def __call__(self, coords, feats, indexes):
        if self.rng.py.random() < 0.95:
            tr = ((self.rng.np.rand(1, 3) - 0.5) * 255 * 2
                  * self.trans_range_ratio)
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, indexes


class ChromaticAutoContrast:
    """Blend toward per-scene full-range contrast (utils/transforms.py:40-63).
    A colorless scene (max <= 1) passes unchanged, as in the JAX module (the
    reference asserts)."""

    def __init__(self, randomize_blend_factor=True, blend_factor=0.5,
                 rng: HostRandom | None = None):
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor
        self.rng = _rng(rng)

    def __call__(self, coords, feats, indexes):
        if self.rng.py.random() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            if hi.max() <= 1:
                return coords, feats, indexes
            scale = 255 / ((hi - lo) + 1.0)
            contrast = (feats[:, :3] - lo) * scale
            blend = (self.rng.py.random() if self.randomize_blend_factor
                     else self.blend_factor)
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * contrast
        return coords, feats, indexes


class ChromaticJitter:
    def __init__(self, std=0.01, rng: HostRandom | None = None):
        self.std = std
        self.rng = _rng(rng)

    def __call__(self, coords, feats, indexes):
        if self.rng.py.random() < 0.95:
            noise = self.rng.np.randn(feats.shape[0], 3) * self.std * 255
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, indexes


def rgb_to_hsv(rgb):
    """colorsys.rgb_to_hsv vectorized over [0, 255] arrays
    (utils/transforms.py:94-117)."""
    rgb = rgb.astype("float")
    hsv = np.zeros_like(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb[..., :3], axis=-1)
    minc = np.min(rgb[..., :3], axis=-1)
    hsv[..., 2] = maxc
    mask = maxc != minc
    hsv[mask, 1] = (maxc - minc)[mask] / maxc[mask]
    rc = np.zeros_like(r)
    gc = np.zeros_like(g)
    bc = np.zeros_like(b)
    denom = np.where(mask, maxc - minc, 1.0)
    rc[mask] = ((maxc - r) / denom)[mask]
    gc[mask] = ((maxc - g) / denom)[mask]
    bc[mask] = ((maxc - b) / denom)[mask]
    hsv[..., 0] = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc],
                            default=4.0 + gc - rc)
    hsv[..., 0] = (hsv[..., 0] / 6.0) % 1.0
    return hsv


def hsv_to_rgb(hsv):
    """colorsys.hsv_to_rgb vectorized (utils/transforms.py:119-138)."""
    rgb = np.empty_like(hsv)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype("uint8")
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    conditions = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb[..., 0] = np.select(conditions, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conditions, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conditions, [v, p, t, v, v, q], default=p)
    return rgb.astype("uint8")


class HueSaturationTranslation:
    def __init__(self, hue_max, saturation_max, rng: HostRandom | None = None):
        self.hue_max = hue_max
        self.saturation_max = saturation_max
        self.rng = _rng(rng)

    def __call__(self, coords, feats, indexes):
        hsv = rgb_to_hsv(feats[:, :3])
        hue_val = (self.rng.py.random() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (self.rng.py.random() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        feats[:, :3] = np.clip(hsv_to_rgb(hsv), 0, 255)
        return coords, feats, indexes


class RandomDropout:
    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5,
                 rng: HostRandom | None = None):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio
        self.rng = _rng(rng)

    def __call__(self, coords, feats, indexes):
        # the reference gates on dropout_ratio, not application_ratio
        # (utils/transforms.py:168); kept, as in the JAX module
        if self.rng.py.random() < self.dropout_ratio:
            n = len(coords)
            inds = self.rng.np.choice(n, int(n * (1 - self.dropout_ratio)),
                                      replace=False)
            coords, feats, indexes = coords[inds], feats[inds], indexes[inds]
        return coords, feats, indexes


class RandomHorizontalFlip:
    def __init__(self, upright_axis="z", is_temporal=False,
                 rng: HostRandom | None = None):
        self.d = 4 if is_temporal else 3
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = set(range(self.d)) - {self.upright_axis}
        self.rng = _rng(rng)

    def __call__(self, coords, feats, indexes):
        if self.rng.py.random() < 0.95:
            for ax in self.horz_axes:
                if self.rng.py.random() < 0.5:
                    coords[:, ax] = np.max(coords[:, ax]) - coords[:, ax]
        return coords, feats, indexes


class ElasticDistortion:
    """Prevoxel transform over the shared distortion kernel
    (utils/transforms.py:210-250; semseg.py:651-688 shares the recipe)."""

    def __init__(self, distortion_params, rng: HostRandom | None = None):
        self.distortion_params = distortion_params
        self.rng = _rng(rng)

    def __call__(self, coords, feats, indexes):
        rng = np.random.RandomState(self.rng.np.randint(0, 2**31 - 1))
        if self.rng.py.random() < 0.95:
            for granularity, magnitude in self.distortion_params:
                coords = elastic_distortion(coords, granularity, magnitude,
                                            rng)
        return coords, feats, indexes


def _axis_rotation(axis_ind: int, theta: float) -> np.ndarray:
    """Rotation about a coordinate axis (the expm of the cross-product matrix
    of a unit axis is the classic rotation matrix)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis_ind]
    m[i, i] = c
    m[j, j] = c
    if axis_ind == 1:  # y-axis: opposite off-diagonal signs
        m[i, j] = s
        m[j, i] = -s
    else:
        m[i, j] = -s
        m[j, i] = s
    return m


class Voxelizer:
    """Augmenting voxelizer (pseudo_masks/datasets/voxelizer.py:13-148)."""

    def __init__(self, voxel_size=1.0, clip_bound=None, use_augmentation=False,
                 scale_augmentation_bound=None, rotation_augmentation_bound=None,
                 translation_augmentation_ratio_bound=None, ignore_label=255,
                 rng: HostRandom | None = None):
        self.voxel_size = voxel_size
        self.clip_bound = clip_bound
        self.ignore_label = ignore_label
        self.use_augmentation = use_augmentation
        self.scale_augmentation_bound = scale_augmentation_bound
        self.rotation_augmentation_bound = rotation_augmentation_bound
        self.translation_augmentation_ratio_bound = \
            translation_augmentation_ratio_bound
        self.rng = _rng(rng)

    def get_transformation_matrix(self):
        voxelization_matrix, rotation_matrix = np.eye(4), np.eye(4)
        rot_mat = np.eye(3)
        r = self.rng.np
        if self.use_augmentation and self.rotation_augmentation_bound is not None:
            rot_mats = []
            for axis_ind, rot_bound in enumerate(self.rotation_augmentation_bound):
                theta = r.uniform(*rot_bound) if rot_bound is not None else 0.0
                rot_mats.append(_axis_rotation(axis_ind, theta))
            r.shuffle(rot_mats)
            rot_mat = rot_mats[0] @ rot_mats[1] @ rot_mats[2]
        rotation_matrix[:3, :3] = rot_mat
        scale = 1 / self.voxel_size
        if self.use_augmentation and self.scale_augmentation_bound is not None:
            scale *= r.uniform(*self.scale_augmentation_bound)
        np.fill_diagonal(voxelization_matrix[:3, :3], scale)
        return voxelization_matrix, rotation_matrix

    def clip(self, coords, center=None, trans_aug_ratio=None):
        bound_min = np.min(coords, 0).astype(float)
        bound_max = np.max(coords, 0).astype(float)
        bound_size = bound_max - bound_min
        if center is None:
            center = bound_min + bound_size * 0.5
        if trans_aug_ratio is not None:
            center = center + trans_aug_ratio * bound_size
        lim = self.clip_bound
        if isinstance(lim, (int, float)):
            if bound_size.max() < lim:
                return None
            lim = ((-lim, lim),) * 3
        keep = np.ones(len(coords), bool)
        for ax in range(3):
            keep &= ((coords[:, ax] >= (lim[ax][0] + center[ax]))
                     & (coords[:, ax] < (lim[ax][1] + center[ax])))
        return keep

    def voxelize(self, coords, feats, center=None, augment=True):
        if not (coords.shape[1] == 3 and coords.shape[0] == feats.shape[0]
                and coords.shape[0]):
            raise ValueError(f"coords {coords.shape}, feats {feats.shape}")
        voxelized_inds = np.arange(coords.shape[0])

        if self.clip_bound is not None:
            trans_aug_ratio = np.zeros(3)
            if (self.use_augmentation
                    and self.translation_augmentation_ratio_bound is not None):
                for axis_ind, bound in enumerate(
                        self.translation_augmentation_ratio_bound):
                    trans_aug_ratio[axis_ind] = self.rng.np.uniform(*bound)
            clip_inds = self.clip(coords, center, trans_aug_ratio)
            if clip_inds is not None:
                coords, feats = coords[clip_inds], feats[clip_inds]
                voxelized_inds = voxelized_inds[clip_inds]

        m_v, m_r = self.get_transformation_matrix()
        rigid = m_v
        if augment and self.use_augmentation:
            rigid = m_r @ rigid
        homo = np.hstack((coords, np.ones((coords.shape[0], 1),
                                          dtype=coords.dtype)))
        coords_aug = np.floor(homo @ rigid.T[:, :3])
        _, unique_map, _ = sparse_quantize(coords_aug, 1.0)
        return (coords_aug[unique_map], feats[unique_map],
                voxelized_inds[unique_map], (m_v, m_r))
