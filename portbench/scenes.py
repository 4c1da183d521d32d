"""Seeded synthetic indoor scenes: a floor plane plus axis-aligned boxes,
each box one instance, segments a 0.5 m grid clustering. A copy of the
port's `data/synthetic.py:make_scene`, so that the benchmark owns its
inputs.

`scene_seed(seed, *path)` folds the run's seed and a position (batch,
scene) into one 32-bit seed, so that every seed gives the same sizes and
only other points.
"""

from __future__ import annotations

import numpy as np


def scene_seed(seed: int, *path: int) -> int:
    return int(np.random.SeedSequence([int(seed), *map(int, path)])
               .generate_state(1)[0])


def make_scene(num_points: int, num_objects: int, extent: float,
               seed: int) -> dict:
    """xyz (P, 3) f32, features (colours, P x 3) f32, segments (P,) int32,
    masks (P, num_objects) bool."""
    r = np.random.RandomState(seed)
    n_floor = num_points // 3
    per_obj = (num_points - n_floor) // num_objects
    floor = np.column_stack([r.uniform(0, extent, n_floor),
                             r.uniform(0, extent, n_floor),
                             r.uniform(0, 0.05, n_floor)])
    obj_pts, obj_ids = [], []
    for k in range(num_objects):
        center = r.uniform(0.5, extent - 0.5, 2)
        size = r.uniform(0.3, 1.0, 3)
        obj_pts.append(np.column_stack([
            r.uniform(-size[0] / 2, size[0] / 2, per_obj) + center[0],
            r.uniform(-size[1] / 2, size[1] / 2, per_obj) + center[1],
            r.uniform(0, size[2], per_obj) + 0.05]))
        obj_ids.append(np.full(per_obj, k))
    xyz = np.concatenate([floor] + obj_pts).astype(np.float32)
    inst = np.concatenate([np.full(n_floor, -1)] + obj_ids)
    base = r.uniform(0, 1, (num_objects + 1, 3))
    colors = (base[inst + 1] + r.normal(0, 0.05, (len(xyz), 3))
              ).clip(0, 1).astype(np.float32)
    gs = np.floor(xyz / 0.5).astype(np.int64)
    keys = (gs[:, 0] + 100) * 10**6 + (gs[:, 1] + 100) * 10**3 + (gs[:, 2]
                                                                 + 100)
    _, segments = np.unique(keys, return_inverse=True)
    masks = inst[:, None] == np.arange(num_objects)[None, :]
    return dict(xyz=xyz, features=colors, segments=segments.astype(np.int32),
                masks=masks, name=f"scene{seed:010d}")
