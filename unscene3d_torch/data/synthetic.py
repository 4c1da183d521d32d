"""Synthetic indoor-like scenes for tests and benchmarks.

Plays the role the oracle freemask dataset plays in the reference's test
strategy (datasets/preprocessing/freemask_preprocessing.py:188-192 builds
GT-derived pseudo masks so the pipeline can be validated with perfect masks):
a floor plane plus axis-aligned box "objects", each object = one instance
mask, segments = a coarse spatial clustering.
"""

from __future__ import annotations

import numpy as np


def make_scene(
    num_points: int = 20000,
    num_objects: int = 8,
    extent: float = 6.0,
    seed: int = 0,
    name: str | None = None,
) -> dict:
    r = np.random.RandomState(seed)
    n_floor = num_points // 3
    n_obj = num_points - n_floor

    floor = np.column_stack([
        r.uniform(0, extent, n_floor),
        r.uniform(0, extent, n_floor),
        r.uniform(0, 0.05, n_floor),
    ])

    obj_pts, obj_ids = [], []
    per_obj = n_obj // num_objects
    for k in range(num_objects):
        center = r.uniform(0.5, extent - 0.5, 2)
        size = r.uniform(0.3, 1.0, 3)
        pts = np.column_stack([
            r.uniform(-size[0] / 2, size[0] / 2, per_obj) + center[0],
            r.uniform(-size[1] / 2, size[1] / 2, per_obj) + center[1],
            r.uniform(0, size[2], per_obj) + 0.05,
        ])
        obj_pts.append(pts)
        obj_ids.append(np.full(per_obj, k))
    xyz = np.concatenate([floor] + obj_pts).astype(np.float32)
    inst = np.concatenate([np.full(n_floor, -1)] + obj_ids)

    # colors: per-instance base color + noise
    base = r.uniform(0, 1, (num_objects + 1, 3))
    colors = base[inst + 1] + r.normal(0, 0.05, (len(xyz), 3))
    colors = colors.clip(0, 1).astype(np.float32)

    # segments: spatial grid cells (stand-in for Felzenszwalb oversegmentation)
    cell = 0.5
    gs = np.floor(xyz / cell).astype(np.int64)
    keys = (gs[:, 0] + 100) * 10**6 + (gs[:, 1] + 100) * 10**3 + (gs[:, 2] + 100)
    _, segments = np.unique(keys, return_inverse=True)

    masks = np.zeros((len(xyz), num_objects), bool)
    for k in range(num_objects):
        masks[:, k] = inst == k

    return dict(
        xyz=xyz,
        features=colors,
        colors=colors,
        segments=segments.astype(np.int32),
        masks=masks,
        labels=(inst >= 0).astype(np.int32),
        instances=inst.astype(np.int32),
        name=name or f"synth{seed:04d}",
    )


def make_batch(batch_size: int = 2, num_points: int = 20000, seed: int = 0) -> list[dict]:
    return [make_scene(num_points=num_points, seed=seed + i) for i in range(batch_size)]


def make_segment_scene(seed: int = 0, num_segments: int | None = None,
                       multimodal: bool = False, dim: int = 96) -> dict:
    """Segment-level scene with reference-like statistics for the NCut
    pipeline (the port's copy of unscene3d_tpu/data/synthetic.py's):
    100-800 Felzenszwalb-style segments grouped into planted objects (tight
    feature clusters, 3-30 segments each) over a heterogeneous multi-cluster
    background, chain connectivity within each group plus sparse random
    cross-links. Matches the reference's workload (tau=0.6 binarized
    affinity over per-segment pooled features, <=20 greedy iterations).

    Returns the scene dict BatchedNCut.run consumes; key `objects` lists
    each planted object's segment-index set (ground truth for agreement
    studies)."""
    r = np.random.RandomState(seed)
    n_obj = r.randint(4, 16)
    obj_sizes = r.randint(3, 31, n_obj)
    n_bg_groups = r.randint(2, 7)
    bg_sizes = r.randint(10, 81, n_bg_groups)
    s = int(obj_sizes.sum() + bg_sizes.sum())
    if num_segments is not None:
        # rescale the background to hit the requested total
        want_bg = max(int(num_segments) - int(obj_sizes.sum()), n_bg_groups)
        bg_sizes = np.maximum((bg_sizes * want_bg / bg_sizes.sum()), 1).astype(int)
        s = int(obj_sizes.sum() + bg_sizes.sum())

    feats = np.zeros((s, dim), np.float32)
    conn = []
    objects = []
    base = 0
    # one global 'stuff' direction (floor/wall appearance): every group's
    # center shares part of it, and each object gets 1-4 BOUNDARY segments
    # mixed toward it -- so the tau-binarized affinity graph is CONNECTED
    # with per-object bottlenecks of varying strength, like real scenes.
    # (Disjoint-clique features make lambda_2..lambda_k fully degenerate, and
    # then mask identity is chaotic for every implementation, including the
    # reference's scipy loop.)
    hub = r.normal(0, 1, dim)
    hub /= np.linalg.norm(hub)

    def unit(v):
        return v / np.linalg.norm(v)

    groups = ([(int(k), True) for k in obj_sizes]
              + [(int(k), False) for k in bg_sizes])
    for size, is_obj in groups:
        fresh = unit(r.normal(0, 1, dim))
        fresh = unit(fresh - hub * (fresh @ hub))   # orthogonal part
        if is_obj:
            # cos(center, hub) ~ 0.35-0.5: below tau, distinct appearance
            mix = r.uniform(0.35, 0.5)
        else:
            # background groups blend heavily with the stuff direction
            mix = r.uniform(0.75, 0.95)
        center = unit(hub * mix + fresh * np.sqrt(1 - mix * mix)) * 5.0
        feats[base:base + size] = center + r.normal(0, 0.35, (size, dim))
        if is_obj:
            # boundary segments: appearance between the object and the hub
            # (cos > tau to both sides); their count sets the bottleneck
            # width, varied so eigenvalues spread instead of clustering
            for j in range(min(r.randint(1, 5), size)):
                w = r.uniform(0.45, 0.6)
                feats[base + j] = (unit(center * w + hub * 5.0 * (1 - w))
                                   * 5.0 + r.normal(0, 0.2, dim))
            objects.append(set(range(base, base + size)))
        for i in range(size - 1):
            conn += [[base + i, base + i + 1], [base + i + 1, base + i]]
        base += size
    # sparse random cross links (adjacent objects/background in real scenes)
    for _ in range(s // 10):
        a, b = r.randint(0, s, 2)
        if a != b:
            conn += [[a, b], [b, a]]
    uniq = np.arange(s)
    seg_ids = np.repeat(uniq, 3)
    coords = r.rand(len(seg_ids), 3).astype(np.float32) * 6
    if multimodal:
        f2d = feats + r.normal(0, 0.05, feats.shape).astype(np.float32)
        features = (feats, f2d)
    else:
        features = feats
    return dict(features=features, unique_segments=uniq,
                connectivity=np.asarray(conn, np.int32), segment_ids=seg_ids,
                coords=coords, objects=objects)
