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


def make_mesh_scene(grid: int = 40, spacing: float = 0.05,
                    num_objects: int = 4, seed: int = 0) -> dict:
    """A ScanNet-like triangle mesh: a (grid x grid) height field over the
    floor, raised into `num_objects` axis-aligned boxes, colored per box
    with noise. Returns vertices (V, 3) f32, faces (F, 3) int32, colors
    (V, 3) uint8 and instance ids (V,) int32 (-1 on the floor)."""
    r = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    inst = np.full((grid, grid), -1, np.int64)
    z = np.zeros((grid, grid))
    for k in range(num_objects):
        lo = r.randint(1, grid - grid // 4, 2)
        hi = lo + r.randint(grid // 8 + 1, grid // 4 + 1, 2)
        box = (xs >= lo[0]) & (xs < hi[0]) & (ys >= lo[1]) & (ys < hi[1])
        inst[box] = k
        z[box] = r.uniform(0.3, 1.0)
    verts = np.column_stack([xs.ravel() * spacing, ys.ravel() * spacing,
                             z.ravel()])
    verts += r.normal(0, spacing * 0.02, verts.shape)
    base = r.uniform(0, 255, (num_objects + 1, 3))
    colors = base[inst.ravel() + 1] + r.normal(0, 4.0, (grid * grid, 3))
    a = (xs[:-1, :-1] * grid + ys[:-1, :-1]).ravel()
    faces = np.concatenate([np.column_stack([a, a + 1, a + grid]),
                            np.column_stack([a + 1, a + grid + 1, a + grid])])
    return dict(vertices=verts.astype(np.float32),
                faces=faces.astype(np.int32),
                colors=colors.clip(0, 255).astype(np.uint8),
                instances=inst.ravel().astype(np.int32))


def ring_poses(center, radius: float, height: float, n: int) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses on a ring of `radius` round
    `center` at `height` above it, each facing the centre (camera x right,
    y down, z forward, as the pinhole projection reads them)."""
    center = np.asarray(center, np.float64)
    poses = np.zeros((n, 4, 4))
    for i, a in enumerate(2 * np.pi * np.arange(n) / n):
        eye = center + np.array([radius * np.cos(a), radius * np.sin(a),
                                 height])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        poses[i, :3, :3] = np.column_stack([right, np.cross(fwd, right),
                                            fwd])
        poses[i, :3, 3] = eye
        poses[i, 3, 3] = 1.0
    return poses


def write_scannet_scene(insseg_dir: str, scans_dir: str, name: str,
                        mesh: dict, alignment: np.ndarray, poses: np.ndarray,
                        image_resolution=(480, 640), seed: int = 0) -> None:
    """Write one scene in the layouts that data/scannet_pseudo.py reads:
    `{insseg_dir}/{name}.pth` (points, colors, semantic labels, instance
    ids), `{scans_dir}/{name}/{name}_vh_clean_2.ply` (the mesh with faces)
    and `{name}.txt` (`axisAlignment`). The mesh is taken in the aligned
    frame and written in the scan's own frame (the inverse of
    `alignment`). For the V `poses` (aligned frame), `color/` holds
    20 (V - 1) + 1 JPEGs of smooth seeded noise at `image_resolution`, of
    which every 20th (the data set's frame_skip) is its own frame and the
    others repeat its bytes, with their `pose/*.txt` and
    `intrinsic/intrinsic_color.txt` (ScanNet's focal length at that
    resolution). Needs torch (the .pth) and PIL (the frames)."""
    frame_skip = 20
    import io
    import os

    import torch

    from unscene3d_torch.data.ply import write_ply

    scan = os.path.join(scans_dir, name)
    os.makedirs(scan, exist_ok=True)
    os.makedirs(insseg_dir, exist_ok=True)
    homo = np.column_stack([mesh["vertices"].astype(np.float64),
                            np.ones(len(mesh["vertices"]))])
    verts = (homo @ np.linalg.inv(alignment).T)[:, :3].astype(np.float32)
    with open(os.path.join(scan, f"{name}.txt"), "w") as f:
        f.write("axisAlignment = "
                + " ".join(f"{v:.17g}" for v in alignment.ravel()) + "\n")
    inst = mesh["instances"]
    torch.save((verts, mesh["colors"], (inst >= 0).astype(np.int32), inst),
               os.path.join(insseg_dir, f"{name}.pth"))
    write_ply(os.path.join(scan, f"{name}_vh_clean_2.ply"), verts,
              colors=mesh["colors"], faces=mesh["faces"])
    from PIL import Image

    h, w = image_resolution
    r = np.random.RandomState(seed)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 1170.187988 * w / 1296.0
    K[0, 2], K[1, 2] = (w - 1) / 2.0, (h - 1) / 2.0
    for sub in ("color", "pose", "intrinsic"):
        os.makedirs(os.path.join(scan, sub), exist_ok=True)
    np.savetxt(os.path.join(scan, "intrinsic", "intrinsic_color.txt"), K)
    for i, pose in enumerate(poses):
        coarse = r.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        img = Image.fromarray(coarse.astype(np.uint8)).resize((w, h))
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        for j in range(frame_skip if i < len(poses) - 1 else 1):
            fid = i * frame_skip + j
            with open(os.path.join(scan, "color", f"{fid:06d}.jpg"),
                      "wb") as f:
                f.write(buf.getvalue())
        np.savetxt(os.path.join(scan, "pose", f"{i * frame_skip:06d}.txt"),
                   pose)


def write_mask3d_scenes(root: str, modes: dict, num_points: int = 2000,
                        num_objects: int = 4, extent: float = 6.0,
                        class_ids=tuple(range(19)), seed: int = 0) -> None:
    """Write a labeled data set in the Mask3D npy layout that
    data/semseg_dataset.py reads: for each `modes` entry (mode -> scene
    count, e.g. {"train": 8, "validation": 2}) that many `make_scene`
    scenes as `{root}/{mode}/{i:04d}_00.npy` (columns xyz, rgb 0-255,
    normal, segment, label, instance) and `{root}/{mode}_database.yaml`
    (absolute `filepath`, `raw_filepath` naming `scene{i:04d}_00`,
    `file_len`). Each instance's label is drawn from `class_ids`; the
    floor (instance -1) is labeled 1, ScanNet20's floor."""
    import os

    import yaml

    r = np.random.RandomState(seed)
    k = 0
    for mode, count in modes.items():
        os.makedirs(os.path.join(root, mode), exist_ok=True)
        db = []
        for i in range(count):
            s = make_scene(num_points=num_points, num_objects=num_objects,
                           extent=extent, seed=seed + k)
            k += 1
            inst = s["instances"].astype(np.int64)
            per_inst = np.asarray(class_ids)[r.randint(0, len(class_ids),
                                                       num_objects)]
            labels = np.where(inst >= 0, per_inst[np.maximum(inst, 0)], 1)
            n = len(s["xyz"])
            points = np.hstack([
                s["xyz"], s["colors"] * 255.0, np.tile([0, 0, 1.0], (n, 1)),
                s["segments"][:, None], labels[:, None], inst[:, None],
            ]).astype(np.float32)
            path = os.path.abspath(os.path.join(root, mode, f"{i:04d}_00.npy"))
            np.save(path, points)
            db.append({"filepath": path, "file_len": n,
                       "raw_filepath": f"/scans/scene{k - 1:04d}_00/mesh.ply"})
        with open(os.path.join(root, f"{mode}_database.yaml"), "w") as f:
            yaml.safe_dump(db, f)


def scannet_color_intrinsics() -> np.ndarray:
    """ScanNet's 4 x 4 color intrinsics at its 1296 x 968 color resolution
    (1170.19 px focal length), the frame the eval CLIs scale from."""
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 1170.187988
    K[0, 2], K[1, 2] = 647.5, 483.5
    return K


def render_instance_ids(verts: np.ndarray, instances: np.ndarray,
                        pose: np.ndarray, K: np.ndarray, shape) -> np.ndarray:
    """A CutLER-style (h, w) uint8 id map of a mesh seen from `pose`
    (camera-to-world) through the 3 x 3 `K`: each pixel that a vertex
    projects to holds instance + 1 of its nearest such vertex (0 for the
    floor's -1 and for empty pixels)."""
    h, w = shape
    cam = (verts - pose[:3, 3]) @ pose[:3, :3]
    z = cam[:, 2]
    zs = np.where(z > 0, z, 1.0)
    u = np.round(K[0, 0] * cam[:, 0] / zs + K[0, 2]).astype(np.int64)
    v = np.round(K[1, 1] * cam[:, 1] / zs + K[1, 2]).astype(np.int64)
    ok = np.flatnonzero((z > 0.05) & (u >= 0) & (u < w) & (v >= 0)
                        & (v < h))
    order = ok[np.argsort(z[ok], kind="stable")]      # nearest first
    pix, first = np.unique(v[order] * w + u[order], return_index=True)
    img = np.zeros(h * w, np.uint8)
    img[pix] = instances[order[first]] + 1
    return img.reshape(h, w)
