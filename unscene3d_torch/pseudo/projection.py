"""2D -> 3D feature projection (counterpart of
unscene3d_tpu/pseudo/projection.py:project_2d_features; the two renderers
are not ported yet).

A z-buffer splat: every voxel projects to a pixel; per pixel the minimum
camera depth wins; voxels within a small depth tolerance of the winner
receive that pixel's feature. First-hit visibility without a marching loop,
batched over voxels, views in a Python loop. The per-pixel minimum is a
scatter `amin`, whose result does not depend on the order of the updates.
"""

from __future__ import annotations

import torch


def _world_to_cam(c2w, pts):
    """c2w: (4, 4) camera-to-world pose; pts (N, 3) -> camera frame,
    R^T (p - t). Elementwise products summed in axis order, not a matmul:
    each op rounds alike on the CPU and the card, so both project every
    point to the same pixel (a 3 x 3 GEMM's order differs between BLAS
    libraries)."""
    d = pts - c2w[:3, 3]
    r = c2w[:3, :3]
    return d[:, 0:1] * r[0] + d[:, 1:2] * r[1] + d[:, 2:3] * r[2]


def _project_pinhole(K, cam):
    z = cam[:, 2]
    zs = torch.where(z == 0, 1e-9, z)
    u = K[0, 0] * cam[:, 0] / zs + K[0, 2]
    v = K[1, 1] * cam[:, 1] / zs + K[1, 2]
    return u, v, z


def project_2d_features(features, world_pts, valid, poses, intrinsics,
                        height: int, width: int,
                        depth_tolerance: float = 0.05,
                        min_depth: float = 0.05,
                        reference_average: bool = False):
    """features (V, H, W, C); world_pts (N, 3) voxel centres in the world
    frame; valid (N,) bool; poses (V, 4, 4) camera-to-world; intrinsics
    (3, 3) or (V, 3, 3). Returns (voxel_feats (N, C) f32, hit_counts (N,)
    int32). `reference_average` replicates the reference's per-view pairwise
    mean (new = (old + projected) / 2 on hit voxels); the default is a true
    mean over the views that hit."""
    V, C = features.shape[0], features.shape[-1]
    N = world_pts.shape[0]
    Ks = intrinsics.expand(V, 3, 3) if intrinsics.dim() == 2 else intrinsics
    acc = torch.zeros(N, C, dtype=torch.float32, device=world_pts.device)
    cnt = torch.zeros(N, dtype=torch.int32, device=world_pts.device)
    inf = float("inf")
    for i in range(V):
        u, v, z = _project_pinhole(Ks[i], _world_to_cam(poses[i], world_pts))
        ui = torch.round(u).to(torch.int32)
        vi = torch.round(v).to(torch.int32)
        inb = ((ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
               & (z > min_depth) & valid)
        pix = (vi.clamp(0, height - 1) * width
               + ui.clamp(0, width - 1)).long()
        # z-buffer: min depth per pixel over the candidate voxels (0 where a
        # pixel has none, as the JAX package's segment_max of -z)
        zbuf = torch.full((height * width,), inf, dtype=z.dtype,
                          device=z.device)
        zbuf = zbuf.scatter_reduce(0, pix, torch.where(inb, z, inf),
                                   reduce="amin", include_self=True)
        zbuf = torch.where(torch.isinf(zbuf), 0.0, zbuf)
        hit = inb & (z <= zbuf[pix] + depth_tolerance)
        f = features[i].reshape(height * width, C)[pix]
        f = f * hit[:, None].to(f.dtype)
        if reference_average:
            acc = torch.where(hit[:, None], (acc + f) / 2.0, acc)
        else:
            acc = acc + f
        cnt = cnt + hit.to(torch.int32)
    if not reference_average:
        acc = acc / cnt.clamp_min(1)[:, None].to(torch.float32)
    return acc, cnt
