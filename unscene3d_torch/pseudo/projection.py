"""2D -> 3D feature projection and 3D -> 2D rendering (counterpart of
unscene3d_tpu/pseudo/projection.py).

  * project_2d_features: a z-buffer splat. Every voxel projects to a pixel;
    per pixel the minimum camera depth wins; voxels within a small depth
    tolerance of the winner receive that pixel's feature. First-hit
    visibility without a marching loop, batched over voxels, views in a
    Python loop.
  * render_voxels_to_image: per pixel the mean feature of the voxels at its
    minimum depth (the reference's nearest-voxel raycast render).
  * render_voxels_to_image_interpolate: per pixel the continuous ray point
    at its first-hit depth blends the 8 positive-corner voxels with the
    reference's max(sqrt(3) - distance, 0) / sqrt(3) weights; it also
    returns the weight image and each voxel's summed weight
    (`mapping3dto2d_num`).

The per-pixel minimum is a scatter `amin`, whose result does not depend on
the order of the updates. The renderers' float sums go through kernel 3
(ops/segment_pool.py:segment_sum, over a stable order of the rows by
segment): the nearest render's per-pixel sums of features and winner
counts, the interpolating render's per-voxel weight sums and, in its
backward, the per-voxel sums of the corner gradients (`gather_rows`). No
float atomics, so two runs are bitwise equal on the card; on the CPU the
kernel's plain twin runs. Both renderers are differentiable in the voxel
features.
"""

from __future__ import annotations

import math

import torch

from unscene3d_torch.ops.segment_pool import (device_segment_order,
                                              gather_rows, segment_sum)

# kernel order of the interpolating render's 8 corners
# (raycast_cuda_kernel.cu:197-359)
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
            (0, 1, 1), (1, 0, 1), (1, 1, 1))


def _world_to_cam(c2w, pts):
    """c2w: (4, 4) camera-to-world pose; pts (N, 3) -> camera frame,
    R^T (p - t). Elementwise products summed in axis order, not a matmul:
    each op rounds alike on the CPU and the card, so both project every
    point to the same pixel (a 3 x 3 GEMM's order differs between BLAS
    libraries)."""
    d = pts - c2w[:3, 3]
    r = c2w[:3, :3]
    return d[:, 0:1] * r[0] + d[:, 1:2] * r[1] + d[:, 2:3] * r[2]


def _cam_to_world(c2w, d):
    """d (P, 3) camera-frame directions -> R d, elementwise products summed
    in axis order (see _world_to_cam)."""
    r = c2w[:3, :3]
    return d[:, 0:1] * r[:, 0] + d[:, 1:2] * r[:, 1] + d[:, 2:3] * r[:, 2]


def _project_pinhole(K, cam):
    z = cam[:, 2]
    zs = torch.where(z == 0, 1e-9, z)
    u = K[0, 0] * cam[:, 0] / zs + K[0, 2]
    v = K[1, 1] * cam[:, 1] / zs + K[1, 2]
    return u, v, z


def _splat(K, pose, pts, valid, height, width, min_depth):
    """Each point's pixel (clamped into the frame), whether it lands in the
    frame in front of `min_depth`, and its camera depth."""
    u, v, z = _project_pinhole(K, _world_to_cam(pose, pts))
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    inb = ((ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
           & (z > min_depth) & valid)
    pix = (vi.clamp(0, height - 1) * width + ui.clamp(0, width - 1)).long()
    return pix, inb, z


def _zbuffer(z, pix, inb, n_pix, empty=0.0):
    """The minimum depth per pixel over the candidate points, `empty` where
    a pixel has none (0: the JAX package's segment_max of -z)."""
    inf = float("inf")
    zbuf = torch.full((n_pix,), inf, dtype=z.dtype, device=z.device)
    zbuf = zbuf.scatter_reduce(0, pix, torch.where(inb, z, inf),
                               reduce="amin", include_self=True)
    return torch.where(torch.isinf(zbuf), empty, zbuf)


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
    for i in range(V):
        pix, inb, z = _splat(Ks[i], poses[i], world_pts, valid, height,
                             width, min_depth)
        zbuf = _zbuffer(z, pix, inb, height * width)
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


def render_voxels_to_image(voxel_feats, world_pts, valid, pose, K,
                           height: int, width: int, min_depth: float = 0.05):
    """Nearest-voxel render (raycast_cuda's indexer variant): per pixel the
    mean feature of the voxels at its minimum depth (within 1e-6), as one
    kernel-3 sum of [features, 1] over the winners. voxel_feats (N, C);
    world_pts (N, 3); valid (N,) bool; pose (4, 4) camera-to-world; K (3,
    3). Returns (image (H, W, C) f32, hit mask (H, W))."""
    n_pix = height * width
    pix, inb, z = _splat(K, pose, world_pts, valid, height, width,
                         min_depth)
    zbuf = _zbuffer(z, pix, inb, n_pix)
    win = inb & (z <= zbuf[pix] + 1e-6)
    winf = win[:, None].to(torch.float32)
    cols = torch.cat([voxel_feats.float() * winf, winf], dim=1)
    order, offsets, pieces = device_segment_order(pix, n_pix, win)
    sums = segment_sum(cols.contiguous(), pix, n_pix, win, order, offsets,
                       pieces)
    num, den = sums[:, :-1], sums[:, -1]
    img = num / torch.clamp_min(den, 1.0)[:, None]
    return img.reshape(height, width, -1), (den > 0).reshape(height, width)


def render_voxels_to_image_interpolate(voxel_feats, vox_coords, valid, pose,
                                       K, height: int, width: int,
                                       grid_dims: tuple,
                                       voxel_size: float = 1.0,
                                       min_depth: float = 0.05):
    """Trilinear-interpolation render (raycast_cuda_kernel.cu:197-359,
    431-541, backward :496-559). Per pixel: the first-hit depth of the
    voxel-centre splat, the ray point at that depth in grid coordinates,
    and the 8 positive-corner voxels (floor(pos) + {0, 1}^3) blended with
    weights max(sqrt(3) - |pos - corner|, 0) / sqrt(3) over the occupied
    corners, normalised with the reference's 1e-4 floor.

    voxel_feats (N, C); vox_coords (N, 3) int grid coords; valid (N,) bool;
    grid_dims (Dx, Dy, Dz). Returns (image (H, W, C) f32, weight image (H,
    W), per-voxel summed weights (N,)). The gradient to voxel_feats is each
    voxel's sum of its corners' image gradients times their weights,
    through kernel 3. A corner outside the grid reads no voxel (the JAX
    function parks invalid voxels in its sentinel cell, which a corner
    outside the grid then reads)."""
    Dx, Dy, Dz = (int(d) for d in grid_dims)
    cells = Dx * Dy * Dz
    dev = voxel_feats.device
    coords = vox_coords.long()
    n = coords.shape[0]
    n_pix = height * width

    def in_grid(c):
        return ((c[..., 0] >= 0) & (c[..., 0] < Dx) & (c[..., 1] >= 0)
                & (c[..., 1] < Dy) & (c[..., 2] >= 0) & (c[..., 2] < Dz))

    def flat(c):
        return c[..., 2] * (Dy * Dx) + c[..., 1] * Dx + c[..., 0]

    # dense occupancy grid: cell -> voxel row + 1 (0 empty, and the
    # sentinel cell `cells` stays empty)
    cell = torch.where(in_grid(coords) & valid, flat(coords), cells)
    occ = torch.zeros(cells + 1, dtype=torch.long, device=dev)
    occ[cell] = torch.arange(1, n + 1, device=dev)
    occ[cells] = 0

    centers = (coords.to(torch.float32) + 0.5) * voxel_size
    pix, inb, z = _splat(K, pose, centers, valid, height, width, min_depth)
    zbuf = _zbuffer(z, pix, inb, n_pix, empty=float("inf"))
    hit = torch.isfinite(zbuf)

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    cam_dir = torch.stack([(xs.reshape(-1) - K[0, 2]) / K[0, 0],
                           (ys.reshape(-1) - K[1, 2]) / K[1, 1],
                           torch.ones(n_pix, device=dev)], dim=1)
    zsafe = torch.where(hit, zbuf, 1.0)
    pos = (pose[:3, 3] + _cam_to_world(pose, cam_dir * zsafe[:, None])
           ) / voxel_size

    corners = (torch.floor(pos).long()[:, None, :]
               + torch.tensor(_CORNERS, device=dev)[None])     # (P, 8, 3)
    ok = in_grid(corners) & hit[:, None]
    vox_id = occ[torch.where(ok, flat(corners), cells)] - 1     # (P, 8)
    occupied = vox_id >= 0

    vmax = math.sqrt(3.0)
    dist = torch.linalg.vector_norm(pos[:, None, :] - corners.float(),
                                    dim=-1)
    raw_w = torch.where(occupied, torch.clamp_min(vmax - dist, 0.0) / vmax,
                        0.0)
    w = raw_w / (1e-4 + raw_w.sum(-1))[:, None]

    ids = vox_id.clamp_min(0).reshape(-1)
    occ_flat = occupied.reshape(-1)
    order, offsets, pieces = device_segment_order(ids, n, occ_flat)
    feats = gather_rows(voxel_feats.float(), ids, occ_flat, order, offsets,
                        pieces).reshape(n_pix, 8, -1)
    img = (feats * w[..., None]).sum(1)
    mapping = segment_sum(raw_w.reshape(-1, 1).contiguous(), ids, n,
                          occ_flat, order, offsets, pieces)[:, 0]
    return (img.reshape(height, width, -1), w.sum(-1).reshape(height, width),
            mapping)
