"""The noise-robust tri-plane projection loss (counterpart of
unscene3d_tpu/ops/triplane.py, reference models/noise_robust_loss.py):
per-instance sigmoid predictions and targets summed onto the XY / XZ / YZ
planes, normalised by each pixel's voxel count and compared with BCE over
the occupied pixels.

The planes are compact: the host enumerates only occupied pixels, whose set
depends on coords alone (`build_triplane_maps`, bitwise the JAX function,
padding included), and numbers the three planes' pixels one after another,
so each pixel lies in exactly one plane. The collate also builds, static
per batch:
  * one order in which every valid voxel appears once per plane (3 x
    N_valid entries, stable-sorted by pixel) with its offsets and pieces:
    one call of kernel 3 (ops/segment_pool.py) projects all three planes
    straight from the (N0, C) input, the sum the JAX package takes as
    three `segment_sum`s;
  * each pixel's voxel count and each scene's pixel count (integers,
    exact);
  * the pixels' order by scene, for the per-scene loss sums (kernel 3
    again).
On the card no float atomics run: the projections and the scene sums are
kernel 3, their backwards plain gathers (dx[i] = sum over the planes d of
g[pixel_id[d, i]]). A CPU tensor takes the plain twins (index_add_).

Like the JAX package, and unlike the reference's CUDA (which allocated
planes of max(coord) and dropped boundary voxels), every voxel is kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unscene3d_torch.ops import segment_pool
from unscene3d_torch.ops.segment_pool import (segment_order, segment_pieces,
                                              segment_sum, segment_sum_plain)
from unscene3d_torch.ops.sparse_graph import bucket_size

_PLANE_AXES = ((1, 2), (1, 3), (2, 3))  # xy, xz, yz over [b, x, y, z]


@dataclasses.dataclass
class TriplaneMaps:
    pixel_id: torch.Tensor      # (3, N0) int32 compact pixel id per plane
    pix_scene: torch.Tensor     # (n_pix,) int32 owning scene
    pix_valid: torch.Tensor     # (n_pix,) bool
    order: torch.Tensor         # (3 * N_valid,) int32 voxel rows by pixel
    offsets: torch.Tensor       # (n_pix + 1,) int32 offsets into order
    pieces: torch.Tensor        # segment_pieces(offsets)
    counts: torch.Tensor        # (n_pix,) f32 voxels per pixel (exact)
    npix_scene: torch.Tensor    # (B,) f32 occupied pixels per scene (exact)
    scene_order: torch.Tensor   # valid pixels stable-sorted by scene
    scene_offsets: torch.Tensor  # (B + 1,) int32
    scene_pieces: torch.Tensor  # segment_pieces(scene_offsets)

    @property
    def num_pixels(self) -> int:
        """Padded pixel count (the JAX maps' n_pix)."""
        return self.pix_scene.shape[0]

    @property
    def num_scenes(self) -> int:
        return self.npix_scene.shape[0]

    def to(self, device, non_blocking: bool = False) -> "TriplaneMaps":
        return TriplaneMaps(*(getattr(self, f.name).to(
            device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)))


def triplane_pixel_ids(coords: np.ndarray, valid: np.ndarray,
                       n_pix_pad: int | None = None):
    """The JAX `build_triplane_maps` in numpy: (pixel_id (3, N0) int32,
    pix_scene (n_pix_pad,) int32, pix_valid (n_pix_pad,) bool, n_pix).
    Invalid rows get pixel 0 (masked by `valid` wherever they are read);
    n_pix_pad defaults to bucket_size(n_pix + 1)."""
    coords = np.asarray(coords, np.int64)
    valid = np.asarray(valid, bool)
    ids = np.zeros((3, len(coords)), np.int64)
    scenes, offset = [], 0
    for d, (a, b) in enumerate(_PLANE_AXES):
        key = (coords[:, 0] * (1 << 42) + (coords[:, a] + (1 << 19)) * (1 << 21)
               + (coords[:, b] + (1 << 19)))
        key = np.where(valid, key, -1)
        uniq, inv = np.unique(key, return_inverse=True)
        has_pad = int(len(uniq) > 0 and uniq[0] == -1)
        # the padding bucket dropped; real pixels offset-consecutive
        ids[d] = np.where(valid, inv.reshape(-1) - has_pad + offset, 0)
        scenes.append((uniq[has_pad:] >> 42).astype(np.int32))
        offset += len(uniq) - has_pad
    n_pix = offset
    if n_pix_pad is None:
        n_pix_pad = bucket_size(n_pix + 1)
    assert n_pix_pad > n_pix
    pix_scene = np.zeros(n_pix_pad, np.int32)
    pix_scene[:n_pix] = np.concatenate(scenes) if n_pix else []
    pix_valid = np.zeros(n_pix_pad, bool)
    pix_valid[:n_pix] = True
    return ids.astype(np.int32), pix_scene, pix_valid, n_pix


def build_triplane_maps(coords: np.ndarray, valid: np.ndarray,
                        num_scenes: int, n_pix_pad: int | None = None
                        ) -> TriplaneMaps:
    """coords: (N0, 4) int voxel coords, valid: (N0,) bool. Host-side: the
    JAX maps plus kernel 3's tables, as CPU tensors."""
    valid = np.asarray(valid, bool)
    pixel_id, pix_scene, pix_valid, n_pix = triplane_pixel_ids(
        coords, valid, n_pix_pad)
    n0 = len(valid)
    # every valid row once per plane; the planes' pixel ranges are
    # disjoint, so one stable sort by pixel serves all three
    rows, offsets = segment_order(pixel_id.reshape(-1), len(pix_scene),
                                  np.tile(valid, 3))
    order = (rows % n0).astype(np.int32)
    counts = np.diff(offsets).astype(np.float32)
    npix_scene = np.bincount(pix_scene[:n_pix], minlength=num_scenes
                             )[:num_scenes].astype(np.float32)
    scene_order, scene_offsets = segment_order(pix_scene, num_scenes,
                                               pix_valid)
    t = torch.from_numpy
    return TriplaneMaps(
        pixel_id=t(pixel_id), pix_scene=t(pix_scene), pix_valid=t(pix_valid),
        order=t(order), offsets=t(offsets),
        pieces=t(segment_pieces(offsets)), counts=t(counts),
        npix_scene=t(npix_scene), scene_order=t(scene_order),
        scene_offsets=t(scene_offsets),
        scene_pieces=t(segment_pieces(scene_offsets)))


def project_plain(x, tri: TriplaneMaps, valid):
    """Plain twin of the projection: the three planes' f32 index_add_ sums
    added plane by plane, as the JAX function adds them."""
    out = None
    for d in range(3):
        s = segment_sum_plain(x.float(), tri.pixel_id[d], tri.num_pixels,
                              valid)
        out = s if out is None else out + s
    return out


def _project(x, tri: TriplaneMaps, valid):
    if x.device.type == "cpu":
        return project_plain(x, tri, valid)
    # kernel 3 over the tri-plane order: ids and valid are the twin's only
    return segment_pool._segment_sum(x.float().contiguous(), None,
                                     tri.num_pixels, None, tri.order,
                                     tri.offsets, tri.pieces)


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tri, valid):
        ctx.save_for_backward(tri.pixel_id, valid)
        ctx.dtype = x.dtype
        return _project(x, tri, valid)

    @staticmethod
    def backward(ctx, g):
        pixel_id, valid = ctx.saved_tensors
        pid = pixel_id.long()
        dx = g[pid[0]] + g[pid[1]] + g[pid[2]]
        dx = dx * valid[:, None].to(g.dtype)
        return dx.to(ctx.dtype), None, None


def project(x, tri: TriplaneMaps, valid):
    """(N0, C) -> (n_pix, C) f32: each valid row's sum onto its pixel of
    every plane. Kernel 3 on a CUDA tensor (one launch, counted in
    `segment_sum.launches`), the plain twin on a CPU one; the backward
    gathers each row's three pixels."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Project.apply(x, tri, valid)
    return _project(x, tri, valid)


def normalized_target_projection(target, tri: TriplaneMaps, valid,
                                 eps: float = 1e-9):
    """(N0, T) {0, 1} targets -> (n_pix, T) f32 count-normalised
    projection, the same for every prediction set."""
    return project(target.float(), tri, valid) / (tri.counts[:, None] + eps)


def triplane_losses(pred_sigmoid, target_norm, tri: TriplaneMaps, valid,
                    t_valid, eps: float = 1e-9):
    """pred_sigmoid (N0, L, T) in [0, 1]; target_norm (n_pix, T) from
    `normalized_target_projection`; t_valid (L, B, T) bool -> (L,): per set
    the JAX `triplane_projection_loss` (reference models/
    noise_robust_loss.py:126-163): per scene the BCE of the normalised
    projections summed over occupied pixels and valid instances, divided by
    (instances x occupied pixels), summed over scenes. One projection call
    for all L sets, one scene sum."""
    n0, L, T = pred_sigmoid.shape
    n_pix = tri.num_pixels
    proj_p = project(pred_sigmoid.reshape(n0, L * T), tri, valid)
    denom = (tri.counts + eps)[:, None, None]
    p = torch.clamp(proj_p.reshape(n_pix, L, T) / denom, 1e-7, 1.0 - 1e-7)
    t = target_norm.detach()[:, None, :]
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    occupied = (tri.counts > 0) & tri.pix_valid
    tv = t_valid.transpose(0, 1).to(torch.float32)[tri.pix_scene.long()]
    bce = bce * tv * occupied[:, None, None].to(torch.float32)
    loss_scene = segment_sum(bce.sum(-1), tri.pix_scene, tri.num_scenes,
                             tri.pix_valid, tri.scene_order,
                             tri.scene_offsets, tri.scene_pieces)  # (B, L)
    n_inst = t_valid.sum(-1).to(torch.float32)                    # (L, B)
    all_shape = torch.clamp_min(n_inst * tri.npix_scene[None], 1.0)
    return (loss_scene.transpose(0, 1) / all_shape).sum(-1)


def triplane_projection_loss(pred_sigmoid, target, tri: TriplaneMaps, valid,
                             t_valid, eps: float = 1e-9):
    """One prediction set, with the JAX function's arguments:
    pred_sigmoid (N0, T), target (N0, T), t_valid (B, T) -> ()."""
    t_norm = normalized_target_projection(target, tri, valid, eps)
    return triplane_losses(pred_sigmoid[:, None], t_norm, tri, valid,
                           t_valid[None], eps)[0]
