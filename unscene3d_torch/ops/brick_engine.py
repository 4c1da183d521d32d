"""Brick-resident k3 conv engine and kernel 7 (counterpart of
unscene3d_tpu/ops/brick_engine.py).

The other formulation of the k3 submanifold conv: a level's voxels are
packed into halo'd 8^3 bricks (10^3 cells, flat cell id x*100 + y*10 + z,
padded to 1008 rows), so that every k3 offset is a shift of the flat cell
axis and the conv is 27 dense slice products with no gather:

  1. `assemble`: one row gather packs (N, C) features into (nb, 1008, C);
  2. `brick_conv3` (kernel 7, csrc/brick_conv.cu): window rows [111, 895)
     cover every interior cell; out = epi(sum_k g[:, 111 + d_k + r] @ w[k])
     at occupied cells and 0 elsewhere, the scale/offset, residual, ReLU
     epilogue and the occupancy mask fused, halo rows written as zeros;
  3. `halo_exchange`: halo cells refreshed from the neighbour bricks'
     interiors with 26 slab slices and brick-row takes;
  4. `disassemble`: one take back to the flat (N, C) layout;
  `brick_conv1`: the k1 conv in brick space, a plain matmul.

Everything but kernel 7 is plain torch, as it is plain XLA in the JAX
package. `brick_conv3` runs its plain twin for CPU tensors only; for a CUDA
tensor it launches the kernel or raises, and `brick_conv3.launches` counts
the launches. Bound on the H100: the bytes of the dense output slab (g
and the residual are needed only near occupied cells). The model path
reaches kernel 7 at the collator's `brick_levels`: assemble -> kernel 7
-> disassemble per k3 conv (ops/conv_ops.py:brick_conv3_flat); the halo
exchange serves chains that stay in brick space.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unscene3d_torch.ops import _build
from unscene3d_torch.ops.hashing import CoordHashTable, ravel_hash
from unscene3d_torch.ops.sparse_graph import LevelGraph, bucket_size

BRICK = 8
HALO = 10
CELLS = 1008  # 1000 spatial cells + 8 pad: rows up to 111 + 111 + 784 are read
# out-window: rows [111, 895) cover every interior cell (x,y,z in [1,9))
WIN_LO = 111
WIN_N = 784

# k3 offset deltas in flat cell ids, ordered as KERNEL3_OFFSETS (x slowest,
# z fastest -- ops/kernel_maps.py)
K3_DELTAS = tuple(
    dx * 100 + dy * 10 + dz
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
)

# 26 halo-exchange directions: (d, dst per-axis slices, src per-axis slices)
_RANGES = {-1: (slice(0, 1), slice(8, 9)), 0: (slice(1, 9), slice(1, 9)),
           1: (slice(9, 10), slice(1, 2))}
HALO_DIRS = tuple(
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) != (0, 0, 0)
)
_SUPPORTED = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class BrickGraph:
    """Brick decomposition of one level, padded to nb_pad bricks. The LAST
    brick is always an all-empty pad brick (halo exchange of missing
    neighbours reads zeros from it)."""

    # (nb_pad, CELLS) int32 flat voxel row of each cell; empty -> n_pad-1
    asm_idx: torch.Tensor
    # (n_pad,) int32 into nb_pad*CELLS; padding rows -> the pad brick
    out_idx: torch.Tensor
    # (26, nb_pad) int32 neighbour brick id; missing -> nb_pad-1
    nbr: torch.Tensor
    n_pad: int = 0

    @property
    def nb_pad(self) -> int:
        return self.asm_idx.shape[0]

    @property
    def occ(self) -> torch.Tensor:
        """(nb_pad, CELLS) bool: the cell holds a real voxel."""
        return self.asm_idx != (self.n_pad - 1)

    def to(self, device, non_blocking: bool = False) -> "BrickGraph":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device, non_blocking=non_blocking)
            for name in ("asm_idx", "out_idx", "nbr")})


def build_brick_graph(coords: np.ndarray, valid: np.ndarray,
                      nb_pad: int | None = None) -> BrickGraph:
    """coords: (N_pad, 4) int [b, x, y, z] unit coords of one level."""
    coords = np.asarray(coords, np.int64)
    valid = np.asarray(valid, bool)
    n_pad = len(coords)
    real = coords[valid]

    brick_of = np.column_stack([real[:, 0], real[:, 1:] >> 3])
    bkeys = ravel_hash(brick_of)
    uniq, inverse = np.unique(bkeys, return_inverse=True)
    inverse = inverse.reshape(-1)
    nb = len(uniq)
    if nb_pad is None:
        nb_pad = bucket_size(nb + 1, align=8, min_size=8)
    if nb_pad <= nb:
        raise ValueError("need at least one pad brick")

    # unique brick coords (in sorted-key order)
    ub = np.zeros((nb, 4), np.int64)
    ub[inverse] = brick_of

    # assemble map: per (brick, cell) the flat voxel row; neighbour cell
    # coords via key arithmetic (the key's fields are disjoint bit ranges)
    rng = np.arange(-1, BRICK + 1, dtype=np.int64)
    ii, jj, kk = np.meshgrid(rng, rng, rng, indexing="ij")
    cell_off = (ii.ravel() << 36) + (jj.ravel() << 18) + kk.ravel()  # (1000,)
    base_keys = ravel_hash(np.column_stack([ub[:, 0], ub[:, 1:] * BRICK]))
    qkeys = base_keys[:, None] + cell_off[None, :]   # (nb, 1000)

    real_rows = np.nonzero(valid)[0].astype(np.int64)
    idx, found = CoordHashTable(real).lookup_keys(qkeys)
    rows = np.where(found, real_rows[np.where(found, idx, 0)], n_pad - 1)
    asm = np.full((nb_pad, CELLS), n_pad - 1, np.int32)
    asm[:nb, :1000] = rows.reshape(nb, 1000).astype(np.int32)

    # disassemble map (pad rows -> the pad brick's empty cell 0)
    local = real[:, 1:] - (real[:, 1:] >> 3 << 3)
    cell = (local[:, 0] + 1) * 100 + (local[:, 1] + 1) * 10 + (local[:, 2] + 1)
    out_idx = np.full(n_pad, (nb_pad - 1) * CELLS, np.int64)
    out_idx[real_rows] = inverse * CELLS + cell

    # neighbour brick table
    btbl = CoordHashTable(ub)
    nbr = np.full((26, nb_pad), nb_pad - 1, np.int32)
    for di, (dx, dy, dz) in enumerate(HALO_DIRS):
        q = ub.copy()
        q[:, 1] += dx
        q[:, 2] += dy
        q[:, 3] += dz
        bidx, bfound = btbl.lookup(q)
        nbr[di, :nb] = np.where(bfound, bidx, nb_pad - 1).astype(np.int32)

    t = torch.from_numpy
    return BrickGraph(asm_idx=t(asm), out_idx=t(out_idx.astype(np.int32)),
                      nbr=t(nbr), n_pad=n_pad)


def assemble(x, bg: BrickGraph):
    """(N_pad, C) -> (nb_pad, CELLS, C). x's padding rows must be zero (empty
    cells read row N_pad - 1)."""
    return x[bg.asm_idx.reshape(-1).long()].reshape(bg.nb_pad, CELLS,
                                                    x.shape[-1])


def disassemble(g, bg: BrickGraph, level: LevelGraph):
    """(nb_pad, CELLS, C) -> (N_pad, C), masked to valid voxels."""
    out = g.reshape(-1, g.shape[-1])[bg.out_idx.long()]
    return out * level.valid[:, None].to(out.dtype)


def halo_exchange(g, bg: BrickGraph):
    """Refresh halo cells from the neighbour bricks' interior cells: 26
    regular slab slices and brick-row takes, no per-voxel gather."""
    nb, _, c = g.shape
    g4 = g[:, :1000, :].reshape(nb, HALO, HALO, HALO, c)
    out = g4.clone()
    for di, (dx, dy, dz) in enumerate(HALO_DIRS):
        (dst_x, src_x), (dst_y, src_y), (dst_z, src_z) = (
            _RANGES[dx], _RANGES[dy], _RANGES[dz])
        out[:, dst_x, dst_y, dst_z, :] = g4[:, src_x, src_y, src_z, :][
            bg.nbr[di].long()]
    return torch.cat([out.reshape(nb, 1000, c), g[:, 1000:, :]], dim=1)


def brick_conv3_plain(g, w, bg: BrickGraph, scale=None, offset=None,
                      residual=None, relu=False):
    """Plain PyTorch twin of kernel 7: at each occupied window cell the 27
    shifted-row products of brick_engine.py:_conv_kernel summed in offset
    order in f32, the epilogue; every other cell (empty ones, halo rows) an
    exact zero, even where a non-finite input reaches it (the JAX op
    multiplies by the mask, which is the same on finite inputs). Only the
    occupied cells are computed: the kernel's output elsewhere is zero by
    definition."""
    cout = w.shape[-1]
    b, r = torch.nonzero(bg.occ[:, WIN_LO: WIN_LO + WIN_N], as_tuple=True)
    gf = g.float()
    wf = w.float()
    acc = torch.zeros(len(b), cout, dtype=torch.float32, device=g.device)
    for k, d in enumerate(K3_DELTAS):
        acc = acc + gf[b, WIN_LO + d + r] @ wf[k]
    y = acc
    if scale is not None:
        y = y * scale.float() + offset.float()
    if residual is not None:
        y = y + residual[b, WIN_LO + r].float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    out = torch.zeros(g.shape[0], CELLS, cout, dtype=g.dtype, device=g.device)
    out[b, WIN_LO + r] = y.to(g.dtype)
    return out


def window_reach(occ):
    """(nb, CELLS) bool: the cells that an occupied window cell reads through
    one of the 27 offsets, which are all that kernel 7 needs of g."""
    win = occ[:, WIN_LO: WIN_LO + WIN_N]
    reach = torch.zeros_like(occ)
    for d in K3_DELTAS:
        reach[:, WIN_LO + d: WIN_LO + d + WIN_N] |= win
    return reach


def _affine(scale, offset, cout, device):
    """scale and offset default to 1 and 0 separately, as in the JAX op."""
    if scale is None and offset is None:
        return None, None
    if scale is None:
        scale = torch.ones(cout, dtype=torch.float32, device=device)
    if offset is None:
        offset = torch.zeros(cout, dtype=torch.float32, device=device)
    return scale, offset


def brick_conv3(g, w, bg: BrickGraph, scale=None, offset=None, residual=None,
                relu=False):
    """Fused k3 conv (+ scale/offset + residual + ReLU + occupancy mask) over
    a halo'd brick tensor. g: (nb_pad, CELLS, Cin) f32/bf16; w: (27, Cin,
    Cout) in g.dtype; scale/offset: (Cout,) f32; residual: (nb_pad, CELLS,
    Cout) in g.dtype. Returns (nb_pad, CELLS, Cout) in g.dtype with interior
    cells valid and halo cells zero (call `halo_exchange` before the next
    conv reads them). The occupancy mask selects: an empty cell is an exact
    zero even where a NaN or an infinity reaches it. This differs from the
    reference, which multiplies by the mask
    (unscene3d_tpu/ops/brick_engine.py:188); the two agree on finite
    inputs."""
    cout = w.shape[-1]
    scale, offset = _affine(scale, offset, cout, g.device)
    if g.device.type == "cpu":
        return brick_conv3_plain(g, w, bg, scale, offset, residual, relu)
    if g.device.type != "cuda":
        raise ValueError(f"brick_conv3: unsupported device {g.device}")
    nb, cells, cin = g.shape
    if g.dtype not in _SUPPORTED:
        raise TypeError(f"brick_conv3: unsupported dtype {g.dtype}")
    if cells != CELLS or bg.asm_idx.shape != (nb, CELLS):
        raise ValueError(f"brick_conv3: g {tuple(g.shape)} does not match "
                         f"the brick graph {tuple(bg.asm_idx.shape)}")
    if w.shape[:2] != (27, cin) or w.dtype != g.dtype:
        raise ValueError(f"brick_conv3: w {tuple(w.shape)} {w.dtype} does "
                         f"not match g {tuple(g.shape)} {g.dtype}")
    for name, t in (("scale", scale), ("offset", offset)):
        if t is not None and (t.shape != (cout,) or t.dtype != torch.float32):
            raise ValueError(f"brick_conv3: {name} must be ({cout},) float32")
    if residual is not None and (residual.shape != (nb, CELLS, cout)
                                 or residual.dtype != g.dtype):
        raise ValueError("brick_conv3: residual must be (nb_pad, CELLS, "
                         "Cout) in g.dtype")
    if bg.asm_idx.dtype != torch.int32:
        raise ValueError("brick_conv3: asm_idx must be int32")
    for t in (g, w, bg.asm_idx, scale, offset, residual):
        if t is not None and (t.device != g.device or not t.is_contiguous()):
            raise ValueError("brick_conv3: tensors must be contiguous on "
                             "g's device")
    out = torch.empty(nb, CELLS, cout, dtype=g.dtype, device=g.device)
    if nb == 0:
        return out
    code = _build.load().brick_conv3(
        _build.ptr(g), _build.ptr(w), _build.ptr(bg.asm_idx),
        _build.ptr(scale), _build.ptr(offset), _build.ptr(residual),
        _build.ptr(out), nb, bg.n_pad - 1, cin, cout, int(bool(relu)),
        int(g.dtype == torch.bfloat16), _build.stream_of(g))
    _build.check(code, "brick_conv3")
    brick_conv3.launches += 1
    return out


brick_conv3.launches = 0


def brick_conv1(g, w, bg: BrickGraph, scale=None, offset=None):
    """k1 conv (+ optional scale/offset) in brick space: a plain matmul in
    f32, masked to occupied cells (residual-downsample shortcuts). The mask
    selects, as in `brick_conv3`: an empty cell is an exact zero even where
    its input holds a NaN or an infinity. This differs from the reference,
    which multiplies by the mask (unscene3d_tpu/ops/brick_engine.py:265);
    the two agree on finite inputs."""
    y = torch.matmul(g.float(), w.float())
    if scale is not None:
        y = y * scale + offset
    y = torch.where(bg.occ[..., None], y, 0.0)
    return y.to(g.dtype)
