"""Host-side kernel maps (counterpart of unscene3d_tpu/ops/kernel_maps.py):
the k3 neighbour maps, the k2 child/parent maps and level padding. The k3
maps come from the port's native library (`unscene3d_torch/native`) unless
`native=False` asks for their numpy twin; the rest is numpy. The tables
equal the JAX package's bitwise (tests/test_torch_collate.py,
tests/test_torch_native.py).
One addition: each level's one-hot parent tables for the transposed conv,
built here once per batch instead of on the device at every up2. Levels
named in `csr_levels` are padded to a multiple of 256 rows, as the JAX
collator pads them, and carry the pair tables of kernel 6.
"""

from __future__ import annotations

import itertools

import numpy as np

from unscene3d_torch import native as native_lib
from unscene3d_torch.ops.csr_conv import build_csr_graph
from unscene3d_torch.ops.hashing import CoordHashTable, ravel_hash
from unscene3d_torch.ops.sparse_graph import bucket_size

# (dx, dy, dz), z fastest: k3 centre (0,0,0) at index 13. The k2 offset id
# of a fine voxel under its parent is dx*4 + dy*2 + dz (_downsample).
KERNEL3_OFFSETS = np.array(
    list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.int32)  # (27, 3)


def build_neighbor_map_padded(coords: np.ndarray, n_pad: int,
                              native: bool = True) -> np.ndarray:
    """(27, n_pad) int32 k3 map; misses and the padding tail point at row
    n_pad-1. The C++ map by default; `native=False` runs the numpy twin,
    sorted-key lookups, one vectorized searchsorted per offset."""
    coords = np.asarray(coords, np.int32)
    n = len(coords)
    if n_pad <= n:
        raise ValueError("bucketing must leave at least one padding row")
    if native:
        return native_lib.build_neighbor_map_padded(
            coords, KERNEL3_OFFSETS, n_pad, n_pad - 1)
    table = CoordHashTable(coords)
    out = np.full((27, n_pad), n_pad - 1, np.int32)
    query = coords.astype(np.int64)
    for k, off in enumerate(KERNEL3_OFFSETS):
        q = query.copy()
        q[:, 1:] += off
        idx, found = table.lookup(q)
        out[k, :n] = np.where(found, idx, n_pad - 1)
    return out


def up_tables_from_parents(parent_idx: np.ndarray, parent_offset: np.ndarray,
                           valid: np.ndarray, n_in_pad: int) -> np.ndarray:
    """(8, N_fine) int32 tables for the transposed conv: valid fine row i
    reads its parent under table parent_offset[i] and misses (n_in_pad-1)
    elsewhere (unscene3d_tpu/ops/window_gather.py:up_tables_from_parents)."""
    tables = np.full((8, len(parent_idx)), n_in_pad - 1, np.int32)
    rows = np.nonzero(valid)[0]
    tables[parent_offset[rows], rows] = parent_idx[rows]
    return tables


def _downsample(coords: np.ndarray):
    """Stride-2 parents: (coarse coords (M, 4) in sorted-key order,
    parent_idx (N,), parent_offset (N,))."""
    coords = np.asarray(coords, dtype=np.int64)
    parents = coords.copy()
    parents[:, 1:] >>= 1  # floor division
    _, first_idx, inverse = np.unique(ravel_hash(parents), return_index=True,
                                      return_inverse=True)
    off = ((coords[:, 1] & 1) * 4 + (coords[:, 2] & 1) * 2
           + (coords[:, 3] & 1)).astype(np.int32)
    return parents[first_idx], inverse.astype(np.int32).reshape(-1), off


def build_sparse_graph(coords: np.ndarray, num_levels: int = 5,
                       fine_buckets: bool = False,
                       csr_levels: tuple = (), native: bool = True
                       ) -> list[dict]:
    """All levels of one batch as dicts of numpy arrays (the collate wraps
    them into LevelGraph tensors). coords: (N, 4) [b, x, y, z] voxel coords
    at stride 1, unpadded. Pads are `bucket_size(n + 1)` per level, aligned
    to 256 rows at the levels in `csr_levels` and to 128 elsewhere, as in
    the JAX collator without window levels; the levels in `csr_levels` get
    the valid-pair tables `csr`. `native` picks the k3 maps' C++ or numpy
    path."""
    level_coords = [np.asarray(coords, dtype=np.int64)]
    parent_idxs, parent_offs = [], []
    for _ in range(num_levels - 1):
        coarse, p_idx, p_off = _downsample(level_coords[-1])
        level_coords.append(coarse)
        parent_idxs.append(p_idx)
        parent_offs.append(p_off)
    pads = [bucket_size(len(lc) + 1, fine=fine_buckets,
                        align=256 if li in csr_levels else 128)
            for li, lc in enumerate(level_coords)]

    levels = []
    for li in range(num_levels):
        lc = level_coords[li].astype(np.int32)
        n, n_pad = len(lc), pads[li]
        coords_p = np.zeros((n_pad, 4), np.int32)
        coords_p[:n] = lc
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        if li == 0:
            child = np.zeros((8, n_pad), np.int32)
        else:
            # each fine voxel is its parent's unique offset-k child
            n_fine = len(level_coords[li - 1])
            child = np.full((8, n_pad), pads[li - 1] - 1, np.int32)
            child[parent_offs[li - 1][:n_fine],
                  parent_idxs[li - 1][:n_fine]] = np.arange(n_fine,
                                                            dtype=np.int32)
        coarser_last = pads[li + 1] - 1 if li < num_levels - 1 else 0
        parent_idx = np.full(n_pad, coarser_last, np.int32)
        parent_off = np.zeros(n_pad, np.int32)
        up = None
        if li < num_levels - 1:
            parent_idx[:n] = parent_idxs[li]
            parent_off[:n] = parent_offs[li]
            up = up_tables_from_parents(parent_idx, parent_off, valid,
                                        pads[li + 1])
        nbr_idx = build_neighbor_map_padded(lc, n_pad, native)
        levels.append(dict(
            coords=coords_p, valid=valid, nbr_idx=nbr_idx,
            child_idx=child, parent_idx=parent_idx, parent_offset=parent_off,
            up_idx=up, finer_num_padded=pads[li - 1] if li > 0 else 1,
            csr=build_csr_graph(nbr_idx) if li in csr_levels else None))
    return levels
