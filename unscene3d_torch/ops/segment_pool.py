"""Kernel 3: deterministic segment sum, (N, C) -> (S, C), f32 accumulation.

Replaces unscene3d_tpu/ops/segment_pool.py:tile_segment_sum (Pallas
`_kernel`). Rows with valid=False, and ids outside [0, S), contribute
nothing; the result is returned in x.dtype.

Bound on the H100: one read of every valid row (52 MB for the bench scene's
(204,800, 128) bf16 mask features). To stay bitwise deterministic without
float atomics, the CUDA kernel (csrc/segment_sum.cu) walks each segment's
rows in a stable row order sorted by segment (`segment_order`), cut into
pieces of at most ROWS_PER_PIECE rows (`segment_pieces`), so that one large
segment spreads over many warps: pass 1 sums each piece into an f32
scratch, pass 2 adds each segment's pieces in order and rounds once. The
collate builds both tables on the host, static per batch like
`seg_counts`. The kernel reads `order` as row indices and nothing else of
the rows' ids, so a row may appear in several segments' runs: the
tri-plane projection (ops/triplane.py) walks one order in which every
voxel appears once per plane, with no change to the kernel. For ids that
are computed on the device (the renderers' pixels, pseudo/projection.py)
`device_segment_order` sorts them there.

`segment_sum` runs the plain twin `segment_sum_plain` for CPU tensors only.
For a CUDA tensor it launches the kernel's two passes or raises;
`segment_sum.launches` counts the calls that launch them (one per call).
When x requires grad the sum runs inside an autograd Function whose
backward is the gather g[ids[i]] * ok[i] in plain torch
(segment_pool.py:_vjp_bwd). `gather_rows` is its transpose, a plain
gather whose backward is kernel 3 over the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from unscene3d_torch.ops import _build

_SUPPORTED = (torch.float32, torch.bfloat16)
# rows of a pass-1 piece (a block of 4 warps, 4 tiles of 32 rows each): the
# bench scene's largest segment (5,310 rows) spreads over 11 blocks; the
# fastest of 128-1024 on the bench scene and the train batch in both dtypes
# (bench/reduce_times.py --rows-per-piece, PERF.md)
ROWS_PER_PIECE = 512


def segment_order(ids: np.ndarray, num_segments: int,
                  valid: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Host order for the kernel: (rows (M,) int32, stable-sorted by segment,
    keeping only valid rows with ids in [0, S); offsets (S+1,) int32)."""
    ids = np.asarray(ids, np.int64)
    keep = (ids >= 0) & (ids < num_segments)
    if valid is not None:
        keep &= np.asarray(valid, bool)
    rows = np.nonzero(keep)[0]
    rows = rows[np.argsort(ids[rows], kind="stable")]
    counts = np.bincount(ids[rows], minlength=num_segments)[:num_segments]
    offsets = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return rows.astype(np.int32), offsets.astype(np.int32)


def device_segment_order(ids, num_segments: int, valid=None):
    """`segment_order` and `segment_pieces` of ids that live on the device
    (the renderers' pixel ids), as int32 tensors on ids' device: the valid
    rows with ids in [0, S) stable-sorted by id (torch.sort(stable=True):
    the same order on every run), the offsets by a binary search, and the
    pieces from the host, which copies the offsets there once."""
    ids = ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    if valid is not None:
        keep = keep & valid
    rows = torch.nonzero(keep).flatten()
    sorted_ids, perm = torch.sort(ids[rows], stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, device=ids.device))
    offsets = offsets.to(torch.int32)
    pieces = torch.from_numpy(segment_pieces(offsets.cpu().numpy()))
    return (rows[perm].to(torch.int32).contiguous(), offsets.contiguous(),
            pieces.to(ids.device))


def segment_pieces(offsets: np.ndarray, rows: int = ROWS_PER_PIECE
                   ) -> np.ndarray:
    """Pieces of the order for the kernel, (S + 1) + (P + 1) int32:
    first[s], the index of segment s's first piece (first[S] = P), then
    bounds[p], piece p's first position in the order (bounds[P] = M).
    Segment s's run offsets[s]:offsets[s + 1] is cut into ceil(count /
    rows) pieces of `rows` positions, the last one shorter; an empty
    segment has none."""
    offsets = np.asarray(offsets, np.int64)
    counts = np.diff(offsets)
    n = -(-counts // rows)
    first = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(n, out=first[1:])
    seg = np.repeat(np.arange(len(counts)), n)
    starts = offsets[seg] + rows * (np.arange(first[-1]) - first[seg])
    return np.concatenate([first, starts, offsets[-1:]]).astype(np.int32)


def segment_sum_plain(x, ids, num_segments, valid=None):
    """Plain PyTorch twin: index_add_ in f32 with invalid / out-of-range rows
    routed to a trash segment."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    if valid is not None:
        ok = ok & valid
    ids = torch.where(ok, ids, torch.full_like(ids, num_segments))
    out = torch.zeros(num_segments + 1, x.shape[1], dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, ids, x.float())
    return out[:num_segments].to(x.dtype)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, num_segments, valid, order, offsets, pieces):
        ctx.save_for_backward(ids, valid)
        ctx.num_segments = num_segments
        ctx.dtype = x.dtype
        return _segment_sum(x, ids, num_segments, valid, order, offsets,
                            pieces)

    @staticmethod
    def backward(ctx, g):
        ids, valid = ctx.saved_tensors
        ids = ids.long()
        ok = (ids >= 0) & (ids < ctx.num_segments)
        if valid is not None:
            ok = ok & valid
        safe = torch.where(ok, ids, torch.zeros_like(ids))
        dx = g[safe] * ok[:, None].to(g.dtype)
        return dx.to(ctx.dtype), None, None, None, None, None, None


def segment_sum(x, ids, num_segments, valid, order, offsets, pieces=None):
    """x: (N, C) f32/bf16; ids: (N,) int; valid: (N,) bool or None;
    order/offsets: `segment_order(ids, num_segments, valid)` and pieces:
    `segment_pieces(offsets)`, as int32 tensors on x's device, the rows the
    CUDA kernel walks (the twin reads ids and valid instead); without
    pieces the wrapper builds them from offsets on the host, which copies
    offsets to the host and so waits for the card on every such call (the
    collate's `SceneBatch.seg_pieces` avoids it). Returns (num_segments, C)
    in x.dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SegmentSum.apply(x, ids, num_segments, valid, order, offsets,
                                 pieces)
    return _segment_sum(x, ids, num_segments, valid, order, offsets, pieces)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, valid, order, offsets, pieces):
        ctx.save_for_backward(ids, valid, order, offsets, pieces)
        ctx.num_segments = x.shape[0]
        return x[ids.long()] * valid[:, None].to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        ids, valid, order, offsets, pieces = ctx.saved_tensors
        dx = _segment_sum(g.contiguous(), ids, ctx.num_segments, valid,
                          order, offsets, pieces)
        return dx, None, None, None, None, None


def gather_rows(x, ids, valid, order, offsets, pieces):
    """(S, C) -> (N, C): out[i] = x[ids[i]] on valid rows, 0 elsewhere; ids
    must lie in [0, S). Under autograd its backward is the segment sum of
    the output gradient (kernel 3 on a CUDA tensor: each segment's rows in
    the host's order, no float atomics), with order / offsets / pieces as
    for `segment_sum(.., ids, S, valid, ..)`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, ids, valid, order, offsets, pieces)
    return x[ids.long()] * valid[:, None].to(x.dtype)


def _int32_on(t, x):
    return (t.dtype == torch.int32 and t.device == x.device
            and t.is_contiguous())


def _segment_sum(x, ids, num_segments, valid, order, offsets, pieces):
    if x.device.type == "cpu":
        return segment_sum_plain(x, ids, num_segments, valid)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {x.device}")
    if x.dtype not in _SUPPORTED or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("segment_sum: x must be contiguous (N, C) f32/bf16")
    if (not _int32_on(order, x) or not _int32_on(offsets, x)
            or offsets.shape != (num_segments + 1,)):
        raise ValueError("segment_sum: order/offsets must be int32 on x's "
                         "device, offsets of length num_segments + 1")
    if pieces is None:
        pieces = torch.from_numpy(segment_pieces(offsets.cpu().numpy())).to(
            x.device)
    num_pieces = pieces.shape[0] - num_segments - 2
    if not _int32_on(pieces, x) or pieces.dim() != 1 or num_pieces < 0:
        raise ValueError("segment_sum: pieces must be segment_pieces(offsets)"
                         " as int32 on x's device")
    c = x.shape[1]
    out = torch.empty(num_segments, c, dtype=x.dtype, device=x.device)
    if num_segments == 0 or c == 0:
        return out
    partial = torch.empty(num_pieces, c, dtype=torch.float32, device=x.device)
    code = _build.load().segment_sum(
        _build.ptr(x), _build.ptr(order), _build.ptr(pieces),
        _build.ptr(partial), _build.ptr(out), num_segments, num_pieces, c,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
