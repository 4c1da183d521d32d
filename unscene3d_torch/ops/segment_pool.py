"""Kernel 3: deterministic segment sum, (N, C) -> (S, C), f32 accumulation.

Replaces unscene3d_tpu/ops/segment_pool.py:tile_segment_sum (Pallas
`_kernel`). Rows with valid=False, and ids outside [0, S), contribute
nothing; the result is returned in x.dtype.

Bound on the H100: one read of every valid row (105 MB for the bench scene's
(204,800, 128) f32 mask features). To stay bitwise deterministic without
float atomics, the CUDA kernel (csrc/segment_sum.cu) walks each segment's
rows in a stable row order sorted by segment, with per-segment offsets into
it; the collate precomputes both on the host (`segment_order`), static per
batch like `seg_counts`.

`segment_sum` runs the plain twin `segment_sum_plain` for CPU tensors only.
For a CUDA tensor it launches the kernel or raises; `segment_sum.launches`
counts the launches. When x requires grad the sum runs inside an autograd
Function whose backward is the gather g[ids[i]] * ok[i] in plain torch
(segment_pool.py:_vjp_bwd).
"""

from __future__ import annotations

import numpy as np
import torch

from unscene3d_torch.ops import _build

_SUPPORTED = (torch.float32, torch.bfloat16)


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
    def forward(ctx, x, ids, num_segments, valid, order, offsets):
        ctx.save_for_backward(ids, valid)
        ctx.num_segments = num_segments
        ctx.dtype = x.dtype
        return _segment_sum(x, ids, num_segments, valid, order, offsets)

    @staticmethod
    def backward(ctx, g):
        ids, valid = ctx.saved_tensors
        ids = ids.long()
        ok = (ids >= 0) & (ids < ctx.num_segments)
        if valid is not None:
            ok = ok & valid
        safe = torch.where(ok, ids, torch.zeros_like(ids))
        dx = g[safe] * ok[:, None].to(g.dtype)
        return dx.to(ctx.dtype), None, None, None, None, None


def segment_sum(x, ids, num_segments, valid, order, offsets):
    """x: (N, C) f32/bf16; ids: (N,) int; valid: (N,) bool or None;
    order/offsets: `segment_order(ids, num_segments, valid)` as int32
    tensors on x's device, the rows the CUDA kernel walks (the twin reads
    ids and valid instead). Returns (num_segments, C) in x.dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SegmentSum.apply(x, ids, num_segments, valid, order, offsets)
    return _segment_sum(x, ids, num_segments, valid, order, offsets)


def _segment_sum(x, ids, num_segments, valid, order, offsets):
    if x.device.type == "cpu":
        return segment_sum_plain(x, ids, num_segments, valid)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {x.device}")
    if x.dtype not in _SUPPORTED or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("segment_sum: x must be contiguous (N, C) f32/bf16")
    if (order.dtype != torch.int32 or offsets.dtype != torch.int32
            or offsets.shape != (num_segments + 1,)
            or order.device != x.device or offsets.device != x.device
            or not order.is_contiguous() or not offsets.is_contiguous()):
        raise ValueError("segment_sum: order/offsets must be int32 on x's "
                         "device, offsets of length num_segments + 1")
    c = x.shape[1]
    out = torch.empty(num_segments, c, dtype=x.dtype, device=x.device)
    if num_segments == 0 or c == 0:
        return out
    code = _build.load().segment_sum(
        _build.ptr(x), _build.ptr(order), _build.ptr(offsets), _build.ptr(out),
        num_segments, c, int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
