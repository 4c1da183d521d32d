"""Segment reductions in plain torch (counterpart of
unscene3d_tpu/ops/segment_ops.py; no Pallas kernel there). Invalid rows are
routed to a trash segment and dropped."""

from __future__ import annotations

import torch


def _route_invalid(segment_ids, num_segments, valid):
    ids = segment_ids.long()
    if valid is None:
        return ids, num_segments
    return torch.where(valid, ids, torch.full_like(ids, num_segments)), \
        num_segments + 1


def segment_sum(data, segment_ids, num_segments: int, valid=None):
    ids, total = _route_invalid(segment_ids, num_segments, valid)
    out = torch.zeros((total,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def segment_count(segment_ids, num_segments: int, valid=None):
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, valid)


def segment_mean(data, segment_ids, num_segments: int, valid=None):
    """Mean of rows per segment (zeros for empty segments)."""
    s = segment_sum(data, segment_ids, num_segments, valid)
    cnt = segment_count(segment_ids, num_segments, valid).to(s.dtype)
    return s / torch.clamp_min(cnt, 1.0).reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data, segment_ids, num_segments: int, valid=None,
                counts=None):
    """Max of rows per segment; empty segments yield 0. `counts`: the rows
    per segment where the caller holds them (else counted here)."""
    ids, total = _route_invalid(segment_ids, num_segments, valid)
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = torch.full((total,) + tuple(data.shape[1:]),
                     torch.finfo(data.dtype).min, dtype=data.dtype,
                     device=data.device)
    out = out.scatter_reduce(0, idx, data, reduce="amax",
                             include_self=True)[:num_segments]
    cnt = (segment_count(segment_ids, num_segments, valid)
           if counts is None else counts)
    empty = (cnt == 0).reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(empty, torch.zeros_like(out), out)
