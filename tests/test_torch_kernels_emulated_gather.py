"""Kernel 2 (csrc/k_apply.cu: the weighted gather-GEMM entry and the
unweighted 8-child sum behind avg_pool2) and kernel 3 (csrc/segment_sum.cu:
the two-pass segment sum over pieces of the host's order) under the CPU
emulation of CUDA (tests/cuda_emu/emulation.py). The sum is held bitwise to
its twin (the same f32 adds in the same offset order) in every row layout
the kernel picks: a thread per row, groups of 8, 16 or 32 lanes, 16-byte or
scalar lanes. The segment sum is held to its twin within the tolerances of
tests/cuda_emu/emulation.py (another summation order) and bitwise to
itself over two runs, with its scratch starting as NaN; also over the
tri-plane projection's order (ops/triplane.py), where every row appears in
three segments, one per plane.
"""

import numpy as np
import pytest
import torch

from tests.cuda_emu.emulation import (_close, _p, _unaligned,  # noqa: F401
                                      emu, levels)
from unscene3d_torch.ops.k_apply import k_apply_plain
from unscene3d_torch.ops.segment_pool import (segment_order, segment_pieces,
                                              segment_sum_plain)
from unscene3d_torch.ops.triplane import build_triplane_maps, project_plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["down", "up", "sum"])
def test_emulated_k_apply(emu, levels, dtype, mode):
    fine, coarse = levels[1], levels[2]
    g = torch.Generator().manual_seed(3)
    bf = int(dtype == torch.bfloat16)
    if mode == "up":
        table, n_in, out_valid = fine.up_idx, coarse.num_padded, fine.valid
    else:
        table, n_in, out_valid = coarse.child_idx, fine.num_padded, coarse.valid
    n_out = table.shape[1]
    if mode == "sum":
        x = torch.randn(n_in, 3, generator=g).to(dtype)
        out = torch.empty(n_out, 3, dtype=dtype)
        code = emu.k_apply_sum(_p(x), _p(table), _p(out_valid), _p(out), 8,
                               n_out, n_in, 3, bf, None)
        w = None
    else:
        x = torch.randn(n_in, 24, generator=g).to(dtype)
        w = (torch.randn(8, 24, 40, generator=g) * 0.2).to(dtype)
        out = torch.empty(n_out, 40, dtype=dtype)
        code = emu.k_apply_gemm(_p(x), _p(w), _p(table), _p(out_valid),
                                _p(out), 8, n_out, n_in, 24, 40, bf, None)
    assert code == 0
    ref = k_apply_plain(x, table, w, out_valid)
    if mode == "sum":       # same f32 adds in the same offset order
        assert torch.equal(out, ref)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_segment_sum(emu, dtype):
    g = torch.Generator().manual_seed(5)
    n, c, s = 3000, 40, 50
    ids = torch.randint(-1, s + 1, (n,), generator=g).int()
    valid = torch.rand(n, generator=g) > 0.1
    order, offsets = segment_order(ids.numpy(), s, valid.numpy())
    pieces = torch.from_numpy(segment_pieces(offsets))
    order = torch.from_numpy(order)
    num_pieces = len(pieces) - s - 2
    x = torch.randn(n, c, generator=g).to(dtype)
    partial = torch.empty(num_pieces, c)
    out = torch.empty(s, c, dtype=dtype)
    code = emu.segment_sum(_p(x), _p(order), _p(pieces), _p(partial),
                           _p(out), s, num_pieces, c,
                           int(dtype == torch.bfloat16), None)
    assert code == 0
    _close(out, segment_sum_plain(x, ids, s, valid), dtype)


def _pool_sum(emu, x, table, out_valid, out):
    """Kernel 2's unweighted sum of x's rows through table into out."""
    return emu.k_apply_sum(_p(x), _p(table), _p(out_valid), _p(out),
                           table.shape[0], table.shape[1], x.shape[0],
                           x.shape[1], int(x.dtype == torch.bfloat16), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,layout", [
    (3, "aligned"),      # a thread per row, scalar lanes (the coordinates)
    (20, "aligned"),     # bf16: 40-byte rows, scalar, 32 lanes a row;
                         # f32: 16-byte lanes, 8 a row
    (40, "aligned"),     # 16-byte lanes, 8 (bf16) or 16 (f32) a row
    (128, "aligned"),    # the mask features: 16 (bf16) or 32 (f32) lanes
    (128, "unaligned"),  # x and out one element past 16 bytes: scalar
                         # lanes, 4 column passes of a 32-lane group
])
def test_emulated_pool_sum_layouts(emu, levels, dtype, c, layout):
    """The 8-child sum L1 -> L2 equals its twin bitwise in every row layout,
    every output row written (out starts as NaN), with noise on x's padding
    rows."""
    fine, coarse = levels[1], levels[2]
    g = torch.Generator().manual_seed(c)
    x = torch.randn(fine.num_padded, c, generator=g).to(dtype)
    out = torch.full((coarse.num_padded, c), float("nan"), dtype=dtype)
    if layout == "unaligned":
        x, out = _unaligned(x), _unaligned(out)
    assert _pool_sum(emu, x, coarse.child_idx, coarse.valid, out) == 0
    assert torch.equal(out, k_apply_plain(x, coarse.child_idx, None,
                                          coarse.valid))


@pytest.mark.parametrize("dtype,k,n_out", [
    (torch.float32, 5, 200), (torch.bfloat16, 5, 200),
    (torch.bfloat16, 8, 8200),
    (torch.float32, 9, 200), (torch.bfloat16, 9, 200)])
def test_emulated_k_sum_table_shapes(emu, dtype, k, n_out):
    """K below 8 (the held entries past K are misses) and a level of 8,200
    rows, where each warp walks 32 rows in 8 passes of a group of 8 lanes
    (bf16) and the last warp holds 8: bitwise the twin, C=40. K above 8 is
    refused (cudaErrorInvalidValue) and nothing is written."""
    g = torch.Generator().manual_seed(k)
    n_in, c = 300, 40
    table = torch.randint(0, n_in, (k, n_out), generator=g).int()
    table[torch.rand(k, n_out, generator=g) < 0.3] = n_in - 1
    out_valid = torch.rand(n_out, generator=g) > 0.2
    x = torch.randn(n_in, c, generator=g).to(dtype)
    out = torch.full((n_out, c), float("nan"), dtype=dtype)
    if k > 8:
        assert _pool_sum(emu, x, table, out_valid, out) == 1
        assert out.isnan().all()
        return
    assert _pool_sum(emu, x, table, out_valid, out) == 0
    assert torch.equal(out, k_apply_plain(x, table, None, out_valid))


@pytest.fixture(scope="module")
def segments():
    """1,200 rows over 12 segments: segment 3 holds 389 rows, 3 pieces of
    at most 160 (5 tiles of 32 rows: warp 0 of a piece's block takes tiles
    0 and 4); segments 0, 7 and 11 are empty; ~10% of the rows are invalid
    and some ids lie outside [0, 12)."""
    rng = np.random.RandomState(4)
    n, s = 1200, 12
    ids = rng.choice([1, 2, 4, 5, 6, 8, 9, 10], n)
    ids[rng.rand(n) < 0.4] = 3
    ids[rng.rand(n) < 0.05] = -1
    ids[rng.rand(n) < 0.05] = s
    valid = rng.rand(n) > 0.1
    order, offsets = segment_order(ids, s, valid)
    pieces = segment_pieces(offsets, rows=160)
    first = pieces[:s + 1]
    counts = np.diff(offsets)
    assert (counts[[0, 7, 11]] == 0).all() and first[4] - first[3] == 3
    return (torch.from_numpy(ids).int(), torch.from_numpy(valid),
            torch.from_numpy(order), torch.from_numpy(pieces), s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,layout", [
    (3, "aligned"),      # a thread per row: 32 rows a pass, 32 slots added
    (40, "aligned"),     # 16-byte lanes, 8 (bf16) or 16 (f32) a row
    (128, "aligned"),    # 16 (bf16) or 32 (f32) lanes a row
    (40, "unaligned"),   # x one element past 16 bytes: scalar lanes, a
                         # column pass of 32 channels and one of 8
])
def test_emulated_segment_sum_pieces(emu, segments, dtype, c, layout):
    """A segment of 3 pieces, empty segments, invalid and out-of-range rows:
    within tolerance of the twin, every piece's partial written (the scratch
    starts as NaN), empty segments exactly 0, and two runs bitwise equal."""
    ids, valid, order, pieces, s = segments
    num_pieces = len(pieces) - s - 2
    g = torch.Generator().manual_seed(c)
    x = torch.randn(len(ids), c, generator=g).to(dtype)
    if layout == "unaligned":
        x = _unaligned(x)
    outs = []
    for _ in range(2):
        partial = torch.full((num_pieces, c), float("nan"))
        out = torch.full((s, c), float("nan"), dtype=dtype)
        assert emu.segment_sum(_p(x), _p(order), _p(pieces), _p(partial),
                               _p(out), s, num_pieces, c,
                               int(dtype == torch.bfloat16), None) == 0
        assert torch.isfinite(partial).all()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    assert not outs[0][[0, 7, 11]].any()
    _close(outs[0], segment_sum_plain(x, ids, s, valid), dtype)


def test_emulated_segment_sum_triplane_order(emu):
    """Kernel 3 unchanged over an order that holds every valid row three
    times (once per plane's pixel): the three planes' sums of the twin, and
    two runs bitwise equal. 40 voxels of 2 scenes, 7 padding rows, C=16
    f32 (the targets' width)."""
    r = np.random.RandomState(9)
    coords = np.unique(np.column_stack([r.randint(0, 2, 40),
                                        r.randint(0, 3, (40, 3))]), axis=0)
    n = len(coords)
    coords_p = np.zeros((n + 7, 4), np.int64)
    coords_p[:n] = coords
    valid = torch.arange(n + 7) < n
    tri = build_triplane_maps(coords_p, valid.numpy(), 2)
    s = tri.num_pixels
    num_pieces = len(tri.pieces) - s - 2
    x = torch.from_numpy(r.randn(n + 7, 16).astype(np.float32))
    outs = []
    for _ in range(2):
        partial = torch.full((num_pieces, 16), float("nan"))
        out = torch.full((s, 16), float("nan"))
        assert emu.segment_sum(_p(x), _p(tri.order), _p(tri.pieces),
                               _p(partial), _p(out), s, num_pieces, 16, 0,
                               None) == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], project_plain(x, tri, valid), torch.float32)
