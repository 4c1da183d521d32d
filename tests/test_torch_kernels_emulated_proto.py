"""Kernels 8 and 9 (csrc/proto_brick.cu, csrc/win_decompose.cu) under the CPU
emulation of CUDA (tests/cuda_emu/emulation.py, whose fixtures and
tolerances this file shares): kernel 8 against its twin on a NaN-filled
output and, on the occupied cells, against kernel 7's twin; kernel 9 (bf16
only, kernel 1's ring main loop behind a window-table prologue) against its
twin in all five variants, with noise on x's padding rows, and its `full`
bitwise emulated kernel 1 on the valid rows without a spilled pair.
"""

import pytest
import torch

from tests.cuda_emu.emulation import (_close, _p, bricks,  # noqa: F401
                                      emu, levels, thin_bricks)
from unscene3d_torch.ops import brick_engine as be
from unscene3d_torch.ops.conv3 import row_order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,scene", [
    # narrow input, scalar staging of the rows
    pytest.param(3, 32, "bricks", id="3-32"),
    # ragged Cin chunk, ragged Cout tile
    pytest.param(40, 24, "bricks", id="40-24"),
    pytest.param(16, 64, "bricks", id="16-64"),
    # six 16-wide Cout fragments
    pytest.param(32, 96, "bricks", id="32-96"),
    # row tiles with no occupied cell
    pytest.param(24, 40, "thin_bricks", id="24-40-thin"),
])
def test_emulated_proto_brick_conv(emu, request, dtype, cin, cout, scene):
    """Kernel 8 against its twin on a NaN-filled output: the zeroed rows [0,
    111) and [895, 1008), and no occupancy mask (empty interior cells, also
    in row tiles with no occupied cell, keep their neighbours' sums)."""
    from unscene3d_torch.ops.proto_brick import proto_brick_conv_plain

    lvl, bg = request.getfixturevalue(scene)
    g = torch.Generator().manual_seed(cin)
    x = (torch.randn(lvl.num_padded, cin, generator=g)
         * lvl.valid[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    gb = be.assemble(x, bg).contiguous()
    out = torch.full((bg.nb_pad, be.CELLS, cout), float("nan"), dtype=dtype)
    code = emu.proto_brick_conv(_p(gb), _p(w), _p(out), bg.nb_pad, cin, cout,
                                int(dtype == torch.bfloat16), None)
    assert code == 0
    assert not out[:, :be.WIN_LO].any() and not out[:, be.WIN_LO
                                                    + be.WIN_N:].any()
    ref = proto_brick_conv_plain(gb, w)
    _close(out, ref, dtype)
    win = slice(be.WIN_LO, be.WIN_LO + be.WIN_N)
    assert out[:, win][~bg.occ[:, win]].float().abs().max() > 0
    # on the occupied cells: kernel 7 without an epilogue
    occ = bg.occ[..., None].to(torch.float32)
    _close(out.float() * occ, be.brick_conv3_plain(gb, w, bg), dtype)


@pytest.fixture(scope="module")
def win_graph(levels):
    """Level 1 of the small batch padded to a multiple of 512 rows, with
    narrow window tables (G = 2, W = 256, union 512) so that pairs spill:
    (neighbour map, valid rows, WinGraph)."""
    import numpy as np

    from unscene3d_torch.ops.kernel_maps import build_neighbor_map_padded
    from unscene3d_torch.ops.win_graph import build_win_graph

    lvl = levels[1]
    coords = lvl.coords[lvl.valid].numpy()
    n_pad = -(-(len(coords) + 1) // 512) * 512
    nbr = build_neighbor_map_padded(coords, n_pad)
    wg = build_win_graph(nbr, n_pad, w_sub=256, w_union=512, group=2)
    assert wg.num_spills > 0 and (wg.lidx >= 0).sum() > 0
    return (torch.from_numpy(np.ascontiguousarray(nbr, dtype=np.int32)),
            torch.arange(n_pad) < len(coords), wg)


@pytest.fixture(scope="module")
def win_level(win_graph):
    """(n_pad, WinTables) of win_graph's level."""
    from unscene3d_torch.ops.win_decompose import WinTables

    _, valid, wg = win_graph
    return len(valid), WinTables.from_graph(wg)


def _win_decompose(emu, x, w, tables, variant):
    """Emulated kernel 9 into a NaN-filled output."""
    from unscene3d_torch.ops.win_decompose import VARIANTS

    n_pad, cin = x.shape
    cout = w.shape[-1]
    out = torch.full((n_pad, cout), float("nan"), dtype=torch.bfloat16)
    code = emu.win_decompose(_p(x), _p(w), _p(tables.r0), _p(tables.starts),
                             _p(tables.lidx), _p(tables.ones), _p(out), n_pad,
                             tables.group, tables.w_sub, cin, cout,
                             VARIANTS.index(variant), None)
    assert code == 0
    return out


@pytest.mark.parametrize("variant,cin,cout", [
    ("full", 40, 24),         # ragged Cin chunk, ragged Cout tile
    ("no_onehot", 40, 24),
    ("no_select", 40, 24),
    ("no_gemm", 40, 24),
    ("dma_only", 40, 24),
    ("full", 64, 64),         # two Cin chunks, a whole Cout tile
    ("no_gemm", 64, 64),
    ("no_gemm", 36, 20),      # scalar rows, weights and row sums
])
def test_emulated_win_decompose(emu, win_level, variant, cin, cout):
    """Kernel 9 against its twin, every variant, with noise on x's padding
    rows (the tables may point there: both must read the same row)."""
    from unscene3d_torch.ops.win_decompose import win_conv_variant_plain

    n_pad, tables = win_level
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(n_pad, cin, generator=g).bfloat16()
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).bfloat16()
    out = _win_decompose(emu, x, w, tables, variant)
    assert torch.isfinite(out.float()).all()
    _close(out, win_conv_variant_plain(x, w, tables, variant),
           torch.bfloat16)


@pytest.mark.parametrize("cin,cout", [
    (40, 24),   # ragged Cin chunk, ragged Cout tile
    (64, 64),   # two Cin chunks, a whole Cout tile
])
def test_emulated_win_decompose_equals_kernel_1(emu, win_graph, win_level,
                                                cin, cout):
    """Kernel 9's `full` runs kernel 1's ring main loop on the rows the
    window tables name: bitwise emulated kernel 1 (no epilogue, the same x,
    w and level) on every valid row without a spilled pair, and within
    tolerance of its twin everywhere (x's padding rows hold noise)."""
    from unscene3d_torch.ops.win_decompose import win_conv_variant_plain

    nbr, valid, wg = win_graph
    n_pad, tables = win_level
    g = torch.Generator().manual_seed(cin + 1)
    x = torch.randn(n_pad, cin, generator=g).bfloat16()
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).bfloat16()
    out9 = _win_decompose(emu, x, w, tables, "full")
    out1 = torch.full((n_pad, cout), float("nan"), dtype=torch.bfloat16)
    order = row_order(nbr)
    assert emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(order.order),
                         _p(order.keys), _p(valid), None, None, None,
                         _p(out1), n_pad, cin, cout, 0, 1, None) == 0
    spilled = torch.zeros(n_pad, dtype=torch.bool)
    spilled[torch.from_numpy(wg.spill_out[wg.spill_rows >= 0]).long()] = True
    rows = valid & ~spilled
    assert 0 < spilled.sum() and rows.sum() > n_pad // 2
    assert torch.equal(out9[rows], out1[rows])
    _close(out9, win_conv_variant_plain(x, w, tables, "full"),
           torch.bfloat16)


def test_emulated_win_decompose_unknown_variant(emu, win_level):
    n_pad, tables = win_level
    x = torch.zeros(n_pad, 8).bfloat16()
    w = torch.zeros(27, 8, 8).bfloat16()
    out = torch.empty(n_pad, 8, dtype=torch.bfloat16)
    assert emu.win_decompose(_p(x), _p(w), _p(tables.r0), _p(tables.starts),
                             _p(tables.lidx), _p(tables.ones), _p(out),
                             n_pad, tables.group, tables.w_sub, 8, 8, 5,
                             None) == 1
