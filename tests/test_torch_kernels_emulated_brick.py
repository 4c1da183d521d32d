"""Kernel 7 (csrc/brick_conv.cu over brick_tile.cuh) under the CPU emulation
of CUDA (tests/cuda_emu/emulation.py), against its twin and, without an
epilogue, kernel 1's twin on the flat level. Kernel 8, which shares the
brick tile, is in tests/test_torch_kernels_emulated_proto.py.
"""

import pytest
import torch

from tests.cuda_emu.emulation import (_close, _p, bricks,  # noqa: F401
                                      emu, thin_bricks)
from unscene3d_torch.ops import brick_engine as be
from unscene3d_torch.ops.conv3 import conv3_fwd_plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,epi,scene", [
    # scalar staging of the rows
    pytest.param(3, 32, "none", "bricks", id="3-32-none"),
    # ragged Cout tile, scalar weights
    pytest.param(16, 24, "all", "bricks", id="16-24-all"),
    # ragged Cin chunk
    pytest.param(40, 64, "all", "bricks", id="40-64-all"),
    # six 16-wide Cout fragments
    pytest.param(32, 96, "none", "bricks", id="32-96-none"),
    # empty row tiles on a real brick
    pytest.param(24, 40, "all", "thin_bricks", id="24-40-all-thin"),
    # NaN inputs within reach of empty cells only
    pytest.param(24, 40, "nan", "thin_bricks", id="24-40-nan-thin"),
])
def test_emulated_brick_conv3(emu, request, dtype, cin, cout, epi, scene):
    """Kernel 7 against its twin, the pad brick, the empty row tiles it
    skips and the zeroed halo rows included; the output buffer starts as
    NaN. epi "nan": scale, shift and residual without ReLU (which would
    clear a NaN), NaN in g wherever no occupied window cell reads it and in
    the residual at every empty cell; an empty cell stays an exact zero, in
    a skipped tile or strip as in a computed one."""
    lvl, bg = request.getfixturevalue(scene)
    g = torch.Generator().manual_seed(cin)
    x = (torch.randn(lvl.num_padded, cin, generator=g)
         * lvl.valid[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    gb = be.assemble(x, bg).contiguous()
    sc = sh = res = None
    if epi != "none":
        sc = torch.rand(cout, generator=g) + 0.5
        sh = torch.randn(cout, generator=g)
        res = torch.randn(bg.nb_pad, be.CELLS, cout, generator=g).to(dtype)
    relu = epi == "all"
    if epi == "nan":
        gb[~be.window_reach(bg.occ)] = float("nan")
        res[~bg.occ] = float("nan")
    out = torch.full((bg.nb_pad, be.CELLS, cout), float("nan"), dtype=dtype)
    code = emu.brick_conv3(_p(gb), _p(w), _p(bg.asm_idx), _p(sc), _p(sh),
                           _p(res), _p(out), bg.nb_pad, bg.n_pad - 1, cin,
                           cout, int(relu), int(dtype == torch.bfloat16),
                           None)
    assert code == 0
    assert not out[:, :be.WIN_LO].any() and not out[:, be.WIN_LO
                                                    + be.WIN_N:].any()
    _close(out, be.brick_conv3_plain(gb, w, bg, sc, sh, res, relu), dtype)
    if epi == "none":   # the same function as kernel 1 on the flat level
        _close(be.disassemble(out, bg, lvl),
               conv3_fwd_plain(x, w, lvl.nbr_idx, lvl.valid), dtype)
