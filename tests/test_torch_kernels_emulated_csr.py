"""Kernel 6 (csrc/csr_conv.cu, kernel 1's ring main loop behind a pair-table
prologue) under the CPU emulation of CUDA (tests/cuda_emu/emulation.py):
against its twin and kernel 1's twin (the same function from other tables),
and bitwise equal to emulated kernel 1 on valid rows in both dtypes.
"""

import pytest
import torch

from tests.cuda_emu.emulation import (_close, _p, _ragged_map,  # noqa: F401
                                      _tables, emu, levels)
from unscene3d_torch.ops.conv3 import conv3_fwd_plain, row_order
from unscene3d_torch.ops.csr_conv import build_csr_graph, csr_conv3_fwd_plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout,epi", [
    (1, 3, 32, "scale_relu"),        # the stem's narrow input
    (2, 32, 32, "all"),              # + residual
    (2, 64, 96, "none"),             # 32-wide f32 tiles, ragged bf16 tile
    (3, 40, 64, "all"),              # ragged Cin chunk, 64-wide tiles
    (4, 128, 256, "scale_relu"),
])
def test_emulated_csr_conv3(emu, levels, dtype, lv, cin, cout, epi):
    """Kernel 6 over the level's pair tables against its twin and against
    kernel 1's twin (the same function). x's padding rows hold noise."""
    lvl = levels[lv]
    csr = build_csr_graph(lvl.nbr_idx.numpy())
    n = lvl.num_padded
    g = torch.Generator().manual_seed(lv * 100 + cin)
    x = torch.randn(n, cin, generator=g).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    sc = sh = res = None
    if epi != "none":
        sc = torch.rand(cout, generator=g) + 0.5
        sh = torch.randn(cout, generator=g)
    if epi == "all":
        res = torch.randn(n, cout, generator=g).to(dtype)
    relu = epi != "none"
    out = torch.empty(n, cout, dtype=dtype)
    code = emu.csr_conv3_fwd(
        _p(x), _p(w), _p(csr.pair_in), _p(csr.pair_out), _p(csr.tile_start),
        _p(lvl.valid), _p(sc), _p(sh), _p(res), _p(out), n, cin, cout,
        int(relu), int(dtype == torch.bfloat16), None)
    assert code == 0
    _close(out, csr_conv3_fwd_plain(x, w, csr, lvl.valid, sc, sh, res, relu),
           dtype)
    _close(out, conv3_fwd_plain(x, w, lvl.nbr_idx, lvl.valid, sc, sh, res,
                                relu), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_csr_conv3_ragged_level(emu, dtype):
    """A level of 200 rows: the last tile's pair range ends where the next
    offset's begins, and the last block masks its missing rows."""
    nbr, rng = _ragged_map()
    n, cin, cout = nbr.shape[1], 24, 40
    csr = build_csr_graph(nbr.numpy())
    tiles = -(-n // 64)
    ts = csr.tile_start.numpy()
    assert len(ts) == 26 * tiles + 1 and ts[-1] == csr.num_pairs
    for ki in range(26):
        assert ts[ki * tiles] == csr.bounds[ki]
        assert ts[(ki + 1) * tiles] == csr.bounds[ki + 1]
    valid = torch.arange(n) < n - 1
    x = torch.randn(n, cin, generator=rng).to(dtype)
    w = (torch.randn(27, cin, cout, generator=rng) * 0.1).to(dtype)
    out = torch.empty(n, cout, dtype=dtype)
    code = emu.csr_conv3_fwd(
        _p(x), _p(w), _p(csr.pair_in), _p(csr.pair_out), _p(csr.tile_start),
        _p(valid), None, None, None, _p(out), n, cin, cout, 0,
        int(dtype == torch.bfloat16), None)
    assert code == 0
    _close(out, csr_conv3_fwd_plain(x, w, csr, valid), dtype)
    _close(out, conv3_fwd_plain(x, w, nbr, valid), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout,epi", [
    (1, 3, 32, "scale_relu"),     # the stem's Cin 3: scalar row staging
    (2, 64, 96, "none"),          # Cout 96
    (2, 128, 96, "all"),          # the main L0 shape: 4 Cin chunks
    (3, 96, 128, "scale_relu"),   # Cout 128
    (4, 40, 256, "all"),          # two 128-wide column tiles
    ("ragged", 24, 40, "all"),    # 200 rows, a group with no pair
])
def test_emulated_csr_conv3_equals_kernel_1(emu, levels, dtype, lv, cin,
                                            cout, epi):
    """Kernel 6 (kernel 1's ring main loop and tile behind a prologue that
    reads the pair tables) and kernel 1 on the same level, the tables built
    from its map, are bitwise equal on every valid row, in both dtypes, and
    kernel 6 is zero on the padding rows (x's padding rows hold noise) and
    within tolerance of its twin. On the ragged level one 32-row group of
    the first tile has pairs at offset 0 and the next has none."""
    nbr, valid, n, g = _tables(levels, lv, cin)
    csr = build_csr_graph(nbr.numpy())
    x = torch.randn(n, cin, generator=g).to(dtype)      # noisy padding rows
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    sc = sh = res = None
    if epi != "none":
        sc = torch.rand(cout, generator=g) + 0.5
        sh = torch.randn(cout, generator=g)
    if epi == "all":
        res = torch.randn(n, cout, generator=g).to(dtype)
    relu = epi != "none"
    bf = int(dtype == torch.bfloat16)
    out6 = torch.full((n, cout), float("nan"), dtype=dtype)
    out1 = torch.full((n, cout), float("nan"), dtype=dtype)
    assert emu.csr_conv3_fwd(
        _p(x), _p(w), _p(csr.pair_in), _p(csr.pair_out), _p(csr.tile_start),
        _p(valid), _p(sc), _p(sh), _p(res), _p(out6), n, cin, cout,
        int(relu), bf, None) == 0
    order = row_order(nbr)
    assert emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(order.order),
                         _p(order.keys), _p(valid), _p(sc), _p(sh), _p(res),
                         _p(out1), n, cin, cout, int(relu), bf, None) == 0
    assert torch.equal(out6[valid], out1[valid])
    assert not out6[~valid].any()
    _close(out6, csr_conv3_fwd_plain(x, w, csr, valid, sc, sh, res, relu),
           dtype)
