"""Kernel 1 (csrc/conv3.cu over gather_gemm.cuh) under the CPU emulation of
CUDA (tests/cuda_emu/emulation.py), against its twin in both dtypes; the
f32 order contract: kernels 1, 6 and 4's dx bitwise equal to a serial fmaf
chain (tests/cuda_emu/serial_ref.cu), the summation order they promise; and
the row order: its key and tally kernels against their twins, and kernel 1
and 4's dx bitwise the same in any row order. Tolerances as in
tests/cuda_emu/emulation.py.
"""

import dataclasses

import pytest
import torch

from tests._row_order import own_order
from tests.cuda_emu.emulation import (_close, _p, _ragged_map,  # noqa: F401
                                      _tables, _unaligned, emu, levels)
from unscene3d_torch.ops.conv3 import (conv3_fwd_plain, row_order,
                                       row_order_keys_plain,
                                       row_order_tally_plain)
from unscene3d_torch.ops.csr_conv import build_csr_graph


def _dead_tiles(lvl, rows=128):
    """Row tiles of `rows` rows in which no offset has a neighbour."""
    n = lvl.num_padded
    hit = (lvl.nbr_idx != n - 1).any(0)
    hit = torch.cat([hit, hit.new_zeros(-n % rows)])
    return int((~hit.view(-1, rows).any(1)).sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout,epi", [
    (1, 3, 32, "scale_relu"),        # narrow stem: scalar row staging
    (2, 32, 32, "all"),              # + residual
    (2, 64, 96, "none"),             # Cout 96 in one tile
    (3, 40, 64, "all"),              # ragged Cin chunk, a dead row tile
    (4, 128, 256, "scale_relu"),     # two 128-wide tiles, a dead tile
    (2, 128, 96, "all"),             # the main L0 shape: 4 Cin chunks
    (2, 96, 128, "unaligned"),       # 128 wide; x and w off 16 bytes
    ("ragged", 40, 128, "all"),      # a 32-row group with no neighbour;
                                     # f32: 96-wide tiles (2 row tiles)
])
def test_emulated_conv3(emu, levels, dtype, lv, cin, cout, epi):
    """Kernel 1 against its twin. x's padding rows hold noise; level 3's
    second and level 4's second 128-row tile have no live offset, so they
    take the epilogue alone; "unaligned": x and w start one element past a
    16-byte boundary (scalar staging)."""
    nbr, valid, n, g = _tables(levels, lv, cin)
    if lv in (3, 4):
        assert _dead_tiles(levels[lv]) > 0
    x = torch.randn(n, cin, generator=g).to(dtype)      # noisy padding rows
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    if epi == "unaligned":
        x, w, epi = _unaligned(x), _unaligned(w), "none"
    sc = sh = res = None
    if epi != "none":
        sc = torch.rand(cout, generator=g) + 0.5
        sh = torch.randn(cout, generator=g)
    if epi == "all":
        res = torch.randn(n, cout, generator=g).to(dtype)
    relu = epi != "none"
    out = torch.empty(n, cout, dtype=dtype)
    order = row_order(nbr)
    code = emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(order.order),
                         _p(order.keys), _p(valid), _p(sc), _p(sh), _p(res),
                         _p(out), n, cin, cout, int(relu),
                         int(dtype == torch.bfloat16), None)
    assert code == 0
    _close(out, conv3_fwd_plain(x, w, nbr, valid, sc, sh, res, relu), dtype)


@pytest.mark.parametrize("kernel,lv,cin,cout,epi", [
    ("conv3", 1, 3, 32, "scale_relu"),    # scalar rows, Cin rounded to 4
    ("conv3", 2, 128, 96, "all"),         # 4 chunks of 32
    ("conv3", 4, 40, 256, "all"),         # 128 wide: chunks 16, 16, 8
    ("csr", 3, 64, 128, "scale_relu"),    # kernel 6, narrowed to 96 wide
    ("csr", "ragged", 24, 40, "all"),     # a 32-row group with no pair
    ("dx", 3, 40, 96, None),              # kernel 4's dx: 40 -> 96
])
def test_emulated_conv3_f32_equals_serial_fmaf_chain(emu, levels, kernel,
                                                     lv, cin, cout, epi):
    """The f32 order contract: kernels 1, 6 and 4's dx give, on every valid
    row, the bits of the serial reference (tests/cuda_emu/serial_ref.cu),
    which computes each output as one fmaf chain over the offsets in order,
    then the channels in order. Any other order of the chunks or channels
    rounds some output differently."""
    nbr, valid, n, g = _tables(levels, lv, cin)
    x = torch.randn(n, cin, generator=g)                # noisy padding rows
    w = torch.randn(27, cin, cout, generator=g) * 0.1
    sc = sh = res = None
    if epi not in (None, "none"):
        sc = torch.rand(cout, generator=g) + 0.5
        sh = torch.randn(cout, generator=g)
    if epi == "all":
        res = torch.randn(n, cout, generator=g)
    relu = epi not in (None, "none")
    out = torch.full((n, cout), float("nan"))
    order = row_order(nbr)
    if kernel == "csr":
        csr = build_csr_graph(nbr.numpy())
        code = emu.csr_conv3_fwd(
            _p(x), _p(w), _p(csr.pair_in), _p(csr.pair_out),
            _p(csr.tile_start), _p(valid), _p(sc), _p(sh), _p(res), _p(out),
            n, cin, cout, int(relu), 0, None)
    elif kernel == "dx":   # x plays gm (N, Cin), w the flip-transposed weights
        code = emu.conv3_bwd_dx(_p(x), _p(w), _p(nbr), _p(order.order),
                                _p(order.keys), _p(valid), _p(out), n, cout,
                                cin, 0, None)
    else:
        code = emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(order.order),
                             _p(order.keys), _p(valid), _p(sc), _p(sh),
                             _p(res), _p(out), n, cin, cout, int(relu), 0,
                             None)
    assert code == 0
    ref = torch.full((n, cout), float("nan"))
    assert emu.serial_gather_gemm_f32(
        _p(x), _p(w), _p(nbr), _p(valid), _p(sc), _p(sh), _p(res), _p(ref),
        27, n, n - 1, cin, cout, int(relu)) == 0
    assert torch.equal(out[valid], ref[valid])


@pytest.mark.parametrize("lv", [2, "ragged"])
def test_emulated_row_order_keys_and_tally(emu, levels, lv):
    """The key and tally kernels against their twins: a level of the small
    batch (padding rows with no neighbour) and the 200-row ragged map (no
    multiple of 32 rows: a short last group)."""
    nbr, _, n, _ = _tables(levels, lv, 0)
    keys = torch.full((n,), -1, dtype=torch.int32)
    assert emu.row_order_keys(_p(nbr), _p(keys), n, None) == 0
    assert torch.equal(keys, row_order_keys_plain(nbr))
    keys = torch.sort(keys, stable=True).values
    groups = -(-n // 32)
    tally = torch.full((2, groups), -1, dtype=torch.int32)
    assert emu.row_order_tally(_p(keys), _p(tally), n, groups, None) == 0
    assert torch.equal(tally.sum(1), row_order_tally_plain(keys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_row_order_is_bitwise(emu, dtype):
    """Kernel 1 (with the epilogue and a residual) and 4's dx over a
    256-row map, two row tiles, in three row orders: the rows' own (the
    identity), a shuffle and the sorted masks. Each output row is the same
    chain of products in any order, so the three are equal bitwise."""
    nbr, g = _ragged_map(256)
    n, cin, cout = 256, 40, 32
    valid = torch.arange(n) < n - 1
    x = torch.randn(n, cin, generator=g).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    sc = torch.rand(cout, generator=g) + 0.5
    sh = torch.randn(cout, generator=g)
    res = torch.randn(n, cout, generator=g).to(dtype)
    gm = (torch.randn(n, cout, generator=g) * valid[:, None]).to(dtype)
    wf = torch.flip(w, dims=(0,)).transpose(1, 2).contiguous()
    own = own_order(nbr)
    perm = torch.randperm(n, generator=g).int()
    shuffled = dataclasses.replace(own, order=perm,
                                   keys=own.keys[perm.long()].contiguous())
    bf = int(dtype == torch.bfloat16)
    outs = []
    for order in (own, shuffled, row_order(nbr)):
        out = torch.full((n, cout), float("nan"), dtype=dtype)
        dx = torch.full((n, cin), float("nan"), dtype=dtype)
        assert emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(order.order),
                             _p(order.keys), _p(valid), _p(sc), _p(sh),
                             _p(res), _p(out), n, cin, cout, 1, bf,
                             None) == 0
        assert emu.conv3_bwd_dx(_p(gm), _p(wf), _p(nbr), _p(order.order),
                                _p(order.keys), _p(valid), _p(dx), n, cin,
                                cout, bf, None) == 0
        outs.append((out, dx))
    for out, dx in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(dx, outs[0][1])
    _close(outs[0][0], conv3_fwd_plain(x, w, nbr, valid, sc, sh, res, True),
           dtype)
