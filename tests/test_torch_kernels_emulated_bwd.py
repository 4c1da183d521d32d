"""Kernel 4's dx entry and kernel 5 (dW) (csrc/conv3_bwd.cu) under the CPU
emulation of CUDA (tests/cuda_emu/emulation.py), against their twins in both
dtypes. The dW kernel's output is f32 in both dtypes (exact products summed
in f32): 1e-5 of max|twin|.
"""

import pytest
import torch

from tests.cuda_emu.emulation import _close, _p, emu, levels  # noqa: F401
from unscene3d_torch.ops.conv3 import (conv3_bwd_plain, conv3_dw_plain,
                                       dw_splits, row_order)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout", [
    (2, 3, 32),       # the stem's narrow input: scalar x rows, 32 x 32 tiles
    (3, 32, 64),      # 32 x 64 tiles
    (3, 96, 32),      # 64 x 32 f32 / 128 x 32 bf16 tiles
    (4, 40, 72),      # ragged tiles; ranges with no present pair
    (1, 32, 32),      # compaction straddles a chunk edge
    (3, 128, 96),     # the main L0 shape: Cout 96 in one bf16 tile
    (4, 40, 256),     # two 128-wide Cout tiles
    (4, 136, 32),     # two 128-wide Cin tiles, the second ragged
])
def test_emulated_conv3_bwd(emu, levels, dtype, lv, cin, cout):
    """Kernel 4's dx entry (the gather-GEMM of gm with flip-transposed
    weights) and kernel 5 (dW), the latter over one row range and over
    three, whose partials the second pass sums; the scratch starts as NaN,
    so a range with no present pair must still write its zeros. At level 1
    a block compacts rows [0, 1024) and then [1024, 1280), and an offset's
    pairs of the first segment end inside a 32-pair chunk that the second
    segment's pairs complete."""
    lvl = levels[lv]
    n = lvl.num_padded
    hits = lvl.nbr_idx != n - 1
    if lv == 1:
        assert n > 1024 and (hits[:, :1024].sum(1) % 32 != 0).any()
    if lv == 4:
        rows = -(-n // 3)
        rows = -(-rows // 32) * 32
        assert not hits[:, rows:].any()   # ranges 2 and 3 of 3
    g = torch.Generator().manual_seed(lv * 100 + cin)
    bf = int(dtype == torch.bfloat16)
    x = torch.randn(n, cin, generator=g).to(dtype)      # noisy padding rows
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    gm = (torch.randn(n, cout, generator=g)
          * lvl.valid[:, None]).to(dtype)
    dx_ref, _ = conv3_bwd_plain(x, gm, w, lvl.nbr_idx, lvl.valid)
    wf = torch.flip(w, dims=(0,)).transpose(1, 2).contiguous()
    dx = torch.empty(n, cin, dtype=dtype)
    order = row_order(lvl.nbr_idx)
    assert emu.conv3_bwd_dx(_p(gm), _p(wf), _p(lvl.nbr_idx), _p(order.order),
                            _p(order.keys), _p(lvl.valid), _p(dx), n, cin,
                            cout, bf, None) == 0
    _close(dx, dx_ref, dtype)
    dw_ref = conv3_dw_plain(x, gm, lvl.nbr_idx)
    assert dw_splits(n, cin, cout)[0] == 1      # below _DW_MIN_ROWS
    for splits in (1, 3):
        rows = -(-n // splits)
        rows = -(-rows // 32) * 32
        part = torch.full((splits, 27, cin, cout), float("nan"))
        dw = torch.empty(27, cin, cout)
        assert emu.conv3_dw(_p(x), _p(gm), _p(lvl.nbr_idx),
                            _p(part if splits > 1 else None), _p(dw), n,
                            cin, cout, splits, rows, bf, None) == 0
        _close(dw, dw_ref, torch.float32)
