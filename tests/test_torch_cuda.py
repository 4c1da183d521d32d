"""The port's CUDA kernels against their plain twins, on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU. This file
imports neither jax nor the JAX package, so it runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to max|twin|: f32 1e-5 (summation order only); bf16
8e-3, just above one bf16 ulp at the top of max|twin|'s binade (2^-7): the
kernel and the twin both sum in f32 and round once, so an output may differ
by one ulp where the two f32 sums straddle a rounding boundary. dW (kernel
5) is f32 in both dtypes and sums tens of thousands of rows: 1e-4 for f32
inputs (FMA), 5e-4 for bf16 (the tensor cores' f32 accumulation does not
round to nearest). Each kernel also runs twice and must give bitwise-equal
output. Kernels 6 (compacted valid pairs) and 7 (dense bricks) compute the
same function as kernel 1 and are also held against it on the same inputs;
so is kernel 9's `full` (window tables), on the rows without a spilled pair.
"""

import dataclasses

import numpy as np
import pytest
import torch

from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops import brick_engine as be
from unscene3d_torch.ops import conv_ops, csr_conv
from unscene3d_torch.ops.conv3 import (conv3_bwd, conv3_bwd_plain, conv3_dw,
                                       conv3_dw_plain, conv3_fwd,
                                       conv3_fwd_plain)
from unscene3d_torch.ops.csr_conv import (build_csr_graph, csr_conv3_fwd,
                                          csr_conv3_fwd_plain)
from unscene3d_torch.ops.k_apply import k_apply, k_apply_plain
from unscene3d_torch.ops.segment_pool import (segment_order, segment_pieces,
                                              segment_sum, segment_sum_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def levels():
    scene = make_scene(num_points=12_000, num_objects=4, extent=3.0, seed=3)
    batch, _ = FreeMaskCollator(voxel_size=0.02, fps_queries=8)([scene])
    return batch.graph.levels


def _close(got, ref, dtype, tol=None):
    if tol is None:
        tol = 1e-5 if dtype == torch.float32 else 8e-3
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-6)
    assert err <= tol * scale, (err, scale)


def _unaligned(t):
    """t's values in a contiguous tensor whose base is one element past a
    16-byte boundary: the kernels' scalar staging path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout", [(0, 3, 32), (0, 128, 96),
                                         (1, 96, 64), (2, 384, 256),
                                         (1, 40, 64), (2, 96, 128),
                                         (3, 40, 72), (1, 64, -96)])
def test_conv3_matches_twin(cuda, levels, dtype, lv, cin, cout):
    """A negative Cout: x and w start one element past a 16-byte boundary
    (scalar staging)."""
    lvl = levels[lv].to(cuda)
    n = lvl.num_padded
    unaligned, cout = cout < 0, abs(cout)
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(n, cin, generator=g).to(cuda, dtype)  # noisy padding rows
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    if unaligned:
        x, w = _unaligned(x), _unaligned(w)
    kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(cuda),
              shift=torch.randn(cout, generator=g).to(cuda),
              residual=torch.randn(n, cout, generator=g).to(cuda, dtype),
              relu=True)
    got = conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw)
    again = conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, conv3_fwd_plain(x, w, lvl.nbr_idx, lvl.valid, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["down", "up", "pool"])
def test_k_apply_matches_twin(cuda, levels, dtype, mode):
    fine, coarse = levels[0].to(cuda), levels[1].to(cuda)
    if mode == "up":
        table, n_in, out_valid = fine.up_idx, coarse.num_padded, fine.valid
    else:
        table, n_in, out_valid = coarse.child_idx, fine.num_padded, coarse.valid
    g = torch.Generator().manual_seed(7)
    c = 3 if mode == "pool" else 64
    x = torch.randn(n_in, c, generator=g).to(cuda, dtype)
    w = (None if mode == "pool" else
         (torch.randn(8, c, 96, generator=g) * 0.2).to(cuda, dtype))
    got = k_apply(x, table, w, out_valid)
    again = k_apply(x, table, w, out_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, k_apply_plain(x, table, w, out_valid), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_matches_twin(cuda, dtype):
    rng = np.random.RandomState(1)
    n, c, s = 20_000, 128, 320
    ids = rng.randint(-1, s + 1, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    order, offsets = segment_order(ids, s, valid)
    x = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(cuda, dtype)
    args = (x, torch.from_numpy(ids).to(cuda), s,
            torch.from_numpy(valid).to(cuda))
    walk = (torch.from_numpy(order).to(cuda),
            torch.from_numpy(offsets).to(cuda))
    got = segment_sum(*args, *walk)
    again = segment_sum(*args, *walk)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, segment_sum_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,layout", [(3, "aligned"), (20, "aligned"),
                                      (40, "aligned"), (128, "aligned"),
                                      (128, "unaligned")])
def test_pool_sum_equals_twin_bitwise(cuda, levels, dtype, c, layout):
    """Kernel 2's 8-child sum L0 -> L1 in each of its row layouts (a thread
    per row; 8, 16 or 32 lanes a row; 16-byte or scalar lanes, the latter
    also for x one element past 16 bytes) equals its twin bitwise."""
    fine, coarse = levels[0].to(cuda), levels[1].to(cuda)
    g = torch.Generator().manual_seed(c)
    x = torch.randn(fine.num_padded, c, generator=g).to(cuda, dtype)
    if layout == "unaligned":
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        x = buf[1:].view(x.shape).copy_(x)
    got = k_apply(x, coarse.child_idx, None, coarse.valid)
    assert torch.equal(got, k_apply_plain(x, coarse.child_idx, None,
                                          coarse.valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 40, 128])
def test_segment_sum_over_many_pieces(cuda, dtype, c):
    """One segment of ~8,000 rows in pieces of 256 (8 tiles of 32 rows, 2
    for each warp of a piece's block), empty segments, invalid rows and ids
    outside [0, S): within tolerance of the twin, empty segments exactly 0,
    two runs bitwise equal."""
    rng = np.random.RandomState(2)
    n, s = 20_000, 40
    ids = rng.randint(0, s, n).astype(np.int32)
    ids[rng.rand(n) < 0.4] = 7
    ids[np.isin(ids, [0, 13, 39])] = 5
    ids[rng.rand(n) < 0.05] = -1
    ids[rng.rand(n) < 0.05] = s
    valid = rng.rand(n) > 0.1
    order, offsets = segment_order(ids, s, valid)
    pieces = segment_pieces(offsets, rows=256)
    assert pieces[8] - pieces[7] > 25
    x = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(cuda, dtype)
    args = (x, torch.from_numpy(ids).to(cuda), s,
            torch.from_numpy(valid).to(cuda))
    walk = [torch.from_numpy(a).to(cuda) for a in (order, offsets, pieces)]
    got = segment_sum(*args, *walk)
    again = segment_sum(*args, *walk)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not got[[0, 13, 39]].any()
    _close(got, segment_sum_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout", [(0, 3, 32), (0, 128, 96),
                                         (1, 32, 32), (2, 384, 256),
                                         (3, 40, 72), (2, 40, 256),
                                         (2, 136, 32), (1, 96, 128)])
def test_conv3_bwd_matches_twin(cuda, levels, dtype, lv, cin, cout):
    lvl = levels[lv].to(cuda)
    n = lvl.num_padded
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(n, cin, generator=g).to(cuda, dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    gm = (torch.randn(n, cout, generator=g).to(cuda)
          * lvl.valid[:, None]).to(dtype)
    dx, dw = conv3_bwd(x, gm, w, lvl.nbr_idx, lvl.valid)
    dx2, dw2 = conv3_bwd(x, gm, w, lvl.nbr_idx, lvl.valid)
    dw32 = conv3_dw(x, gm, lvl.nbr_idx)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dw.dtype == dtype and dw32.dtype == torch.float32
    dx_ref, _ = conv3_bwd_plain(x, gm, w, lvl.nbr_idx, lvl.valid)
    _close(dx, dx_ref, dtype)
    _close(dw32, conv3_dw_plain(x, gm, lvl.nbr_idx), dtype,
           tol=1e-4 if dtype == torch.float32 else 5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout", [(0, 3, 32), (0, 128, 96),
                                         (1, 96, 64), (2, 384, 256)])
def test_csr_conv3_matches_twin_and_kernel_1(cuda, levels, dtype, lv, cin,
                                             cout):
    """Kernel 6 against its twin and against kernel 1 on the same inputs
    (the same function), with noise in x's padding rows; the two share the
    ring main loop and its tile of the dtype and are bitwise equal on valid
    rows. The levels' row counts are multiples of 128 but not all of
    256."""
    lvl = levels[lv].to(cuda)
    csr = build_csr_graph(levels[lv].nbr_idx.numpy()).to(cuda)
    n = lvl.num_padded
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(n, cin, generator=g).to(cuda, dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(cuda),
              shift=torch.randn(cout, generator=g).to(cuda),
              residual=torch.randn(n, cout, generator=g).to(cuda, dtype),
              relu=True)
    got = csr_conv3_fwd(x, w, csr, lvl.valid, **kw)
    again = csr_conv3_fwd(x, w, csr, lvl.valid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, csr_conv3_fwd_plain(x, w, csr, lvl.valid, **kw), dtype)
    ref1 = conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw)
    _close(got, ref1, dtype)
    assert torch.equal(got[lvl.valid], ref1[lvl.valid])


def _thin_level(level):
    """The voxels of `level` whose x lies in the first two planes of their
    8^3 brick, as a level of their own (neighbour map included): each of its
    bricks has 112-row window tiles with no occupied cell."""
    from unscene3d_torch.ops.kernel_maps import build_neighbor_map_padded
    from unscene3d_torch.ops.sparse_graph import LevelGraph

    coords = level.coords[level.valid].numpy()
    keep = coords[coords[:, 1] % 8 < 2]
    n_pad = -(-(len(keep) + 1) // 128) * 128
    padded = np.zeros((n_pad, 4), np.int32)
    padded[:len(keep)] = keep
    valid = np.arange(n_pad) < len(keep)
    z = torch.zeros(0, dtype=torch.int32)
    return LevelGraph(
        coords=torch.from_numpy(padded), valid=torch.from_numpy(valid),
        nbr_idx=torch.from_numpy(build_neighbor_map_padded(keep, n_pad)),
        child_idx=z, parent_idx=z, parent_offset=z)


def _brick_case(levels, scene, cuda):
    lvl = levels[0] if scene == "level0" else _thin_level(levels[0])
    bg = be.build_brick_graph(lvl.coords.numpy(), lvl.valid.numpy()).to(cuda)
    if scene == "thin":   # every real brick has an empty row tile
        tiles = bg.occ[:, be.WIN_LO:be.WIN_LO + be.WIN_N].reshape(
            bg.nb_pad, 7, 112).any(-1)
        assert tiles.any(-1).sum() > 1 and not tiles.all(-1).any()
    return lvl.to(cuda), bg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,scene", [
    pytest.param(3, 32, "level0", id="3-32"),
    pytest.param(32, 32, "level0", id="32-32"),
    pytest.param(96, 96, "level0", id="96-96"),
    pytest.param(40, 72, "level0", id="40-72"),
    pytest.param(64, 160, "level0", id="64-160"),   # two column tiles
    pytest.param(32, 96, "thin", id="32-96-thin"),  # empty row tiles
])
def test_brick_conv3_matches_twin_and_kernel_1(cuda, levels, dtype, cin,
                                               cout, scene):
    """Kernel 7 against its twin, halo rows zero, and
    disassemble(brick_conv3(assemble(x))) against kernel 1."""
    lvl, bg = _brick_case(levels, scene, cuda)
    g = torch.Generator().manual_seed(cout)
    x = (torch.randn(lvl.num_padded, cin, generator=g).to(cuda)
         * lvl.valid[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    gb = be.assemble(x, bg)
    kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(cuda),
              offset=torch.randn(cout, generator=g).to(cuda),
              residual=torch.randn(bg.nb_pad, be.CELLS, cout,
                                   generator=g).to(cuda, dtype), relu=True)
    got = be.brick_conv3(gb, w, bg, **kw)
    again = be.brick_conv3(gb, w, bg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not got[:, :be.WIN_LO].any()
    assert not got[:, be.WIN_LO + be.WIN_N:].any()
    _close(got, be.brick_conv3_plain(gb, w, bg, kw["scale"], kw["offset"],
                                     kw["residual"], True), dtype)
    flat = be.disassemble(be.brick_conv3(gb, w, bg), bg, lvl)
    _close(flat, conv3_fwd(x, w, lvl.nbr_idx, lvl.valid), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [32, 96])
def test_brick_conv3_keeps_empty_cells_zero_near_nan(cuda, levels, dtype,
                                                     cout):
    """NaN in g wherever no occupied window cell reads it and in the
    residual at every empty cell (scale, offset and residual, no ReLU, which
    would clear a NaN): kernel 7, like its twin, writes every empty cell as
    an exact zero, in skipped and computed tiles alike."""
    lvl, bg = _brick_case(levels, "thin", cuda)
    g = torch.Generator().manual_seed(cout)
    x = (torch.randn(lvl.num_padded, 32, generator=g).to(cuda)
         * lvl.valid[:, None]).to(dtype)
    w = (torch.randn(27, 32, cout, generator=g) * 0.1).to(cuda, dtype)
    gb = be.assemble(x, bg)
    gb[~be.window_reach(bg.occ)] = float("nan")
    kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(cuda),
              offset=torch.randn(cout, generator=g).to(cuda),
              residual=torch.randn(bg.nb_pad, be.CELLS, cout,
                                   generator=g).to(cuda, dtype))
    kw["residual"][~bg.occ] = float("nan")
    got = be.brick_conv3(gb, w, bg, **kw)
    assert torch.isfinite(got).all() and not got[~bg.occ].any()
    _close(got, be.brick_conv3_plain(gb, w, bg, kw["scale"], kw["offset"],
                                     kw["residual"]), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,scene", [
    (3, 32, "level0"), (96, 96, "level0"), (40, 72, "level0"),
    (64, 160, "level0"), (32, 96, "thin"),
])
def test_proto_brick_conv_matches_twin(cuda, levels, dtype, cin, cout,
                                       scene):
    """Kernel 8 against its twin on a NaN-filled output's shape (the kernel
    writes every row), bitwise repeatable, and against kernel 7 without an
    epilogue on the occupied cells."""
    from unscene3d_torch.ops.proto_brick import (proto_brick_conv,
                                                 proto_brick_conv_plain)

    lvl, bg = _brick_case(levels, scene, cuda)
    g = torch.Generator().manual_seed(cin)
    x = (torch.randn(lvl.num_padded, cin, generator=g).to(cuda)
         * lvl.valid[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    gb = be.assemble(x, bg)
    got = proto_brick_conv(gb, w)
    again = proto_brick_conv(gb, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, proto_brick_conv_plain(gb, w), dtype)
    occ = bg.occ[..., None].to(got.dtype)
    assert torch.equal(got * occ, be.brick_conv3(gb, w, bg))


@pytest.mark.parametrize("cin,cout,group,w_sub", [
    (40, 24, 2, 256),     # ragged Cin chunk and Cout tile, many spills
    (128, 128, 8, 384),   # the prototype's widths and tables
    (36, 20, 2, 256),     # scalar rows, weights and no_gemm's row sums
])
def test_win_decompose_matches_twin_and_kernel_1(cuda, levels, cin, cout,
                                                 group, w_sub):
    """Kernel 9 (bf16) in every variant against its twin and bitwise
    repeatable, with noise on x's padding rows; `full` bitwise kernel 1 (no
    epilogue) on the valid rows without a spilled pair, the same ring main
    loop on the rows the window tables name."""
    from unscene3d_torch.ops.kernel_maps import build_neighbor_map_padded
    from unscene3d_torch.ops.win_decompose import (VARIANTS, WinTables,
                                                   win_conv_variant,
                                                   win_conv_variant_plain)
    from unscene3d_torch.ops.win_graph import build_win_graph

    lvl = levels[0]
    coords = lvl.coords[lvl.valid].numpy()
    align = 256 * group
    n_pad = -(-(len(coords) + 1) // align) * align
    nbr = build_neighbor_map_padded(coords, n_pad)
    wg = build_win_graph(nbr, n_pad, w_sub=w_sub,
                         w_union=4096 + (group - 1) * 256, group=group)
    tables = WinTables.from_graph(wg).to(cuda)
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(n_pad, cin, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda,
                                                           torch.bfloat16)
    for variant in VARIANTS:
        got = win_conv_variant(x, w, tables, variant)
        again = win_conv_variant(x, w, tables, variant)
        torch.cuda.synchronize()
        assert torch.equal(got, again), variant
        _close(got, win_conv_variant_plain(x, w, tables, variant),
               torch.bfloat16)
    valid = (torch.arange(n_pad) < len(coords)).to(cuda)
    spilled = torch.zeros(n_pad, dtype=torch.bool)
    spilled[torch.from_numpy(wg.spill_out[wg.spill_rows >= 0]).long()] = True
    rows = valid & ~spilled.to(cuda)
    full = win_conv_variant(x, w, tables, "full")
    k1 = conv3_fwd(x, w, torch.from_numpy(nbr).to(cuda), valid)
    assert rows.sum() > len(coords) // 2
    assert torch.equal(full[rows], k1[rows])


def test_csr_autograd_function_on_the_card(cuda, levels):
    """_CsrConv3 on the card (kernel 6 forward and dx, kernel 5 dW: one
    launch each per backward, csr_dw never called) against the same
    Function on the CPU (the twins), f32."""
    g = torch.Generator().manual_seed(9)
    base = levels[1]
    csr = build_csr_graph(base.nbr_idx.numpy())
    x = torch.randn(base.num_padded, 24, generator=g)
    w = torch.randn(27, 24, 40, generator=g) * 0.2
    res = {}
    for dev in ("cpu", cuda):
        lv = dataclasses.replace(base, csr=csr).to(dev)
        xd = x.clone().to(dev).requires_grad_()
        wd = w.clone().to(dev).requires_grad_()
        before = csr_conv3_fwd.launches, conv3_dw.launches
        csr_calls = []
        plain_csr_dw = csr_conv.csr_dw
        csr_conv.csr_dw = lambda *a: (csr_calls.append(1),
                                      plain_csr_dw(*a))[1]
        try:
            out = conv_ops.sparse_conv3(xd, wd, lv)
            (out * out.detach()).sum().backward()
        finally:
            csr_conv.csr_dw = plain_csr_dw
        assert not csr_calls
        if dev != "cpu":   # forward and dx; dW
            assert (csr_conv3_fwd.launches, conv3_dw.launches) == (
                before[0] + 2, before[1] + 1)
        res[str(dev)] = [t.detach().cpu() for t in (out, xd.grad, wd.grad)]
    for a, b in zip(res["cuda"], res["cpu"]):
        _close(a, b, torch.float32, tol=1e-4)


def test_autograd_functions_on_the_card(cuda, levels):
    """The k3, k2, pool and segment-sum autograd Functions on the card
    (kernels 1-5 forward and backward) against the same Functions on the
    CPU (the twins), f32: outputs and input/weight gradients."""
    L = levels
    g = torch.Generator().manual_seed(5)
    cases = {
        "conv3": (lambda x, w, lv: conv_ops.sparse_conv3(x, w, lv[1]),
                  (L[1].num_padded, 24), (27, 24, 40)),
        "down2": (lambda x, w, lv: conv_ops.sparse_conv_down2(
            x, w, lv[1], fine=lv[0]), (L[0].num_padded, 24), (8, 24, 40)),
        "up2": (lambda x, w, lv: conv_ops.sparse_conv_up2(
            x, w, lv[0], coarse=lv[1]), (L[1].num_padded, 24), (8, 24, 40)),
        "pool": (lambda x, w, lv: conv_ops.avg_pool2(x, lv[1], fine=lv[0]),
                 (L[0].num_padded, 24), None),
    }
    for name, (fn, xs, ws) in cases.items():
        x = torch.randn(*xs, generator=g)
        w = None if ws is None else torch.randn(*ws, generator=g) * 0.2
        res = {}
        for dev in ("cpu", cuda):
            lv = [lvl.to(dev) for lvl in L]
            xd = x.clone().to(dev).requires_grad_()
            wd = None if w is None else w.clone().to(dev).requires_grad_()
            out = fn(xd, wd, lv)
            (out * out.detach()).sum().backward()
            res[str(dev)] = [t.detach().cpu() for t in
                             (out, xd.grad, None if wd is None else wd.grad)
                             if t is not None]
        for a, b in zip(res["cuda"], res["cpu"]):
            _close(a, b, torch.float32, tol=1e-4)
    ids = torch.randint(-1, 50, (3000,), generator=g).int()
    valid = torch.rand(3000, generator=g) > 0.1
    order, offsets = (torch.from_numpy(a) for a in
                      segment_order(ids.numpy(), 48, valid.numpy()))
    x = torch.randn(3000, 16, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.clone().to(dev).requires_grad_()
        out = segment_sum(xd, ids.to(dev), 48, valid.to(dev),
                          order.to(dev), offsets.to(dev))
        (out * out.detach()).sum().backward()
        grads.append(xd.grad.cpu())
    _close(grads[1], grads[0], torch.float32, tol=1e-4)


@pytest.fixture(scope="module")
def brick_levels():
    """The `levels` scene collated with `brick_levels=(0,)`."""
    scene = make_scene(num_points=12_000, num_objects=4, extent=3.0, seed=3)
    batch, _ = FreeMaskCollator(voxel_size=0.02, fps_queries=8,
                                brick_levels=(0,))([scene])
    return batch.graph.levels


@pytest.fixture(scope="module")
def stride2_levels(brick_levels):
    """The same voxels' graph with the k3 stride-2 maps."""
    from unscene3d_torch.ops.kernel_maps import build_sparse_graph
    from unscene3d_torch.ops.sparse_graph import graph_from_levels

    lv0 = brick_levels[0]
    return graph_from_levels(build_sparse_graph(
        lv0.coords[lv0.valid].numpy(), build_down_nbr_maps=True)).levels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,epi", [(3, 32, "none"), (96, 96, "all"),
                                          (128, 96, "bias")])
def test_sparse_conv3_at_a_brick_level_runs_kernel_7(cuda, brick_levels,
                                                     dtype, cin, cout, epi):
    """sparse_conv3 at a level with brick tables launches kernel 7 once
    (never kernel 1 or the twin) and matches the same call on the CPU (the
    twin) and kernel 1 on the level's neighbour map; two runs bitwise
    equal."""
    lvl = brick_levels[0].to(cuda)
    g = torch.Generator().manual_seed(cin + cout)
    x = (torch.randn(lvl.num_padded, cin, generator=g).to(cuda)
         * lvl.valid[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    kw = {}
    if epi == "all":
        kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(cuda),
                  shift=torch.randn(cout, generator=g).to(cuda),
                  residual=torch.randn(lvl.num_padded, cout,
                                       generator=g).to(cuda, dtype),
                  relu=True)
    elif epi == "bias":
        kw = dict(bias=torch.randn(cout, generator=g).to(cuda))
    before = be.brick_conv3.launches, conv3_fwd.launches
    twin_calls = []
    real = be.brick_conv3_plain
    be.brick_conv3_plain = lambda *a, **k: (twin_calls.append(1),
                                            real(*a, **k))[1]
    try:
        got = conv_ops.sparse_conv3(x, w, lvl, **kw)
        again = conv_ops.sparse_conv3(x, w, lvl, **kw)
    finally:
        be.brick_conv3_plain = real
    torch.cuda.synchronize()
    assert (be.brick_conv3.launches, conv3_fwd.launches) == (
        before[0] + 2, before[1]) and not twin_calls
    assert torch.equal(got, again)
    cpu = conv_ops.sparse_conv3(x.cpu(), w.cpu(), brick_levels[0],
                                **{k: v.cpu() if torch.is_tensor(v) else v
                                   for k, v in kw.items()})
    _close(got.cpu(), cpu, dtype)
    plain = dataclasses.replace(lvl, brick=None)
    _close(got, conv_ops.sparse_conv3(x, w, plain, **kw), dtype)


def test_brick_autograd_function_on_the_card(cuda, brick_levels):
    """_BrickConv3 on the card: kernel 7 forward, kernels 4 and 5 backward,
    against the same Function on the CPU, f32; two backwards bitwise."""
    g = torch.Generator().manual_seed(11)
    base = brick_levels[0]
    x = torch.randn(base.num_padded, 24, generator=g) * base.valid[:, None]
    w = torch.randn(27, 24, 40, generator=g) * 0.2
    res = {}
    for dev in ("cpu", cuda, cuda):
        lv = base.to(dev)
        xd = x.clone().to(dev).requires_grad_()
        wd = w.clone().to(dev).requires_grad_()
        before = be.brick_conv3.launches, conv3_bwd.launches
        out = conv_ops.sparse_conv3(xd, wd, lv)
        (out * out.detach()).sum().backward()
        got = [t.detach().cpu() for t in (out, xd.grad, wd.grad)]
        if dev != "cpu":
            assert (be.brick_conv3.launches, conv3_bwd.launches) == (
                before[0] + 1, before[1] + 1)
            if "cuda" in res:
                assert all(torch.equal(a, b)
                           for a, b in zip(got, res["cuda"]))
        res[str(dev)] = got
    for a, b in zip(res["cuda"], res["cpu"]):
        _close(a, b, torch.float32, tol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout", [(1, 32, 64), (2, 64, 128),
                                         (1, 3, 40)])
def test_k_apply_k27_stride2_and_its_transpose_match_twin(
        cuda, stride2_levels, dtype, lv, cin, cout):
    """Kernel 2 at K = 27 over the cross-level k3 stride-2 map (fine rows
    into coarse rows) and over its transposed map (the dx: coarse rows into
    fine rows, W^T), against the plain twin; bitwise repeatable."""
    fine, coarse = (stride2_levels[lv - 1].to(cuda),
                    stride2_levels[lv].to(cuda))
    g = torch.Generator().manual_seed(lv * 100 + cin)
    x = (torch.randn(fine.num_padded, cin, generator=g).to(cuda)
         * fine.valid[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    gm = (torch.randn(coarse.num_padded, cout, generator=g).to(cuda)
          * coarse.valid[:, None]).to(dtype)
    wt = w.transpose(1, 2).contiguous()
    for inp, table, wk, valid in ((x, coarse.down_nbr_idx, w, coarse.valid),
                                  (gm, coarse.down_nbr_t, wt, fine.valid)):
        got = k_apply(inp, table, wk, valid)
        again = k_apply(inp, table, wk, valid)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _close(got, k_apply_plain(inp, table, wk, valid), dtype)


def test_stride2_autograd_functions_on_the_card(cuda, stride2_levels):
    """The k3 and k1 stride-2 convs and the sum pool (kernel 2 forward and
    dx) against the same Functions on the CPU, f32."""
    L = stride2_levels
    g = torch.Generator().manual_seed(12)
    cases = {
        "k3down2": (lambda x, w, lv: conv_ops.sparse_conv3_down2(
            x, w, lv[1], fine=lv[0]), (27, 24, 40)),
        "k1down2": (lambda x, w, lv: conv_ops.sparse_conv1_down2(
            x, w, lv[1], fine=lv[0]), (24, 40)),
        "sum_pool2": (lambda x, w, lv: conv_ops.sum_pool2(x, lv[1], lv[0]),
                      None),
    }
    for name, (fn, ws) in cases.items():
        x = torch.randn(L[0].num_padded, 24, generator=g) * L[0].valid[:, None]
        w = None if ws is None else torch.randn(*ws, generator=g) * 0.2
        res = {}
        for dev in ("cpu", cuda):
            lv = [lvl.to(dev) for lvl in L[:2]]
            xd = x.clone().to(dev).requires_grad_()
            wd = None if w is None else w.clone().to(dev).requires_grad_()
            out = fn(xd, wd, lv)
            (out * out.detach()).sum().backward()
            res[str(dev)] = [t.detach().cpu() for t in
                             (out, xd.grad, None if wd is None else wd.grad)
                             if t is not None]
        for a, b in zip(res["cuda"], res["cpu"]):
            _close(a, b, torch.float32, tol=1e-4)


def test_train_step_counts_every_host_sync(cuda):
    """Every synchronizing CUDA call of a train step, as torch's sync debug
    mode reports them, is counted by one of the tracer's host_syncs.<site>
    counters; each of the step's eight spans records device time once."""
    import warnings

    from unscene3d_torch.data.synthetic import make_batch
    from unscene3d_torch.train.loop import build_trainer
    from unscene3d_torch.utils import trace

    # sample sizes under every level's scene table: each round samples
    tiny = dict(num_classes=3, hidden_dim=32, num_queries=10, num_heads=2,
                dim_feedforward=64, num_decoders=1, hlevels=(0, 1, 2, 3),
                sample_sizes=(8,) * 5)
    batch, _ = FreeMaskCollator(voxel_size=0.12, fps_queries=10)(
        make_batch(2, num_points=1500))
    batch = batch.to(cuda)
    trainer = build_trainer(torch.float32, seed=0, backbone="Res16UNet14A",
                            solver="auction", device=cuda, **tiny)
    gen = torch.Generator(device=cuda).manual_seed(0)
    trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    trace.reset()
    # the first switch of a process warns once itself: switch before catching
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with trace.recording():
                trainer.train_step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    s = trace.summary()
    trace.reset()
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    counted = {k: v for k, v in s["counters"].items()
               if k.startswith("host_syncs.")}
    assert len(syncs) == sum(counted.values()), (syncs, counted)
    assert counted["host_syncs.sample_level_fill"] == 4
    assert len(s["spans"]) == 8
    assert all(v["n"] == 1 and len(v["device_ms"]) == 1
               for v in s["spans"].values())
