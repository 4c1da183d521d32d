"""The port's CUDA kernel sources, compiled for the CPU against a small CUDA
emulation (tests/cuda_emu/cuda_shim.h) and held against their plain twins.

A CUDA kernel has no interpreter, and the CPU has no nvcc: this checks the
kernels' index arithmetic, neighbour skipping, epilogue order, validity
masks, the bf16 tensor-core tiling (WMMA emulated per warp) and bf16
rounding on every run. It says nothing about speed, occupancy
or what nvcc accepts; tests/test_torch_cuda.py covers the card. Skips when no
C++20 compiler is present.

Tolerances, relative to max|twin|: f32 1e-5 (summation order only); bf16
8e-3 (an output may round one bf16 ulp apart). The dW kernel's output is f32
in both dtypes (exact products summed in f32): 1e-5. Kernels 6 and 7 are
also held against kernel 1's twin: the same function from other tables.
"""

import ctypes
import glob
import os
import re
import shutil
import subprocess

import pytest
import torch

from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_batch
from unscene3d_torch.ops import _build
from unscene3d_torch.ops import brick_engine as be
from unscene3d_torch.ops.conv3 import (conv3_bwd_plain, conv3_dw_plain,
                                       conv3_fwd_plain, dw_splits)
from unscene3d_torch.ops.csr_conv import build_csr_graph, csr_conv3_fwd_plain
from unscene3d_torch.ops.k_apply import k_apply_plain
from unscene3d_torch.ops.segment_pool import segment_order, segment_sum_plain

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu",
                    "cuda_shim.h")
_LAUNCH = re.compile(r"(\w[\w:<>, ]*?)<<<(.*?)>>>\((.*?)\);", re.S)
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}   # as tests/test_torch_cuda.py


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ with C++20 <barrier>")
    d = tmp_path_factory.mktemp("cuda_emu")
    for name in ("cuda_runtime.h", "cuda_bf16.h", "mma.h"):  # in the shim
        (d / name).write_text("")
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           "-include", SHIM, f"-I{d}", "-o", str(d / "emu.so")]
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu*")):
        src = _LAUNCH.sub(
            lambda m: f"emu_launch({m.group(2)}, [&] {{ {m.group(1)}"
                      f"({m.group(3)}); }});", open(path).read())
        out = d / os.path.basename(path)
        out.write_text(src)
        if path.endswith(".cu"):
            cmd += ["-x", "c++", str(out)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(d / "emu.so"))
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def levels():
    batch, _ = FreeMaskCollator(voxel_size=0.12, fps_queries=8)(
        make_batch(2, num_points=1500))
    return batch.graph.levels


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _close(got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-6)
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout,epi", [
    (1, 3, 32, "scale_relu"),        # narrow stem, 32-wide tiles
    (2, 32, 32, "all"),              # + residual
    (2, 64, 96, "none"),             # Cout not a multiple of 64
    (3, 40, 64, "all"),              # ragged Cin chunk, 64-wide tiles
    (4, 128, 256, "scale_relu"),
])
def test_emulated_conv3(emu, levels, dtype, lv, cin, cout, epi):
    lvl = levels[lv]
    n = lvl.num_padded
    g = torch.Generator().manual_seed(lv * 100 + cin)
    x = torch.randn(n, cin, generator=g).to(dtype)      # noisy padding rows
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    sc = sh = res = None
    if epi != "none":
        sc = torch.rand(cout, generator=g) + 0.5
        sh = torch.randn(cout, generator=g)
    if epi == "all":
        res = torch.randn(n, cout, generator=g).to(dtype)
    relu = epi != "none"
    out = torch.empty(n, cout, dtype=dtype)
    code = emu.conv3_fwd(_p(x), _p(w), _p(lvl.nbr_idx), _p(lvl.valid),
                         _p(sc), _p(sh), _p(res), _p(out), n, cin, cout,
                         int(relu), int(dtype == torch.bfloat16), None)
    assert code == 0
    _close(out, conv3_fwd_plain(x, w, lvl.nbr_idx, lvl.valid, sc, sh, res,
                                relu), dtype)


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
    order, offsets = (torch.from_numpy(a) for a in
                      segment_order(ids.numpy(), s, valid.numpy()))
    x = torch.randn(n, c, generator=g).to(dtype)
    out = torch.empty(s, c, dtype=dtype)
    code = emu.segment_sum(_p(x), _p(order), _p(offsets), _p(out), s, c,
                           int(dtype == torch.bfloat16), None)
    assert code == 0
    _close(out, segment_sum_plain(x, ids, s, valid), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lv,cin,cout", [
    (2, 3, 32),       # the stem's narrow input: 32 x 32 FMA tiles
    (3, 32, 64),      # 32 x 64 FMA tiles
    (3, 96, 32),      # 64 x 32 FMA tiles
    (4, 40, 72),      # ragged 64 x 64 tiles
])
def test_emulated_conv3_bwd(emu, levels, dtype, lv, cin, cout):
    """Kernel 4's dx entry (the gather-GEMM of gm with flip-transposed
    weights) and kernel 5 (dW), the latter over one row range and over
    three, whose partials the second pass sums."""
    lvl = levels[lv]
    n = lvl.num_padded
    g = torch.Generator().manual_seed(lv * 100 + cin)
    bf = int(dtype == torch.bfloat16)
    x = torch.randn(n, cin, generator=g).to(dtype)      # noisy padding rows
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    gm = (torch.randn(n, cout, generator=g)
          * lvl.valid[:, None]).to(dtype)
    dx_ref, _ = conv3_bwd_plain(x, gm, w, lvl.nbr_idx, lvl.valid)
    wf = torch.flip(w, dims=(0,)).transpose(1, 2).contiguous()
    dx = torch.empty(n, cin, dtype=dtype)
    assert emu.conv3_bwd_dx(_p(gm), _p(wf), _p(lvl.nbr_idx), _p(lvl.valid),
                            _p(dx), n, cin, cout, bf, None) == 0
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
    """A level of 200 rows, no multiple of the table's 64-row tiles nor of
    the kernels' 64- and 128-row tiles: the last tile's pair range ends where
    the next offset's begins, and the last block masks its missing rows. The
    map is random (the function is defined by the tables alone)."""
    rng = torch.Generator().manual_seed(0)
    n, cin, cout = 200, 24, 40
    nbr = torch.full((27, n), n - 1, dtype=torch.int32)
    hit = torch.rand(27, n - 1, generator=rng) < 0.3
    src = torch.randint(0, n - 1, (27, n - 1), generator=rng).int()
    nbr[:, :n - 1] = torch.where(hit, src, nbr[:, :n - 1])
    nbr[13, :n - 1] = torch.arange(n - 1, dtype=torch.int32)
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


@pytest.fixture(scope="module")
def bricks():
    """~200 voxels over two adjacent bricks and the pad brick (the emulation
    runs every thread of every block as a CPU thread: keep it small)."""
    import numpy as np

    from unscene3d_torch.ops.kernel_maps import build_neighbor_map_padded
    from unscene3d_torch.ops.sparse_graph import LevelGraph

    rng = np.random.RandomState(0)
    xyz = np.unique(rng.randint(0, [16, 8, 8], (260, 3)), axis=0)
    n, n_pad = len(xyz), 256
    assert n < n_pad
    coords = np.zeros((n_pad, 4), np.int32)
    coords[:n, 1:] = xyz
    valid = np.arange(n_pad) < n
    z = torch.zeros(0, dtype=torch.int32)
    lvl = LevelGraph(coords=torch.from_numpy(coords),
                     valid=torch.from_numpy(valid),
                     nbr_idx=torch.from_numpy(
                         build_neighbor_map_padded(coords[:n], n_pad)),
                     child_idx=z, parent_idx=z, parent_offset=z)
    return lvl, be.build_brick_graph(coords, valid, nb_pad=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,epi", [
    (3, 32, "none"),
    (16, 24, "all"),         # 32-wide f32 tiles, ragged bf16 tile
    (40, 64, "all"),         # ragged Cin chunk, 64-wide tiles
])
def test_emulated_brick_conv3(emu, bricks, dtype, cin, cout, epi):
    """Kernel 7 against its twin, the ragged last row tile, the pad brick and
    the zeroed halo rows included; the output buffer starts as NaN."""
    lvl, bg = bricks
    g = torch.Generator().manual_seed(cin)
    x = (torch.randn(lvl.num_padded, cin, generator=g)
         * lvl.valid[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=g) * 0.1).to(dtype)
    gb = be.assemble(x, bg).contiguous()
    sc = sh = res = None
    if epi == "all":
        sc = torch.rand(cout, generator=g) + 0.5
        sh = torch.randn(cout, generator=g)
        res = torch.randn(bg.nb_pad, be.CELLS, cout, generator=g).to(dtype)
    relu = epi == "all"
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
