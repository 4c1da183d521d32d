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
also held against kernel 1's twin: the same function from other tables;
kernel 6 runs kernel 1's ring main loop and tile and equals emulated kernel
1 bitwise on valid rows in both dtypes. In f32, kernels 1, 4 (dx) and 6 are
held bitwise to a serial fmaf chain (tests/cuda_emu/serial_ref.cu), the
summation order they promise.
Kernels 8 and 9 are emulated in tests/test_torch_kernels_emulated_proto.py (a
file of its own, so that the two run on different workers).
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

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
SHIM = os.path.join(EMU_DIR, "cuda_shim.h")
_LAUNCH = re.compile(r"(\w[\w:<>, ]*?)<<<(.*?)>>>\((.*?)\);", re.S)
# dynamic shared memory: `extern __shared__ [__align__(n)] T name[];`
_DYNAMIC_SMEM = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}   # as tests/test_torch_cuda.py


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ with C++20 <barrier>")
    d = tmp_path_factory.mktemp("cuda_emu")
    for name in ("cuda_runtime.h", "cuda_bf16.h", "mma.h",   # in the shim
                 "cuda_pipeline.h"):
        (d / name).write_text("")
    flags = [cxx, "-std=c++20", "-O1", "-fPIC", "-pthread", "-include", SHIM,
             f"-I{d}"]
    objs = []
    for path in (glob.glob(os.path.join(_build.CSRC, "*.cu*"))
                 + [os.path.join(EMU_DIR, "shim_checks.cu"),
                    os.path.join(EMU_DIR, "serial_ref.cu")]):
        src = _LAUNCH.sub(
            lambda m: f"emu_launch({m.group(2)}, [&] {{ {m.group(1)}"
                      f"({m.group(3)}); }});", open(path).read())
        src = _DYNAMIC_SMEM.sub(
            r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_smem());", src)
        out = d / os.path.basename(path)
        out.write_text(src)
        if path.endswith(".cu"):
            objs.append(str(out) + ".o")
    # one g++ per source, all started together, then one link
    procs = [subprocess.Popen(flags + ["-c", "-x", "c++", obj[:-2], "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for obj in objs]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "".join(logs)
    res = subprocess.run([cxx, "-shared", "-pthread", "-o", str(d / "emu.so"),
                          *objs], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(d / "emu.so"))
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.emu_wmma_at.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.emu_wmma_at.restype = ctypes.c_int
    lib.emu_wmma_col_major.argtypes = [ctypes.c_void_p] * 2
    lib.emu_wmma_col_major.restype = ctypes.c_int
    lib.emu_ballot.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.emu_ballot.restype = ctypes.c_int
    lib.serial_gather_gemm_f32.argtypes = ([ctypes.c_void_p] * 8
                                           + [ctypes.c_int] * 6)
    lib.serial_gather_gemm_f32.restype = ctypes.c_int
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


def _unaligned(t):
    """t's values in a contiguous tensor whose base is one element past a
    16-byte boundary: the kernels' scalar staging path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def _dead_tiles(lvl, rows=128):
    """Row tiles of `rows` rows in which no offset has a neighbour."""
    n = lvl.num_padded
    hit = (lvl.nbr_idx != n - 1).any(0)
    hit = torch.cat([hit, hit.new_zeros(-n % rows)])
    return int((~hit.view(-1, rows).any(1)).sum())


def _tables(levels, lv, cin):
    """(neighbour map, validity, rows, a seeded generator) of level lv; lv
    "ragged": the 200-row map of _ragged_map, where offset 0 has a
    neighbour in the first 32-row group and none in the second."""
    if lv == "ragged":
        nbr, g = _ragged_map()
        n = nbr.shape[1]
        nbr[0, 32:64] = n - 1
        assert (nbr[0, :32] != n - 1).any()
        return nbr, torch.arange(n) < n - 1, n, g
    lvl = levels[lv]
    return (lvl.nbr_idx, lvl.valid, lvl.num_padded,
            torch.Generator().manual_seed(lv * 100 + cin))


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
    code = emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(valid), _p(sc), _p(sh),
                         _p(res), _p(out), n, cin, cout, int(relu),
                         int(dtype == torch.bfloat16), None)
    assert code == 0
    _close(out, conv3_fwd_plain(x, w, nbr, valid, sc, sh, res, relu), dtype)


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


def _ragged_map(n=200):
    """A random (27, n) map whose misses point at row n - 1: a level of n
    rows, no multiple of the table's 64-row tiles nor of the kernels' 64-
    and 128-row tiles (the function is defined by the tables alone)."""
    rng = torch.Generator().manual_seed(0)
    nbr = torch.full((27, n), n - 1, dtype=torch.int32)
    hit = torch.rand(27, n - 1, generator=rng) < 0.3
    src = torch.randint(0, n - 1, (27, n - 1), generator=rng).int()
    nbr[:, :n - 1] = torch.where(hit, src, nbr[:, :n - 1])
    nbr[13, :n - 1] = torch.arange(n - 1, dtype=torch.int32)
    return nbr, rng


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
    assert emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(valid), _p(sc), _p(sh),
                         _p(res), _p(out1), n, cin, cout, int(relu), bf,
                         None) == 0
    assert torch.equal(out6[valid], out1[valid])
    assert not out6[~valid].any()
    _close(out6, csr_conv3_fwd_plain(x, w, csr, valid, sc, sh, res, relu),
           dtype)


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
    if kernel == "csr":
        csr = build_csr_graph(nbr.numpy())
        code = emu.csr_conv3_fwd(
            _p(x), _p(w), _p(csr.pair_in), _p(csr.pair_out),
            _p(csr.tile_start), _p(valid), _p(sc), _p(sh), _p(res), _p(out),
            n, cin, cout, int(relu), 0, None)
    elif kernel == "dx":   # x plays gm (N, Cin), w the flip-transposed weights
        code = emu.conv3_bwd_dx(_p(x), _p(w), _p(nbr), _p(valid), _p(out), n,
                                cout, cin, 0, None)
    else:
        code = emu.conv3_fwd(_p(x), _p(w), _p(nbr), _p(valid), _p(sc),
                             _p(sh), _p(res), _p(out), n, cin, cout,
                             int(relu), 0, None)
    assert code == 0
    ref = torch.full((n, cout), float("nan"))
    assert emu.serial_gather_gemm_f32(
        _p(x), _p(w), _p(nbr), _p(valid), _p(sc), _p(sh), _p(res), _p(ref),
        27, n, n - 1, cin, cout, int(relu)) == 0
    assert torch.equal(out[valid], ref[valid])


def _brick_level(xyz, n_pad, nb_pad):
    """A level of the given voxels padded to n_pad rows, and its brick graph
    padded to nb_pad bricks."""
    import numpy as np

    from unscene3d_torch.ops.kernel_maps import build_neighbor_map_padded
    from unscene3d_torch.ops.sparse_graph import LevelGraph

    n = len(xyz)
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
    return lvl, be.build_brick_graph(coords, valid, nb_pad=nb_pad)


@pytest.fixture(scope="module")
def bricks():
    """~200 voxels over two adjacent bricks and the pad brick (the emulation
    runs every thread of every block as a CPU thread: keep it small)."""
    import numpy as np

    rng = np.random.RandomState(0)
    xyz = np.unique(rng.randint(0, [16, 8, 8], (260, 3)), axis=0)
    return _brick_level(xyz, 256, 3)


@pytest.fixture(scope="module")
def thin_bricks():
    """One brick whose voxels all lie at x < 2, and the pad brick: five of
    the real brick's seven 112-row window tiles hold no occupied cell, and
    so do some 16-row strips of the sixth."""
    import numpy as np

    rng = np.random.RandomState(1)
    xyz = np.unique(rng.randint(0, [2, 8, 8], (80, 3)), axis=0)
    lvl, bg = _brick_level(xyz, 128, 2)
    win = bg.occ[:, be.WIN_LO:be.WIN_LO + be.WIN_N]
    tiles = win.reshape(bg.nb_pad, 7, 112).any(-1)
    assert tiles[0].sum() == 2 and not tiles[1].any()
    return lvl, bg


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


@pytest.mark.parametrize("offset,aligned", [(0, True), (16, True),
                                            (8, False), (3, False)])
def test_emulation_rejects_misaligned_wmma_pointers(emu, offset, aligned):
    """The card needs 32-byte aligned WMMA fragment pointers: the shim
    reports any other as cudaErrorMisalignedAddress (716), so that a shifted
    fragment the card would reject fails here first."""
    out = torch.full((16, 16), float("nan"))
    code = emu.emu_wmma_at(offset, _p(out))
    if aligned:
        assert code == 0 and torch.equal(out, torch.full((16, 16), 16.0))
    else:
        assert code == 716


@pytest.mark.parametrize("construct", ["col_major", "ballot"])
def test_emulation_of_col_major_fragments_and_ballots(emu, construct):
    """Two constructs of the shim that kernel 5 uses. "col_major": a
    column-major matrix_a fragment reads its tile transposed. "ballot":
    __ballot_sync puts each lane's predicate in its bit (ranks and counts
    per warp, over a block of two and a half warps)."""
    if construct == "col_major":
        tile = torch.arange(256, dtype=torch.float32).view(16, 16)
        out = torch.full((16, 16), float("nan"))
        assert emu.emu_wmma_col_major(_p(tile), _p(out)) == 0
        assert torch.equal(out, tile.t())
        return
    threads = 80
    pred = (torch.arange(threads) * 7 % 5 < 2).int()
    rank = torch.full((threads,), -1, dtype=torch.int32)
    count = torch.full((threads,), -1, dtype=torch.int32)
    assert emu.emu_ballot(_p(pred), _p(rank), _p(count), threads) == 0
    for w0 in range(0, threads, 32):
        p = pred[w0:w0 + 32]
        assert torch.equal(rank[w0:w0 + 32], (torch.cumsum(p, 0) - p).int())
        assert (count[w0:w0 + 32] == int(p.sum())).all()
