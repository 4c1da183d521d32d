"""The port's CUDA kernel sources compiled for the CPU against a small CUDA
emulation (tests/cuda_emu/cuda_shim.h), and what the emulated kernel tests
(tests/test_torch_kernels_emulated_*.py) share: the library fixture `emu`,
the small batch's levels, the brick scenes, tolerances and helpers.

A CUDA kernel has no interpreter, and the CPU has no nvcc: these tests check
the kernels' index arithmetic, neighbour skipping, epilogue order, validity
masks, the bf16 tensor-core tiling (WMMA emulated per warp), warp shuffles
and bf16 rounding on every run. They say nothing about speed, occupancy or
what nvcc accepts; tests/test_torch_cuda.py covers the card. `emu` skips
when no C++20 compiler is present.

The library is built once per content (every source, the shim and this
file) under the repository's build/cuda_emu/ (gitignored), one g++ per
source, all started together; a file lock lets one test process build it
while the others wait, and a finished build is renamed into place, so no
process loads half a build.

Tolerances, relative to max|twin|: f32 1e-5 (summation order only); bf16
8e-3 (an output may round one bf16 ulp apart).
"""

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_batch
from unscene3d_torch.ops import _build
from unscene3d_torch.ops import brick_engine as be

EMU_DIR = os.path.dirname(os.path.abspath(__file__))
SHIM = os.path.join(EMU_DIR, "cuda_shim.h")
_LAUNCH = re.compile(r"(\w[\w:<>, ]*?)<<<(.*?)>>>\((.*?)\);", re.S)
# dynamic shared memory: `extern __shared__ [__align__(n)] T name[];`
_DYNAMIC_SMEM = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")
_FLAGS = ["-std=c++20", "-O1", "-fPIC", "-pthread"]
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}   # as tests/test_torch_cuda.py
_P, _I = ctypes.c_void_p, ctypes.c_int
# the shim's own checks (shim_checks.cu) and the serial f32 reference
# (serial_ref.cu), beside the port's entry points
_EMU_SIGNATURES = {
    "emu_wmma_at": [_I, _P],
    "emu_wmma_col_major": [_P] * 2,
    "emu_ballot": [_P] * 3 + [_I],
    "emu_shfl": [_P] * 2 + [_I],
    "serial_gather_gemm_f32": [_P] * 8 + [_I] * 6,
}


def _sources():
    return sorted(glob.glob(os.path.join(_build.CSRC, "*.cu*"))
                  + [os.path.join(EMU_DIR, "shim_checks.cu"),
                     os.path.join(EMU_DIR, "serial_ref.cu")])


def _compile(cxx, d):
    """Rewrite every source for the shim into d and build d/emu.so."""
    for name in ("cuda_runtime.h", "cuda_bf16.h", "mma.h",   # in the shim
                 "cuda_pipeline.h"):
        with open(os.path.join(d, name), "w"):
            pass
    flags = [cxx, *_FLAGS, "-include", SHIM, f"-I{d}"]
    objs = []
    for path in _sources():
        with open(path) as f:
            src = _LAUNCH.sub(
                lambda m: f"emu_launch({m.group(2)}, [&] {{ {m.group(1)}"
                          f"({m.group(3)}); }});", f.read())
        src = _DYNAMIC_SMEM.sub(
            r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_smem());", src)
        out = os.path.join(d, os.path.basename(path))
        with open(out, "w") as f:
            f.write(src)
        if path.endswith(".cu"):
            objs.append(out + ".o")
    # one g++ per source, all started together, then one link
    procs = [subprocess.Popen(flags + ["-c", "-x", "c++", obj[:-2], "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for obj in objs]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "".join(logs)
    res = subprocess.run([cxx, "-shared", "-pthread", "-o",
                          os.path.join(d, "emu.so"), *objs],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _content_hash(cxx):
    h = hashlib.sha256(" ".join([cxx, *_FLAGS]).encode())
    for path in _sources() + [SHIM, os.path.abspath(__file__)]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.cache
def load_library(cxx):
    """The emulated kernel library, built at most once per content."""
    root = os.path.join(_build.BUILD_DIR, "cuda_emu")
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, _content_hash(cxx))
    with open(os.path.join(root, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if not os.path.exists(final):
            tmp = tempfile.mkdtemp(dir=root, prefix="building-")
            try:
                _compile(cxx, tmp)
                os.rename(tmp, final)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(os.path.join(final, "emu.so"))
    for name, argtypes in {**_build._SIGNATURES, **_EMU_SIGNATURES}.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emu():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ with C++20 <barrier>")
    return load_library(cxx)


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


def _brick_level(xyz, n_pad, nb_pad):
    """A level of the given voxels padded to n_pad rows, and its brick graph
    padded to nb_pad bricks."""
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
    rng = np.random.RandomState(0)
    xyz = np.unique(rng.randint(0, [16, 8, 8], (260, 3)), axis=0)
    return _brick_level(xyz, 256, 3)


@pytest.fixture(scope="module")
def thin_bricks():
    """One brick whose voxels all lie at x < 2, and the pad brick: five of
    the real brick's seven 112-row window tiles hold no occupied cell, and
    so do some 16-row strips of the sixth."""
    rng = np.random.RandomState(1)
    xyz = np.unique(rng.randint(0, [2, 8, 8], (80, 3)), axis=0)
    lvl, bg = _brick_level(xyz, 128, 2)
    win = bg.occ[:, be.WIN_LO:be.WIN_LO + be.WIN_N]
    tiles = win.reshape(bg.nb_pad, 7, 112).any(-1)
    assert tiles[0].sum() == 2 and not tiles[1].any()
    return lvl, bg
