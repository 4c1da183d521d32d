"""The port's native host library: the k3 neighbour maps, the window-table
passes and furthest point sampling in C++ (`kernel_maps.cpp`,
`point_ops.cpp`, the port's own copies of the JAX package's sources), bound
through ctypes.

The library is built with g++ at first use into the repository's `build/`
directory (gitignored): one g++ run over both sources, written to a temp
file and renamed into place under a file lock, so concurrent processes never
load half a build. The file name carries a hash of the sources, the flags,
the compiler and what `-march=native` resolves to on this host, so an edit
rebuilds and a tree copied to another machine never loads a stale build. A
failed build raises with g++'s output, and a nonzero return code raises:
there is no fallback. The numpy twins stay beside each caller
(`native=False`) for the tests.

Each wrapper counts its calls in `<wrapper>.calls` and their wall time in
`<wrapper>.seconds`, so that a run can show that this library served it and
what it cost.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, s) for s in ("kernel_maps.cpp", "point_ops.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
# -ffp-contract=off: an FMA contraction would change the f32 rounding of
# point_ops.cpp's FPS against the numpy loop it must equal bitwise (the map
# and table code has no float math)
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-fopenmp", "-ffp-contract=off"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # coords, n, offsets, k, n_pad, fill, out
    "build_neighbor_map_padded": [_P, _I, _P, _I, _I, _I, _P],
    # xyz, n, valid, k, dist, out
    "furthest_point_sample": [_P, _I, _P, _I, _P, _P],
    # nbr, n_pad, tile, lo_reg
    "win_lo_reg": [_P, _I, _I, _P],
    # nbr, n_pad, tile, lo_of, w_reg, lidx, sp_out, sp_in, sp_k, cap
    "win_fill_lidx": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


@functools.cache
def _target(cxx: str) -> bytes:
    """What `-march=native` selects on this host (every target option g++
    resolves), part of the library's hash."""
    res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} -march=native failed:\n"
                           f"{res.stderr.decode(errors='replace')}")
    return res.stdout


def _lib_path(cxx: str, build_dir: str) -> str:
    h = hashlib.sha256(" ".join([cxx, *FLAGS]).encode())
    h.update(_target(cxx))
    for path in SOURCES:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"unscene3d_native_{h.hexdigest()[:16]}.so")


def build(cxx: str = "g++", build_dir: str = BUILD_DIR) -> str:
    """Path of the built library, compiled with `cxx` unless a build with
    the same hash exists; raises RuntimeError when `cxx` is missing or
    fails."""
    os.makedirs(build_dir, exist_ok=True)
    try:
        path = _lib_path(cxx, build_dir)
    except OSError as e:
        raise RuntimeError(f"cannot run the host compiler {cxx!r}: {e}") from e
    with open(os.path.join(build_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            res = subprocess.run([cxx, *FLAGS, "-o", tmp, *SOURCES],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise RuntimeError(f"{cxx} failed to build the native host "
                                   f"library ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built on first use; raises when it cannot be built or
    loaded."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native {name} returned {rc}")


def _counted(fn):
    """Count the wrapper's returns in `.calls` and their time in
    `.seconds`."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        wrapper.seconds += time.perf_counter() - t0
        wrapper.calls += 1
        return out
    return wrapper


@_counted
def build_neighbor_map_padded(coords: np.ndarray, offsets: np.ndarray,
                              n_pad: int, fill: int) -> np.ndarray:
    """(K, n_pad) int32 map: for row i < n and offset k, the row at
    coords[i] + offsets[k], else `fill`; the padding tail is `fill`."""
    coords = np.ascontiguousarray(coords, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    if coords.ndim != 2 or coords.shape[1] != 4 or offsets.shape[1:] != (3,):
        raise ValueError(f"coords {coords.shape}, offsets {offsets.shape}")
    # the C++ keys hold 18 bits a spatial axis and 8 for the batch: every
    # coordinate, shifted by every offset, must stay inside them (the numpy
    # twin's ops/hashing.py raises at the same bounds)
    if len(coords) and len(offsets):
        lo = coords[:, 1:].min() + offsets.min()
        hi = coords[:, 1:].max() + offsets.max()
        if lo < -(1 << 17) or hi >= (1 << 17):
            raise OverflowError("coordinates out of hashable range "
                                "[-2^17, 2^17)")
        if coords[:, 0].min() < 0 or coords[:, 0].max() >= 256:
            raise OverflowError("batch index out of range [0, 256)")
    out = np.empty((len(offsets), int(n_pad)), np.int32)
    rc = load().build_neighbor_map_padded(
        _ptr(coords), len(coords), _ptr(offsets), len(offsets), int(n_pad),
        int(fill), _ptr(out))
    _check(rc, "build_neighbor_map_padded")
    return out


@_counted
def furthest_point_sample(xyz: np.ndarray, valid: np.ndarray,
                          k: int) -> np.ndarray:
    """(k,) int32 seeds, bitwise data/collate.py:fps_numpy."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or valid.shape != (len(xyz),):
        raise ValueError(f"xyz {xyz.shape}, valid {valid.shape}")
    out = np.empty(int(k), np.int32)
    dist = np.empty(len(xyz), np.float32)
    rc = load().furthest_point_sample(_ptr(xyz), len(xyz), _ptr(valid),
                                      int(k), _ptr(dist), _ptr(out))
    _check(rc, "furthest_point_sample")
    return out


_LO_SENTINEL = np.int32(2**31 - 1)


@_counted
def win_lo_reg(nbr: np.ndarray, n_pad: int, tile: int) -> np.ndarray:
    """(3, n_tiles) int64: per region and tile the 32-aligned least valid
    neighbour row (centre offset skipped), 1 << 40 where there is none, as
    ops/win_graph.py's numpy pass gives it."""
    nbr = np.ascontiguousarray(nbr, np.int32)
    if nbr.shape != (27, n_pad):
        raise ValueError(f"nbr {nbr.shape}, n_pad {n_pad}")
    lo = np.empty((3, n_pad // tile), np.int32)
    rc = load().win_lo_reg(_ptr(nbr), int(n_pad), int(tile), _ptr(lo))
    _check(rc, "win_lo_reg")
    out = lo.astype(np.int64)
    out[lo == _LO_SENTINEL] = np.int64(1 << 40)
    return out


@_counted
def win_fill_lidx(nbr: np.ndarray, n_pad: int, tile: int, lo_of: np.ndarray,
                  w_reg) -> tuple:
    """(lidx (n_pad, 26) int16, spill out rows, in rows, offsets) in the
    numpy pass's (offset, row) order."""
    nbr = np.ascontiguousarray(nbr, np.int32)
    lo_of = np.ascontiguousarray(lo_of, np.int32)
    w_arr = np.ascontiguousarray(np.asarray(w_reg), np.int32)
    if nbr.shape != (27, n_pad) or lo_of.shape != (3, n_pad // tile):
        raise ValueError(f"nbr {nbr.shape}, lo_of {lo_of.shape}")
    lib = load()
    lidx = np.empty((n_pad, 26), np.int16)
    cap = 4096
    while True:
        sp = np.empty((3, cap), np.int32)
        n = lib.win_fill_lidx(_ptr(nbr), int(n_pad), int(tile), _ptr(lo_of),
                              _ptr(w_arr), _ptr(lidx), _ptr(sp[0]),
                              _ptr(sp[1]), _ptr(sp[2]), cap)
        if n >= 0:
            break
        cap = -n    # the spill buffers were too small: n = -needed
    return lidx, sp[0, :n], sp[1, :n], sp[2, :n]


WRAPPERS = (build_neighbor_map_padded, furthest_point_sample, win_lo_reg,
            win_fill_lidx)


def calls() -> dict:
    """The call count of every wrapper, by name."""
    return {fn.__name__: fn.calls for fn in WRAPPERS}


def seconds() -> dict:
    """The wall time of every wrapper's calls, by name."""
    return {fn.__name__: fn.seconds for fn in WRAPPERS}


def reset_calls() -> None:
    for fn in WRAPPERS:
        fn.calls = 0
        fn.seconds = 0.0


reset_calls()
