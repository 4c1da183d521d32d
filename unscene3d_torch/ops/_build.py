"""Build and bind the hand-written CUDA kernels (`unscene3d_torch/csrc/*.cu`).

The sources are compiled at first use with `nvcc` for `sm_90a`, one nvcc
process per source, all started together, and linked into one shared
library with a plain C interface under the repository's `build/` directory
(gitignored), then loaded with ctypes. The file name carries a hash of the
sources and flags, so an edit rebuilds and a warm tree reuses the library.
Every pointer and the stream pass as `c_void_p`; each C entry point returns
`cudaGetLastError()` after its launch, and `check` raises on a nonzero
code. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (all return int = cudaError_t)
_SIGNATURES = {
    # x, w, nbr, valid, scale, shift, residual, out, n, cin, cout, relu,
    # is_bf16, stream
    "conv3_fwd": [_P] * 8 + [_I] * 5 + [_P],
    # x, w, table, valid, out, K, n_out, n_in, cin, cout, is_bf16, stream
    "k_apply_gemm": [_P] * 5 + [_I] * 6 + [_P],
    # x, table, valid, out, K, n_out, n_in, c, is_bf16, stream
    "k_apply_sum": [_P] * 4 + [_I] * 5 + [_P],
    # x, order, offsets, out, num_segments, c, is_bf16, stream
    "segment_sum": [_P] * 4 + [_I] * 3 + [_P],
    # gm, wflip, nbr, valid, dx, n, cin, cout, is_bf16, stream
    "conv3_bwd_dx": [_P] * 5 + [_I] * 4 + [_P],
    # x, gm, nbr, partials, dw, n, cin, cout, splits, rows_per_split,
    # is_bf16, stream
    "conv3_dw": [_P] * 5 + [_I] * 6 + [_P],
    # x, w, pair_in, pair_out, tile_start, valid, scale, shift, residual, out,
    # n, cin, cout, relu, is_bf16, stream
    "csr_conv3_fwd": [_P] * 10 + [_I] * 5 + [_P],
    # g, w, asm_idx, scale, shift, residual, out, nb, sentinel, cin, cout,
    # relu, is_bf16, stream
    "brick_conv3": [_P] * 7 + [_I] * 6 + [_P],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the nvcc run, if one ran
build_log: str = ""                  # nvcc/ptxas output of that run


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _lib_path(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(srcs + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"unscene3d_kernels_{h.hexdigest()[:16]}.so")


def _compile(srcs: list[str], out: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs, codes = [], []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
            codes.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not any(codes):
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=300)
        logs.append(link.stdout + link.stderr)
        codes.append(link.returncode)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for path in objs:
        if os.path.exists(path):
            os.unlink(path)
    if any(codes):
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({codes}):\n{build_log}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use; raises when it cannot be
    built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        path = _lib_path(srcs)
        if not os.path.exists(path):
            _compile(srcs, path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def ptr(t) -> ctypes.c_void_p | None:
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
