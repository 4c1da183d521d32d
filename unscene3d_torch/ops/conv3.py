"""Kernel 1: k3 submanifold sparse conv forward with fused epilogue.

Replaces unscene3d_tpu/ops/window_conv.py:window_conv3_fwd (Pallas `_kernel`).

    out[i] = valid[i] * epi(sum_{k<27} x[nbr_idx[k, i]] @ w[k])

f32 accumulation; epi = *scale + shift (bias folded into shift), + residual,
ReLU, then the validity mask (window_conv.py:531-539). Entries of nbr_idx
equal to N-1 (the always-padding row) are missing neighbours and skipped.

Bound on the H100: the row gather, ~8.7 valid neighbour rows x Cin x itemsize
per output row at level 0 of the bench scene. The CUDA kernel
(csrc/conv3.cu, csrc/gather_gemm.cuh) tiles output rows x channels per
block, skips offsets absent from the whole tile and gathers rows straight
from the neighbour map; see the header for the design.

`conv3_fwd` runs the plain twin `conv3_fwd_plain` for CPU tensors only. For a
CUDA tensor it launches the kernel or raises; `conv3_fwd.launches` counts the
launches.

Kernels 4 and 5: the backward (csrc/conv3_bwd.cu), replacing
window_conv.py:window_conv3_bwd_fused (Pallas `_bwd_fused_kernel`) and
window_conv3_dw (Pallas `_dw_kernel`). With gm the output gradient masked to
valid rows,

    dx[i] = valid[i] * sum_k gm[nbr_idx[k, i]] @ w[26 - k]^T
    dW[k] = sum_i x[nbr_idx[k, i]]^T (x) gm[i]          (f32, all 27 offsets)

`conv3_bwd` launches the dx gather-GEMM (kernel 1's body under its own entry
point) and then `conv3_dw`; `conv3_dw` launches the dW kernel, which reduces
fixed row ranges into an f32 scratch and sums them in a second pass (no
atomics). Each has a plain twin and its own launch counter. The autograd
Function that uses them is ops/conv_ops.py:_Conv3.
"""

from __future__ import annotations

import torch

from unscene3d_torch.ops import _build

_SUPPORTED = (torch.float32, torch.bfloat16)


def fold_bias(bias, scale, shift, cout, device):
    """Fold a conv bias into the epilogue's scale/shift (window_conv.py:991-997):
    (acc + b) * s + h == acc * s + (h + b * s)."""
    if bias is None:
        return scale, shift
    bias = bias.float()
    if scale is not None:
        return scale, shift.float() + bias * scale.float()
    return torch.ones(cout, dtype=torch.float32, device=device), bias


def epilogue(acc, valid, scale=None, shift=None, residual=None, relu=False):
    """f32 epilogue on an f32 accumulator: *scale+shift, +residual, ReLU,
    validity mask (window_conv.py:_epilogue)."""
    y = acc
    if scale is not None:
        y = y * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y * valid[:, None].to(torch.float32)


def conv3_fwd_plain(x, w, nbr_idx, valid, scale=None, shift=None,
                    residual=None, relu=False):
    """Plain PyTorch twin of the kernel: 27 masked row gathers, each followed
    by an f32 matmul."""
    n = x.shape[0]
    xf = x.float()
    wf = w.float()
    acc = torch.zeros(n, w.shape[-1], dtype=torch.float32, device=x.device)
    for k in range(nbr_idx.shape[0]):
        idx = nbr_idx[k].long()
        g = xf[idx] * (idx != n - 1)[:, None].to(torch.float32)
        acc = acc + g @ wf[k]
    return epilogue(acc, valid, scale, shift, residual, relu).to(x.dtype)


def _check(x, w, nbr_idx, valid, scale, shift, residual):
    n, cin = x.shape
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"conv3_fwd: unsupported dtype {x.dtype}")
    if w.shape[0] != 27 or w.shape[1] != cin or w.dtype != x.dtype:
        raise ValueError(f"conv3_fwd: w {tuple(w.shape)} {w.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    if nbr_idx.shape != (27, n) or nbr_idx.dtype != torch.int32:
        raise ValueError(f"conv3_fwd: nbr_idx {tuple(nbr_idx.shape)} "
                         f"{nbr_idx.dtype}, want (27, {n}) int32")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError("conv3_fwd: valid must be (N,) bool")
    if (scale is None) != (shift is None):
        raise ValueError("conv3_fwd: scale and shift go together")
    cout = w.shape[-1]
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (t.shape != (cout,) or t.dtype != torch.float32):
            raise ValueError(f"conv3_fwd: {name} must be ({cout},) float32")
    if residual is not None and (residual.shape != (n, cout)
                                 or residual.dtype != x.dtype):
        raise ValueError("conv3_fwd: residual must be (N, Cout) in x.dtype")
    for t in (x, w, nbr_idx, valid, scale, shift, residual):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("conv3_fwd: tensors must be contiguous on "
                             "x's device")


def conv3_fwd(x, w, nbr_idx, valid, scale=None, shift=None, residual=None,
              relu=False):
    """x: (N, Cin) f32/bf16; w: (27, Cin, Cout) in x.dtype; nbr_idx: (27, N)
    int32; valid: (N,) bool; scale/shift: (Cout,) f32; residual: (N, Cout)
    in x.dtype. Returns (N, Cout) in x.dtype."""
    if x.device.type == "cpu":
        return conv3_fwd_plain(x, w, nbr_idx, valid, scale, shift, residual,
                               relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3_fwd: unsupported device {x.device}")
    _check(x, w, nbr_idx, valid, scale, shift, residual)
    n, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty(n, cout, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = _build.load()
    code = lib.conv3_fwd(
        _build.ptr(x), _build.ptr(w), _build.ptr(nbr_idx), _build.ptr(valid),
        _build.ptr(scale), _build.ptr(shift), _build.ptr(residual),
        _build.ptr(out), n, cin, cout, int(bool(relu)),
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "conv3_fwd")
    conv3_fwd.launches += 1
    return out


conv3_fwd.launches = 0


# ------------------------------------------------------- kernels 4 and 5
# the dW kernel's grid: ~8 waves of blocks on 132 SMs, each row range at
# least _DW_MIN_ROWS rows (fewer, longer ranges keep the partials small)
_DW_TARGET_BLOCKS = 1024
_DW_MIN_ROWS = 2048


def flip_transpose(w):
    """W'[k] = W[26-k]^T: the k3 offset set is symmetric (offset 26-k is
    -offset k), so dx is the forward conv of gm with these weights."""
    return torch.flip(w, dims=(0,)).transpose(1, 2).contiguous()


def conv3_dw_plain(x, gm, nbr_idx):
    """Plain twin of kernel 5: 27 masked row gathers, each followed by an f32
    matmul with gm. Returns (27, Cin, Cout) f32."""
    n = x.shape[0]
    xf = x.float()
    gf = gm.float()
    dws = []
    for k in range(nbr_idx.shape[0]):
        idx = nbr_idx[k].long()
        g = xf[idx] * (idx != n - 1)[:, None].to(torch.float32)
        dws.append(g.T @ gf)
    return torch.stack(dws)


def conv3_bwd_plain(x, gm, w, nbr_idx, valid):
    """Plain twin of kernel 4: dx = conv3_fwd_plain(gm, flip_transpose(w))
    in x.dtype, dW = conv3_dw_plain in w's dtype."""
    dx = conv3_fwd_plain(gm, flip_transpose(w), nbr_idx, valid)
    return dx, conv3_dw_plain(x, gm, nbr_idx).to(w.dtype)


def dw_splits(n: int, cin: int, cout: int) -> tuple[int, int]:
    """(row ranges, rows per range) of the dW kernel: enough blocks to fill
    the card, none shorter than _DW_MIN_ROWS rows; a function of the shapes
    only, so the summation order is fixed."""
    tiles = 27 * -(-cin // 64) * -(-cout // 64)
    splits = max(1, min(-(-_DW_TARGET_BLOCKS // tiles), n // _DW_MIN_ROWS))
    rows = -(-n // splits)
    rows = -(-rows // 32) * 32
    return -(-n // rows), rows


def _check_bwd(name, x, gm, nbr_idx):
    n, _ = x.shape
    if x.dtype not in _SUPPORTED or gm.dtype != x.dtype:
        raise TypeError(f"{name}: x {x.dtype} and gm {gm.dtype} must be one "
                        "of f32/bf16")
    if gm.dim() != 2 or gm.shape[0] != n:
        raise ValueError(f"{name}: gm {tuple(gm.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if nbr_idx.shape != (27, n) or nbr_idx.dtype != torch.int32:
        raise ValueError(f"{name}: nbr_idx {tuple(nbr_idx.shape)} "
                         f"{nbr_idx.dtype}, want (27, {n}) int32")
    for t in (x, gm, nbr_idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on x's "
                             "device")


def conv3_dw(x, gm, nbr_idx):
    """x: (N, Cin) f32/bf16; gm: (N, Cout) in x.dtype, masked to valid rows;
    nbr_idx: (27, N) int32. Returns dW (27, Cin, Cout) f32."""
    if x.device.type == "cpu":
        return conv3_dw_plain(x, gm, nbr_idx)
    if x.device.type != "cuda":
        raise ValueError(f"conv3_dw: unsupported device {x.device}")
    _check_bwd("conv3_dw", x, gm, nbr_idx)
    n, cin = x.shape
    cout = gm.shape[1]
    dw = torch.empty(27, cin, cout, dtype=torch.float32, device=x.device)
    if n == 0:
        return dw.zero_()
    splits, rows = dw_splits(n, cin, cout)
    part = (torch.empty(splits, 27, cin, cout, dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    code = _build.load().conv3_dw(
        _build.ptr(x), _build.ptr(gm), _build.ptr(nbr_idx), _build.ptr(part),
        _build.ptr(dw), n, cin, cout, splits, rows,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "conv3_dw")
    conv3_dw.launches += 1
    return dw


def conv3_bwd(x, gm, w, nbr_idx, valid):
    """x: (N, Cin); gm: (N, Cout) in x.dtype, masked to valid rows; w: (27,
    Cin, Cout) in x.dtype; nbr_idx: (27, N) int32; valid: (N,) bool.
    Returns (dx (N, Cin) in x.dtype, dW (27, Cin, Cout) in w.dtype)."""
    if x.device.type == "cpu":
        return conv3_bwd_plain(x, gm, w, nbr_idx, valid)
    if x.device.type != "cuda":
        raise ValueError(f"conv3_bwd: unsupported device {x.device}")
    _check_bwd("conv3_bwd", x, gm, nbr_idx)
    _check(x, w, nbr_idx, valid, None, None, None)
    n, cin = x.shape
    cout = w.shape[-1]
    if gm.shape[1] != cout:
        raise ValueError(f"conv3_bwd: gm has {gm.shape[1]} channels, w "
                         f"{cout}")
    dx = torch.empty(n, cin, dtype=x.dtype, device=x.device)
    if n > 0:
        wf = flip_transpose(w)
        code = _build.load().conv3_bwd_dx(
            _build.ptr(gm), _build.ptr(wf),
            _build.ptr(nbr_idx), _build.ptr(valid), _build.ptr(dx), n, cin,
            cout, int(x.dtype == torch.bfloat16), _build.stream_of(x))
        _build.check(code, "conv3_bwd")
        conv3_bwd.launches += 1
    return dx, conv3_dw(x, gm, nbr_idx).to(w.dtype)


conv3_dw.launches = 0
conv3_bwd.launches = 0
