"""Kernel 2: K-offset cross-level gather, weighted (gather-GEMM) or summed.

Replaces unscene3d_tpu/ops/window_gather.py:window_k_apply (Pallas
`_kernel_k`).

    out[i] = out_valid[i] * sum_{k<K} x[table[k, i]] (@ w[k])

f32 accumulation, entries equal to n_in-1 (the input level's always-padding
row) skipped. Uses on the eval path: the k2s2 down conv over child tables,
the k2 transposed up conv over one-hot parent tables (`LevelGraph.up_idx`,
built by the host collate) and, with w=None, the 8-child sum behind
avg_pool2.

Bound on the H100: the gather of up to K input rows per output row. The
weighted case shares kernel 1's gather-GEMM body (csrc/gather_gemm.cuh) under
its own entry point; the sum (at most 8 offsets: the pools' children) is a
gather-reduce with a group of lanes per output row, 16 bytes a lane, and a
fixed offset order, so its output is the twin's bit for bit
(csrc/k_apply.cu, csrc/row_gather.cuh).

`k_apply` runs the plain twin `k_apply_plain` for CPU tensors only. For a
CUDA tensor it launches one of the two kernels or raises. Each kernel has its
own launch counter: `k_apply_gemm.launches` and `k_apply_sum.launches`.
"""

from __future__ import annotations

import torch

from unscene3d_torch.ops import _build

_SUPPORTED = (torch.float32, torch.bfloat16)


def k_apply_plain(x, table, w, out_valid):
    """Plain PyTorch twin: K masked row gathers, summed in offset order in
    f32 (each followed by an f32 matmul when w is given)."""
    n_in = x.shape[0]
    xf = x.float()
    acc = None
    for k in range(table.shape[0]):
        idx = table[k].long()
        g = xf[idx] * (idx != n_in - 1)[:, None].to(torch.float32)
        if w is not None:
            g = g @ w[k].float()
        acc = g if acc is None else acc + g
    return (acc * out_valid[:, None].to(torch.float32)).to(x.dtype)


def _check(x, table, w, out_valid):
    n_in, cin = x.shape
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"k_apply: unsupported dtype {x.dtype}")
    if table.dim() != 2 or table.dtype != torch.int32:
        raise ValueError("k_apply: table must be (K, N_out) int32")
    n_out = table.shape[1]
    if out_valid.shape != (n_out,) or out_valid.dtype != torch.bool:
        raise ValueError("k_apply: out_valid must be (N_out,) bool")
    if w is None and table.shape[0] > 8:
        raise ValueError("k_apply: the unweighted sum takes at most 8 "
                         "offsets")
    if w is not None and (w.shape[:2] != (table.shape[0], cin)
                          or w.dtype != x.dtype):
        raise ValueError(f"k_apply: w {tuple(w.shape)} {w.dtype} does not "
                         f"match table {tuple(table.shape)} / x {x.dtype}")
    for t in (x, table, w, out_valid):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("k_apply: tensors must be contiguous on x's "
                             "device")
    if n_in == 0:
        raise ValueError("k_apply: empty input level")


def k_apply_gemm(x, table, w, out_valid):
    """Launch the weighted kernel (CUDA tensors, already checked)."""
    K, n_out = table.shape
    cin, cout = x.shape[1], w.shape[-1]
    out = torch.empty(n_out, cout, dtype=x.dtype, device=x.device)
    if n_out == 0:
        return out
    code = _build.load().k_apply_gemm(
        _build.ptr(x), _build.ptr(w), _build.ptr(table), _build.ptr(out_valid),
        _build.ptr(out), K, n_out, x.shape[0], cin, cout,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "k_apply_gemm")
    k_apply_gemm.launches += 1
    return out


def k_apply_sum(x, table, out_valid):
    """Launch the unweighted gather-sum kernel (CUDA tensors, already
    checked)."""
    K, n_out = table.shape
    c = x.shape[1]
    out = torch.empty(n_out, c, dtype=x.dtype, device=x.device)
    if n_out == 0 or c == 0:
        return out
    code = _build.load().k_apply_sum(
        _build.ptr(x), _build.ptr(table), _build.ptr(out_valid),
        _build.ptr(out), K, n_out, x.shape[0], c,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "k_apply_sum")
    k_apply_sum.launches += 1
    return out


k_apply_gemm.launches = 0
k_apply_sum.launches = 0


def k_apply(x, table, w, out_valid):
    """x: (n_in, Cin) f32/bf16; table: (K, N_out) int32 rows of x; w: (K, Cin,
    Cout) in x.dtype or None (sum); out_valid: (N_out,) bool. Returns
    (N_out, Cout or Cin) in x.dtype."""
    if x.device.type == "cpu":
        return k_apply_plain(x, table, w, out_valid)
    if x.device.type != "cuda":
        raise ValueError(f"k_apply: unsupported device {x.device}")
    _check(x, table, w, out_valid)
    if w is None:
        return k_apply_sum(x, table, out_valid)
    return k_apply_gemm(x, table, w, out_valid)
