"""Kernel 8: the prototype of the dense brick shift-GEMM conv.

Replaces benchmarks/proto_brick_pallas.py:conv_kernel (Pallas). For each
brick b of G (nb, 1008, C) (10^3 halo'd cells, flat cell id x*100 + y*10 + z,
padded to 1008 rows):

    out[b, 111:895] = sum_{k<27} G[b, 111 + d_k : 895 + d_k] @ w[k],
    d_k = 100 dx + 10 dy + dz,

f32 accumulation, output in G's type, rows [0, 111) and [895, 1008) zero. No
epilogue and no occupancy mask, which sets it apart from kernel 7
(ops/brick_engine.py:brick_conv3): empty interior cells hold the nonzero
sums of their occupied neighbours. nb is any count.

Bound on the H100: the dense slabs' bytes against the products of every
cell, occupied or not. The CUDA kernel (csrc/proto_brick.cu) has its own
entry points over the slab tiles it shares with kernel 7
(csrc/brick_tile.cuh).

`proto_brick_conv` runs the plain twin `proto_brick_conv_plain` for CPU
tensors only. For a CUDA tensor it launches the kernel or raises;
`proto_brick_conv.launches` counts the launches.
"""

from __future__ import annotations

import torch

from unscene3d_torch.ops import _build
from unscene3d_torch.ops.brick_engine import CELLS, K3_DELTAS, WIN_LO, WIN_N

_SUPPORTED = (torch.float32, torch.bfloat16)


def proto_brick_conv_plain(g, w):
    """Plain PyTorch twin of the kernel: 27 shifted slices, each followed by
    an f32 matmul; zero halo rows."""
    gf, wf = g.float(), w.float()
    acc = torch.zeros(g.shape[0], WIN_N, w.shape[-1], dtype=torch.float32,
                      device=g.device)
    for k, d in enumerate(K3_DELTAS):
        acc = acc + gf[:, WIN_LO + d: WIN_LO + d + WIN_N, :] @ wf[k]
    out = torch.zeros(g.shape[0], CELLS, w.shape[-1], dtype=g.dtype,
                      device=g.device)
    out[:, WIN_LO: WIN_LO + WIN_N, :] = acc.to(g.dtype)
    return out


def proto_brick_conv(g, w):
    """g: (nb, 1008, Cin) f32/bf16; w: (27, Cin, Cout) in g.dtype. Returns
    (nb, 1008, Cout) in g.dtype."""
    if g.device.type == "cpu":
        return proto_brick_conv_plain(g, w)
    if g.device.type != "cuda":
        raise ValueError(f"proto_brick_conv: unsupported device {g.device}")
    if g.dtype not in _SUPPORTED:
        raise TypeError(f"proto_brick_conv: unsupported dtype {g.dtype}")
    if g.dim() != 3 or g.shape[1] != CELLS:
        raise ValueError(f"proto_brick_conv: g {tuple(g.shape)}, want (nb, "
                         f"{CELLS}, Cin)")
    nb, _, cin = g.shape
    if w.shape[:2] != (27, cin) or w.dtype != g.dtype:
        raise ValueError(f"proto_brick_conv: w {tuple(w.shape)} {w.dtype} "
                         f"does not match g {tuple(g.shape)} {g.dtype}")
    for t in (g, w):
        if t.device != g.device or not t.is_contiguous():
            raise ValueError("proto_brick_conv: tensors must be contiguous "
                             "on g's device")
    cout = w.shape[-1]
    out = torch.empty(nb, CELLS, cout, dtype=g.dtype, device=g.device)
    if nb == 0:
        return out
    code = _build.load().proto_brick_conv(
        _build.ptr(g), _build.ptr(w), _build.ptr(out), nb, cin, cout,
        int(g.dtype == torch.bfloat16), _build.stream_of(g))
    _build.check(code, "proto_brick_conv")
    proto_brick_conv.launches += 1
    return out


proto_brick_conv.launches = 0
