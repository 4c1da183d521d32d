"""Kernel 9: the k3 conv read through the TPU kernel's window tables, in five
variants that take the conv's time apart.

Replaces benchmarks/proto_win_decompose.py:make_kernel (Pallas `_kernel`).
With x (n_pad, Cin) bf16, w (27, Cin, Cout) bf16 and the tables of
ops/win_graph.py (tile T = 256, G tiles per supertile, sub-window width W):
for row i of tile t = i // T in supertile s = t // G, base(k) = r0[s] +
starts[t, k // 9], ki the column of off-centre offset k in lidx, f32
accumulation, bf16 output:

    full       x[i] @ w[13] + sum_k [0 <= lidx[i, ki] < W]
                                    x[base(k) + lidx[i, ki]] @ w[k]
    no_onehot  the same with lidx[i, 0] in place of lidx[i, ki]
    no_select  x[i] @ w[13] + sum_k x[base(k) + (i - t T)] @ w[k]
    no_gemm    x[i] @ w[13] + sum_k sel_k[:Cout], sel_k the row `full` reads
    dma_only   x[i] @ w[13]

Spilled pairs (lidx = -1) contribute nothing, so `full` is kernel 1 minus the
level's spilled pairs: on every valid row without a spilled pair the CUDA
kernel's `full` is bitwise kernel 1 (`ops/conv3.py:conv3_fwd`, no epilogue).
The other four are wrong by construction and exist to be timed against it.
Rows are read wherever the tables point, padding rows included: x's padding
rows are not assumed to be zero.

The CUDA kernel (csrc/win_decompose.cu) replaces the TPU kernel with kernel
1's ring main loop (`csrc/gather_gemm.cuh:ring_main_loop`, bf16 tile) behind
a prologue of its own that fills each block's row table from the window
tables; the bound is unchanged, the scattered row read. So the variants take
kernel 1's own body apart: no_select removes its scattered read (contiguous
rows), no_onehot its per-offset lookup (one table column), no_gemm its
off-centre products (the rows are summed instead), dma_only everything but
the centre product. See the kernel's header.

`win_conv_variant` runs the plain twin `win_conv_variant_plain` for CPU
tensors only. For a CUDA tensor it launches the kernel or raises;
`win_conv_variant.launches` counts the launches.
"""

from __future__ import annotations

import dataclasses

import torch

from unscene3d_torch.ops import _build
from unscene3d_torch.ops.win_graph import TILE, WinGraph

VARIANTS = ("full", "no_onehot", "no_select", "no_gemm", "dma_only")
OFF_CENTRE = tuple(k for k in range(27) if k != 13)


@dataclasses.dataclass
class WinTables:
    """What kernel 9 reads of a WinGraph, as tensors."""

    r0: torch.Tensor       # (n_super,) int32
    starts: torch.Tensor   # (n_tiles, 3) int32
    lidx: torch.Tensor     # (n_pad, 26) int16
    ones: torch.Tensor     # (n_pad,) uint8 all 1: the kernel's row mask
    group: int
    w_sub: int

    @classmethod
    def from_graph(cls, wg: WinGraph) -> "WinTables":
        if wg.tile != TILE or len(set(wg.w_subs)) != 1:
            raise ValueError("kernel 9 takes tile 256 and one uniform w_sub")
        t = torch.from_numpy
        return cls(r0=t(wg.r0), starts=t(wg.starts), lidx=t(wg.lidx),
                   ones=torch.ones(wg.lidx.shape[0], dtype=torch.uint8),
                   group=wg.group, w_sub=wg.w_sub)

    def to(self, device) -> "WinTables":
        return dataclasses.replace(
            self, r0=self.r0.to(device), starts=self.starts.to(device),
            lidx=self.lidx.to(device), ones=self.ones.to(device))


def _selected_rows(tables: WinTables, n_pad: int, k: int, variant: str):
    """(row index (n_pad,) int64, hit (n_pad,) bool) of off-centre offset k:
    the row each output row reads under `variant`."""
    i = torch.arange(n_pad, device=tables.r0.device)
    tile = i // TILE
    base = (tables.r0.long()[tile // tables.group]
            + tables.starts.long()[tile, k // 9])
    if variant == "no_select":
        return base + (i - tile * TILE), torch.ones_like(i, dtype=torch.bool)
    ki = 0 if variant == "no_onehot" else OFF_CENTRE.index(k)
    li = tables.lidx[:, ki].long()
    hit = (li >= 0) & (li < tables.w_sub)
    return torch.where(hit, base + li, torch.zeros_like(li)), hit


def win_conv_variant_plain(x, w, tables: WinTables, variant: str):
    """Plain PyTorch twin of the kernel: the five definitions with indexed
    reads and one f32 matmul per offset, offsets in natural order (no_gemm:
    the selected rows summed in natural order, then added to the centre
    product)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    n_pad, cout = x.shape[0], w.shape[-1]
    xf, wf = x.float(), w.float()
    acc = torch.zeros(n_pad, cout, dtype=torch.float32, device=x.device)
    rows_sum = torch.zeros_like(acc)
    for k in range(27):
        if k == 13:
            acc = acc + xf @ wf[13]
            continue
        if variant == "dma_only":
            continue
        idx, hit = _selected_rows(tables, n_pad, k, variant)
        sel = xf[idx] * hit[:, None].to(torch.float32)
        if variant == "no_gemm":
            rows_sum = rows_sum + sel[:, :cout]
        else:
            acc = acc + sel @ wf[k]
    return (acc + rows_sum).to(x.dtype)


def _check(x, w, tables: WinTables, variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    n_pad, cin = x.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("win_conv_variant: x and w must be bfloat16")
    if w.shape[:2] != (27, cin):
        raise ValueError(f"win_conv_variant: w {tuple(w.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if variant == "no_gemm" and cin < w.shape[-1]:
        raise ValueError("win_conv_variant: no_gemm adds the first Cout "
                         "channels of a row and needs Cin >= Cout")
    g, n_tiles = tables.group, n_pad // TILE
    if n_pad % (TILE * g) or tables.w_sub < TILE:
        raise ValueError(f"win_conv_variant: {n_pad} rows are no multiple "
                         f"of {TILE} x group {g}, or w_sub < {TILE}")
    for name, t, shape, dtype in (
            ("r0", tables.r0, (n_tiles // g,), torch.int32),
            ("starts", tables.starts, (n_tiles, 3), torch.int32),
            ("lidx", tables.lidx, (n_pad, 26), torch.int16),
            ("ones", tables.ones, (n_pad,), torch.uint8)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"win_conv_variant: {name} {tuple(t.shape)} "
                             f"{t.dtype}, want {shape} {dtype}")
    for t in (x, w, tables.r0, tables.starts, tables.lidx, tables.ones):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("win_conv_variant: tensors must be contiguous "
                             "on x's device")


def win_conv_variant(x, w, tables: WinTables, variant: str = "full"):
    """x: (n_pad, Cin) bf16; w: (27, Cin, Cout) bf16; tables: WinTables of
    the level on x's device. Returns (n_pad, Cout) bf16."""
    if x.device.type == "cpu":
        return win_conv_variant_plain(x, w, tables, variant)
    if x.device.type != "cuda":
        raise ValueError(f"win_conv_variant: unsupported device {x.device}")
    _check(x, w, tables, variant)
    n_pad, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty(n_pad, cout, dtype=x.dtype, device=x.device)
    code = _build.load().win_decompose(
        _build.ptr(x), _build.ptr(w), _build.ptr(tables.r0),
        _build.ptr(tables.starts), _build.ptr(tables.lidx),
        _build.ptr(tables.ones), _build.ptr(out),
        n_pad, tables.group, tables.w_sub, cin, cout,
        VARIANTS.index(variant), _build.stream_of(x))
    _build.check(code, "win_decompose")
    win_conv_variant.launches += 1
    return out


win_conv_variant.launches = 0


def spill_products(x, w, wg: WinGraph):
    """(n_pad, Cout) f32: sum over the level's spilled pairs of x[in] @ w[k]
    at row out, in plain torch: what `full` lacks of kernel 1."""
    real = torch.from_numpy(wg.spill_rows >= 0)
    rows_out = torch.from_numpy(wg.spill_out)[real].long().to(x.device)
    rows_in = torch.from_numpy(wg.spill_in)[real].long().to(x.device)
    ks = torch.from_numpy(wg.spill_k)[real].long().to(x.device)
    out = torch.zeros(x.shape[0], w.shape[-1], dtype=torch.float32,
                      device=x.device)
    wf = w.float()
    for k in torch.unique(ks).tolist():
        m = ks == k
        # a row has at most one neighbour per offset: the rows are unique
        out[rows_out[m]] += x[rows_in[m]].float() @ wf[k]
    return out
