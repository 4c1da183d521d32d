"""Kernel 6: the k3 submanifold conv over compacted valid pairs.

Replaces unscene3d_tpu/ops/csr_conv.py:csr_conv3_fwd (Pallas `_kernel`) and
its custom VJP `csr_conv3`. The same function as kernel 1 (ops/conv3.py),
from pair tables instead of the level's (27, N) neighbour map:

    out[i] = valid[i] * epi(x[i] @ w[13]
                            + sum_{k != 13, (j, i) in pairs_k} x[j] @ w[k])

f32 accumulation; epi = *scale + shift (bias folded into shift), + residual,
ReLU, then the validity mask. `pairs_k` holds only the neighbours that exist
(about 7.6 per valid row at level 0 of a 2 cm scene, of 26), sorted by
(offset, out row), so the pairs of one (offset, row tile) are one contiguous
range. The ranges are ragged and exact: the per-offset buckets, dummy tails
and read windows of the TPU tables were for static shapes under Mosaic and
have no counterpart. Padding rows of x need not be zero: no pair reads one.

Bound on the H100: the gather of the paired x rows, as kernel 1. The bf16
CUDA kernel (csrc/csr_conv.cu) is kernel 1's ring main loop behind a
prologue that reads the pair tables into the block's row table, so on valid
rows it is bitwise kernel 1; the f32 kernel packs a tile's paired rows,
multiplies them by w[k] and adds each product row into its out row.

`csr_conv3_fwd` runs the plain twin for CPU tensors only; for a CUDA tensor
it launches the kernel or raises, and `csr_conv3_fwd.launches` counts the
launches. The backward (ops/conv_ops.py:_CsrConv3) is the same kernel over
the masked output gradient with flip-transposed weights for dx, and kernel
5 (ops/conv3.py:conv3_dw) over the level's neighbour map for dW: the pairs
are that map's hits, so it is the same function. `csr_dw` is the plain copy
of the JAX package's dW over the pairs (plain XLA there): the tests and
`chip_smoke.py` hold kernel 5 against it; no path on the card calls it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unscene3d_torch.ops import _build
from unscene3d_torch.ops.conv3 import epilogue

# out rows per entry of `tile_start`; the kernel's row tile is a multiple
TILE = 64
# the 26 off-centre k3 offsets in table order
OFFSETS = tuple(k for k in range(27) if k != 13)
_SUPPORTED = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class CsrGraph:
    """Valid off-centre pairs of one level's k3 topology, sorted by (offset,
    out row). Offset OFFSETS[ki] owns pairs [bounds[ki], bounds[ki + 1]);
    within it, out rows [t * TILE, (t + 1) * TILE) own pairs
    [tile_start[ki * T + t], tile_start[ki * T + t + 1]) with T =
    ceil(N / TILE) (the array is flat: a tile's end is the next one's
    start)."""

    pair_in: torch.Tensor      # (P,) int32 row of x read by the pair
    pair_out: torch.Tensor     # (P,) int32 out row the pair adds to
    tile_start: torch.Tensor   # (26 * T + 1,) int32
    counts: tuple = ()         # 26 ints: pairs per offset (host side)

    @property
    def num_pairs(self) -> int:
        return self.pair_in.shape[0]

    @property
    def bounds(self) -> tuple:
        out = [0]
        for c in self.counts:
            out.append(out[-1] + c)
        return tuple(out)

    def to(self, device, non_blocking: bool = False) -> "CsrGraph":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device, non_blocking=non_blocking)
            for name in ("pair_in", "pair_out", "tile_start")})


def build_csr_graph(nbr_idx: np.ndarray) -> CsrGraph:
    """Pair tables from a (27, N) k3 neighbour map whose misses point at row
    N-1 (unscene3d_tpu/ops/csr_conv.py:build_csr_graph without its buckets).
    The centre offset is left out: the kernel reads the tile's own rows."""
    nbr_idx = np.asarray(nbr_idx)
    n = nbr_idx.shape[1]
    tiles = -(-n // TILE)
    ins, outs, counts, starts = [], [], [], []
    total = 0
    for k in OFFSETS:
        out = np.nonzero(nbr_idx[k] != n - 1)[0]
        ins.append(nbr_idx[k][out])
        outs.append(out)
        counts.append(len(out))
        starts.append(total + np.searchsorted(out, np.arange(tiles) * TILE))
        total += len(out)
    starts.append([total])
    t = torch.from_numpy
    return CsrGraph(
        pair_in=t(np.concatenate(ins).astype(np.int32)),
        pair_out=t(np.concatenate(outs).astype(np.int32)),
        tile_start=t(np.concatenate(starts).astype(np.int32)),
        counts=tuple(counts))


def csr_conv3_fwd_plain(x, w, csr: CsrGraph, valid, scale=None, shift=None,
                        residual=None, relu=False):
    """Plain PyTorch twin of the kernel, offsets in order as the kernel
    takes them: per off-centre offset one gather of the paired rows, one f32
    matmul and one indexed add onto the pairs' out rows (unique within an
    offset, so plain indexing); the centre is the matmul of x itself."""
    xf = x.float()
    wf = w.float()
    acc = torch.zeros(x.shape[0], w.shape[-1], dtype=torch.float32,
                      device=x.device)
    pin, pout = csr.pair_in.long(), csr.pair_out.long()
    bounds = csr.bounds
    for k in range(27):
        if k == 13:
            acc = acc + xf @ wf[13]
            continue
        ki = k - (k > 13)
        lo, hi = bounds[ki], bounds[ki + 1]
        if hi > lo:
            rows = pout[lo:hi]
            acc[rows] = acc[rows] + xf[pin[lo:hi]] @ wf[k]
    return epilogue(acc, valid, scale, shift, residual, relu).to(x.dtype)


def _check(x, w, csr, valid, scale, shift, residual):
    n, cin = x.shape
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"csr_conv3_fwd: unsupported dtype {x.dtype}")
    if w.shape[0] != 27 or w.shape[1] != cin or w.dtype != x.dtype:
        raise ValueError(f"csr_conv3_fwd: w {tuple(w.shape)} {w.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    tiles = -(-n // TILE)
    if (csr.tile_start.shape != (26 * tiles + 1,)
            or csr.pair_in.shape != csr.pair_out.shape
            or any(t.dtype != torch.int32 for t in
                   (csr.pair_in, csr.pair_out, csr.tile_start))):
        raise ValueError(f"csr_conv3_fwd: pair tables do not belong to a "
                         f"level of {n} rows")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError("csr_conv3_fwd: valid must be (N,) bool")
    if (scale is None) != (shift is None):
        raise ValueError("csr_conv3_fwd: scale and shift go together")
    cout = w.shape[-1]
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (t.shape != (cout,) or t.dtype != torch.float32):
            raise ValueError(f"csr_conv3_fwd: {name} must be ({cout},) "
                             "float32")
    if residual is not None and (residual.shape != (n, cout)
                                 or residual.dtype != x.dtype):
        raise ValueError("csr_conv3_fwd: residual must be (N, Cout) in "
                         "x.dtype")
    for t in (x, w, csr.pair_in, csr.pair_out, csr.tile_start, valid, scale,
              shift, residual):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("csr_conv3_fwd: tensors must be contiguous on "
                             "x's device")


def csr_conv3_fwd(x, w, csr: CsrGraph, valid, scale=None, shift=None,
                  residual=None, relu=False):
    """x: (N, Cin) f32/bf16; w: (27, Cin, Cout) in x.dtype; csr: the level's
    pair tables; valid: (N,) bool; scale/shift: (Cout,) f32; residual: (N,
    Cout) in x.dtype. Returns (N, Cout) in x.dtype."""
    if x.device.type == "cpu":
        return csr_conv3_fwd_plain(x, w, csr, valid, scale, shift, residual,
                                   relu)
    if x.device.type != "cuda":
        raise ValueError(f"csr_conv3_fwd: unsupported device {x.device}")
    _check(x, w, csr, valid, scale, shift, residual)
    n, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty(n, cout, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    code = _build.load().csr_conv3_fwd(
        _build.ptr(x), _build.ptr(w), _build.ptr(csr.pair_in),
        _build.ptr(csr.pair_out), _build.ptr(csr.tile_start),
        _build.ptr(valid), _build.ptr(scale), _build.ptr(shift),
        _build.ptr(residual), _build.ptr(out), n, cin, cout, int(bool(relu)),
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "csr_conv3_fwd")
    csr_conv3_fwd.launches += 1
    return out


csr_conv3_fwd.launches = 0


def csr_dw(x, gm, csr: CsrGraph):
    """Plain copy of the JAX package's dW of the CSR conv
    (unscene3d_tpu/ops/csr_conv.py:321-335): per offset x[pair_in]^T @
    gm[pair_out] over the offset's exact pair range, x^T @ gm for the
    centre, in f32, stacked in offset order. x: (N, Cin), gm: (N, Cout)
    masked to valid rows. Returns (27, Cin, Cout) f32. The reference that
    kernel 5, the CSR levels' dW on every path, is held against."""
    xf = x.float()
    gf = gm.float()
    pin, pout = csr.pair_in.long(), csr.pair_out.long()
    bounds = csr.bounds
    dws = []
    for ki in range(26):
        lo, hi = bounds[ki], bounds[ki + 1]
        dws.append(xf[pin[lo:hi]].T @ gf[pout[lo:hi]])
    dws.insert(13, xf.T @ gf)
    return torch.stack(dws)
