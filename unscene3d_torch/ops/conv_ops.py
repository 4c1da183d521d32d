"""Sparse conv primitives over LevelGraph tables (counterpart of
unscene3d_tpu/ops/conv_ops.py).

Features are flat (N_pad, C) arrays. k3 convs go through kernel 1
(ops/conv3.py), or through kernel 6 (ops/csr_conv.py) at a level that
carries pair tables (`level.csr`, the collator's `csr_levels`); the k2
down/up convs and the average pool through kernel 2 (ops/k_apply.py); the
k1 conv is a plain matmul, as the JAX package leaves it to XLA.

Gradients mirror the JAX package's custom VJPs, as torch.autograd.Functions
that are used only when an input requires grad (training):
  * k3: dx = the conv of gm with flip-transposed weights and dW = 27 gathered
    GEMMs, kernels 4 and 5 (ops/conv3.py:conv3_bwd / conv3_dw);
  * k3 at a CSR level: dx = kernel 6 over gm with flip-transposed weights
    and the same pair tables; dW = kernel 5 over the level's neighbour map,
    the same function as the JAX package's per-offset products over the
    pairs (plain XLA there), since the pairs are built from that map;
  * down2: dx = an up2 conv with W^T (kernel 2 over the fine level's
    `up_idx`), dW = one parent gather + 8 masked GEMMs in plain torch;
  * up2: dx = a down2 conv with W^T (kernel 2 over the coarse level's
    `child_idx`), dW likewise;
  * avg_pool2: dx = the parent gather of g / child count.
The fused eval epilogue (folded BN, residual, ReLU) is forward only, as
the JAX package's: the train branch runs BatchNorm outside the conv.
"""

from __future__ import annotations

import torch

from unscene3d_torch.ops.conv3 import (conv3_bwd, conv3_dw, conv3_fwd,
                                       flip_transpose, fold_bias)
from unscene3d_torch.ops.csr_conv import csr_conv3_fwd
from unscene3d_torch.ops.k_apply import k_apply
from unscene3d_torch.ops.sparse_graph import LevelGraph


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _masked(g, valid, dtype):
    """g * valid, cast to `dtype` (the JAX bwds' `gm`)."""
    return (g * valid[:, None].to(g.dtype)).to(dtype).contiguous()


class _Conv3(torch.autograd.Function):
    """k3 conv without epilogue: forward kernel 1, backward kernels 4/5
    (conv_ops.py:_conv3_bwd; window_conv.py:_win_bwd)."""

    @staticmethod
    def forward(ctx, x, w, level):
        ctx.save_for_backward(x, w)
        ctx.level = level
        return conv3_fwd(x, w, level.nbr_idx, level.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        lv = ctx.level
        gm = _masked(g, lv.valid, x.dtype)
        if ctx.needs_input_grad[0]:
            dx, dw = conv3_bwd(x, gm, w, lv.nbr_idx, lv.valid)
        else:   # the stem: its input features need no gradient
            dx, dw = None, conv3_dw(x, gm, lv.nbr_idx).to(w.dtype)
        return dx, dw, None


class _CsrConv3(torch.autograd.Function):
    """k3 conv without epilogue at a level with pair tables
    (csr_conv.py:csr_conv3 and _csr_bwd): forward and dx kernel 6, dW kernel
    5 over `level.nbr_idx`. Requires `level.csr ==
    build_csr_graph(level.nbr_idx)`, as the collator builds it: then kernel
    5's dW is the reference's dW over the pairs (`csr_dw`)."""

    @staticmethod
    def forward(ctx, x, w, level):
        ctx.save_for_backward(x, w)
        ctx.level = level
        return csr_conv3_fwd(x, w, level.csr, level.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        lv = ctx.level
        gm = _masked(g, lv.valid, x.dtype)
        dx = None
        if ctx.needs_input_grad[0]:   # not the stem's input features
            dx = csr_conv3_fwd(gm, flip_transpose(w), lv.csr, lv.valid)
        return dx, conv3_dw(x, gm, lv.nbr_idx).to(w.dtype), None


def sparse_conv3(x, w, level: LevelGraph, bias=None, scale=None, shift=None,
                 residual=None, relu=False):
    """kernel_size=3, stride=1 conv with the optional fused eval epilogue.
    x: (N, Cin), w: (27, Cin, Cout) in x.dtype. Returns (N, Cout) in
    x.dtype. `level.csr` alone decides between kernel 1 and kernel 6. The
    epilogue is forward only: with it, no input may need a gradient (run an
    eval model under torch.no_grad())."""
    fused = (scale is not None or shift is not None or residual is not None
             or relu)
    if _needs_grad(x, w, bias, scale, shift, residual):
        if fused:
            raise NotImplementedError(
                "sparse_conv3: the fused epilogue has no backward; call it "
                "under torch.no_grad() or without scale/shift/residual/relu")
        fn = _Conv3 if level.csr is None else _CsrConv3
        return _masked_bias(fn.apply(x, w, level), bias, level.valid)
    # one launch of kernel 1 or 6 with the fused epilogue, forward only
    scale, shift = fold_bias(bias, scale, shift, w.shape[-1], x.device)
    if level.csr is not None:
        return csr_conv3_fwd(x, w, level.csr, level.valid, scale=scale,
                             shift=shift, residual=residual, relu=relu)
    return conv3_fwd(x, w, level.nbr_idx, level.valid,
                     scale=scale, shift=shift, residual=residual, relu=relu)


def sparse_conv1(x, w, level: LevelGraph, bias=None):
    """kernel_size=1 conv: a plain per-voxel matmul in f32 (the JAX op's
    f32 accumulation), masked to valid rows, returned in x.dtype."""
    out = torch.matmul(x.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return (out * level.valid[:, None].to(torch.float32)).to(x.dtype)


def _masked_bias(out, bias, valid):
    if bias is None:
        return out
    return ((out.float() + bias.float())
            * valid[:, None].to(torch.float32)).to(out.dtype)


def _k2_weight_grad(x_rows, gm, fine: LevelGraph):
    """dW[k] = sum over valid fine rows i with parent offset k of
    x_rows[i]^T gm_rows[i], in f32 (8 masked GEMMs, conv_ops.py:262-272 and
    :330-340). x_rows and gm are both indexed by fine rows."""
    xf = x_rows.float()
    gf = gm.float()
    dws = []
    for k in range(8):
        sel = ((fine.parent_offset == k) & fine.valid)[:, None]
        dws.append((xf * sel.to(torch.float32)).T @ gf)
    return torch.stack(dws)


class _Down2(torch.autograd.Function):
    """k2s2 conv, fine -> coarse (conv_ops.py:_conv_down2)."""

    @staticmethod
    def forward(ctx, x, w, coarse, fine):
        ctx.save_for_backward(x, w)
        ctx.levels = (coarse, fine)
        return k_apply(x, coarse.child_idx, w, coarse.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        coarse, fine = ctx.levels
        gm = _masked(g, coarse.valid, x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[i] = gm[parent(i)] @ W[off(i)]^T: an up2 conv with W^T
            dx = k_apply(gm, fine.up_idx, w.transpose(1, 2).contiguous(),
                         fine.valid)
        if ctx.needs_input_grad[1]:
            g_par = gm[fine.parent_idx.long()] * fine.valid[:, None].to(
                gm.dtype)
            dw = _k2_weight_grad(x, g_par, fine).to(w.dtype)
        return dx, dw, None, None


class _Up2(torch.autograd.Function):
    """k2 transposed conv, coarse -> fine (conv_ops.py:_conv_up2)."""

    @staticmethod
    def forward(ctx, x, w, fine, coarse):
        ctx.save_for_backward(x, w)
        ctx.levels = (fine, coarse)
        return k_apply(x, fine.up_idx, w, fine.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        fine, coarse = ctx.levels
        gm = _masked(g, fine.valid, x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[j] = sum_k gm[child_k(j)] @ W[k]^T: a down2 conv with W^T
            dx = k_apply(gm, coarse.child_idx, w.transpose(1, 2).contiguous(),
                         coarse.valid)
        if ctx.needs_input_grad[1]:
            x_par = x[fine.parent_idx.long()] * fine.valid[:, None].to(
                x.dtype)
            dw = _k2_weight_grad(x_par, gm, fine).to(w.dtype)
        return dx, dw, None, None


def sparse_conv_down2(x, w, coarse: LevelGraph, bias=None,
                      fine: LevelGraph | None = None):
    """kernel_size=2, stride=2 conv: fine level -> coarse level over the
    coarse level's child table. x: (N_fine, Cin), w: (8, Cin, Cout) in
    x.dtype. The backward needs the fine LevelGraph."""
    if _needs_grad(x, w):
        if fine is None:
            raise ValueError("sparse_conv_down2: the backward needs `fine`")
        out = _Down2.apply(x, w, coarse, fine)
    else:
        out = k_apply(x, coarse.child_idx, w, coarse.valid)
    return _masked_bias(out, bias, coarse.valid)


def sparse_conv_up2(x, w, fine: LevelGraph, bias=None,
                    coarse: LevelGraph | None = None):
    """kernel_size=2 transposed conv: coarse -> fine level, each valid fine
    row reading its one parent under its offset's weight, through the fine
    level's one-hot parent tables `up_idx` (built by the collate).
    x: (N_coarse, Cin), w: (8, Cin, Cout) in x.dtype. The backward needs the
    coarse LevelGraph."""
    if _needs_grad(x, w):
        if coarse is None:
            raise ValueError("sparse_conv_up2: the backward needs `coarse`")
        out = _Up2.apply(x, w, fine, coarse)
    else:
        out = k_apply(x, fine.up_idx, w, fine.valid)
    return _masked_bias(out, bias, fine.valid)


def _avg_pool2_primal(x, coarse: LevelGraph):
    cnt = coarse.child_valid.sum(dim=0).to(x.dtype)
    s = k_apply(x, coarse.child_idx, None, coarse.valid)
    out = s / torch.clamp_min(cnt, 1.0)[:, None]
    return (out * coarse.valid[:, None].to(x.dtype)).to(x.dtype)


class _AvgPool2(torch.autograd.Function):
    """conv_ops.py:_avg_pool2: the backward is a parent gather."""

    @staticmethod
    def forward(ctx, x, coarse, fine):
        ctx.levels = (coarse, fine)
        ctx.dtype = x.dtype
        return _avg_pool2_primal(x, coarse)

    @staticmethod
    def backward(ctx, g):
        coarse, fine = ctx.levels
        cnt = coarse.child_valid.sum(dim=0).to(torch.float32)
        gm = (g.float() * coarse.valid[:, None].to(torch.float32)
              / torch.clamp_min(cnt, 1.0)[:, None])
        dx = gm[fine.parent_idx.long()] * fine.valid[:, None].to(
            torch.float32)
        return dx.to(ctx.dtype), None, None


def avg_pool2(x, coarse: LevelGraph, fine: LevelGraph | None = None):
    """MinkowskiAvgPooling(kernel_size=2, stride=2): the kernel-2 child sum,
    then division by the valid-child count in x.dtype (conv_ops.py:384-395).
    The backward needs the fine LevelGraph."""
    if _needs_grad(x):
        if fine is None:
            raise ValueError("avg_pool2: the backward needs `fine`")
        return _AvgPool2.apply(x, coarse, fine)
    return _avg_pool2_primal(x, coarse)
