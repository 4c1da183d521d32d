"""Sparse conv primitives over LevelGraph tables (counterpart of
unscene3d_tpu/ops/conv_ops.py).

Features are flat (N_pad, C) arrays. k3 convs go through kernel 1
(ops/conv3.py), through kernel 7 (ops/brick_engine.py) at a level that
carries brick tables (`level.brick`, the collator's `brick_levels`), or
through kernel 6 (ops/csr_conv.py) at a level that carries pair tables
(`level.csr`, the collator's `csr_levels`), in that order of precedence, as
the JAX op routes them; the k2 down/up convs, the average and sum pools and
the MinkUNet / ResNet stride-2 convs (k3 over `down_nbr_idx`, k1 over the
first child) through kernel 2 (ops/k_apply.py); the k1 conv is a plain
matmul, as the JAX package leaves it to XLA, and so are the max pool and
the nearest unpool (gathers and a max there too).

Gradients mirror the JAX package's custom VJPs, as torch.autograd.Functions
that are used only when an input requires grad (training):
  * k3: dx = the conv of gm with flip-transposed weights and dW = 27 gathered
    GEMMs, kernels 4 and 5 (ops/conv3.py:conv3_bwd / conv3_dw); kernel 1
    and 4's dx walk the level's row order (ops/conv3.py:level_order, kept
    on the level, so the forward, remat's recompute and the dx share it);
  * k3 at a brick level: the forward is assemble -> kernel 7 ->
    disassemble, the backward the gather route's (kernels 4 and 5 over the
    level's neighbour map, which the collator builds at every level): the
    VJP of one conv over one topology is one function, whichever kernel
    ran the forward. The JAX package differentiates its XLA brick conv;
    this backward is deterministic and saves the flat x, not the brick
    tensor (~1000 cells a brick);
  * k3 at a CSR level: dx = kernel 6 over gm with flip-transposed weights
    and the same pair tables; dW = kernel 5 over the level's neighbour map,
    the same function as the JAX package's per-offset products over the
    pairs (plain XLA there), since the pairs are built from that map;
  * down2: dx = an up2 conv with W^T (kernel 2 over the fine level's
    `up_idx`), dW = one parent gather + 8 masked GEMMs in plain torch;
  * up2: dx = a down2 conv with W^T (kernel 2 over the coarse level's
    `child_idx`), dW likewise;
  * avg_pool2: dx = the parent gather of g / child count;
  * k3 stride 2: dx = kernel 2 again with W^T over the coarse level's
    transposed map `down_nbr_t` (each fine row is at one offset of at most
    one coarse row, so the transpose is a gather table built on the host),
    dW = 27 gathered GEMMs in plain torch (the JAX package differentiates
    its XLA gathers);
  * k1 stride 2: dx = kernel 2 with W^T over the fine level's offset-0
    parent table `up_idx[0]`, dW one gathered GEMM;
  * sum_pool2: dx = the parent gather of g.
The fused eval epilogue (folded BN, residual, ReLU) is forward only, as
the JAX package's: the train branch runs BatchNorm outside the conv.
"""

from __future__ import annotations

import torch

from unscene3d_torch.ops.brick_engine import (assemble, brick_conv3,
                                              disassemble)
from unscene3d_torch.ops.conv3 import (conv3_bwd, conv3_dw, conv3_dw_plain,
                                       conv3_fwd, flip_transpose, fold_bias,
                                       level_order)
from unscene3d_torch.ops.csr_conv import csr_conv3_fwd
from unscene3d_torch.ops.k_apply import k_apply
from unscene3d_torch.ops.sparse_graph import LevelGraph


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _masked(g, valid, dtype):
    """g * valid, cast to `dtype` (the JAX bwds' `gm`)."""
    return (g * valid[:, None].to(g.dtype)).to(dtype).contiguous()


def _card_order(x, level):
    """The level's row order where kernel 1 and 4's dx run; the twins walk
    none."""
    return level_order(level) if x.is_cuda else None


class _Conv3(torch.autograd.Function):
    """k3 conv without epilogue: forward kernel 1, backward kernels 4/5
    (conv_ops.py:_conv3_bwd; window_conv.py:_win_bwd)."""

    @staticmethod
    def forward(ctx, x, w, level):
        ctx.save_for_backward(x, w)
        ctx.level = level
        return conv3_fwd(x, w, level.nbr_idx, level.valid,
                         order=_card_order(x, level))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        lv = ctx.level
        gm = _masked(g, lv.valid, x.dtype)
        if ctx.needs_input_grad[0]:
            dx, dw = conv3_bwd(x, gm, w, lv.nbr_idx, lv.valid,
                               order=_card_order(x, lv))
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


def brick_conv3_flat(x, w, level: LevelGraph, scale=None, shift=None,
                     residual=None, relu=False):
    """The k3 conv at a brick level (bricks.py:brick_conv3): assemble the
    flat (N, Cin) rows into the level's halo'd bricks, one launch of kernel 7
    with the optional fused epilogue, disassemble back to (N, Cout) masked
    to the valid rows. `residual` (N, Cout) is assembled alongside."""
    bg = level.brick
    res = None if residual is None else assemble(residual.to(x.dtype), bg)
    if scale is not None:
        scale, shift = scale.float().contiguous(), shift.float().contiguous()
    out = brick_conv3(assemble(x, bg), w.contiguous(), bg, scale, shift,
                      res, relu)
    return disassemble(out, bg, level)


class _BrickConv3(_Conv3):
    """k3 conv without epilogue at a brick level: forward kernel 7 between
    assemble and disassemble, backward _Conv3's (kernels 4 and 5 over the
    level's neighbour map). Saves the flat x."""

    @staticmethod
    def forward(ctx, x, w, level):
        ctx.save_for_backward(x, w)
        ctx.level = level
        return brick_conv3_flat(x, w, level)


def sparse_conv3(x, w, level: LevelGraph, bias=None, scale=None, shift=None,
                 residual=None, relu=False):
    """kernel_size=3, stride=1 conv with the optional fused eval epilogue.
    x: (N, Cin), w: (27, Cin, Cout) in x.dtype. Returns (N, Cout) in
    x.dtype. `level.brick` routes to kernel 7, else `level.csr` to kernel
    6, else kernel 1 runs. The epilogue is forward only: with it, no input
    may need a gradient (run an eval model under torch.no_grad())."""
    fused = (scale is not None or shift is not None or residual is not None
             or relu)
    if _needs_grad(x, w, bias, scale, shift, residual):
        if fused:
            raise NotImplementedError(
                "sparse_conv3: the fused epilogue has no backward; call it "
                "under torch.no_grad() or without scale/shift/residual/relu")
        fn = (_BrickConv3 if level.brick is not None
              else _Conv3 if level.csr is None else _CsrConv3)
        return _masked_bias(fn.apply(x, w, level), bias, level.valid)
    # one launch of kernel 7, 6 or 1 with the fused epilogue, forward only
    scale, shift = fold_bias(bias, scale, shift, w.shape[-1], x.device)
    if level.brick is not None:
        return brick_conv3_flat(x, w, level, scale=scale, shift=shift,
                                residual=residual, relu=relu)
    if level.csr is not None:
        return csr_conv3_fwd(x, w, level.csr, level.valid, scale=scale,
                             shift=shift, residual=residual, relu=relu)
    return conv3_fwd(x, w, level.nbr_idx, level.valid, scale=scale,
                     shift=shift, residual=residual, relu=relu,
                     order=_card_order(x, level))


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


# ------------------------------------------- MinkUNet / ResNet stride-2 ops
class _Conv3Down2(torch.autograd.Function):
    """k3 stride-2 conv, fine -> coarse (conv_ops.py:sparse_conv3_down2):
    forward and dx kernel 2, dW 27 gathered GEMMs."""

    @staticmethod
    def forward(ctx, x, w, coarse, fine):
        ctx.save_for_backward(x, w)
        ctx.levels = (coarse, fine)
        return k_apply(x, coarse.down_nbr_idx, w, coarse.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        coarse, fine = ctx.levels
        gm = _masked(g, coarse.valid, x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = k_apply(gm, coarse.down_nbr_t,
                         w.transpose(1, 2).contiguous(), fine.valid)
        if ctx.needs_input_grad[1]:
            dw = conv3_dw_plain(x, gm, coarse.down_nbr_idx).to(w.dtype)
        return dx, dw, None, None


def sparse_conv3_down2(x, w, coarse: LevelGraph, bias=None,
                       fine: LevelGraph | None = None):
    """kernel_size=3, STRIDE-2 conv (the MinkUNet / ResNet stage convs):
    fine -> coarse over the coarse level's `down_nbr_idx` (collate with
    `build_down_nbr_maps`), kernel 2 with K = 27. x: (N_fine, Cin), w: (27,
    Cin, Cout) in x.dtype. The backward needs the fine LevelGraph."""
    if coarse.down_nbr_idx is None:
        raise ValueError("sparse_conv3_down2: the coarse level has no "
                         "down_nbr_idx (build_down_nbr_maps=True)")
    if _needs_grad(x, w):
        if fine is None:
            raise ValueError("sparse_conv3_down2: the backward needs `fine`")
        out = _Conv3Down2.apply(x, w, coarse, fine)
    else:
        out = k_apply(x, coarse.down_nbr_idx, w, coarse.valid)
    return _masked_bias(out, bias, coarse.valid)


class _Conv1Down2(torch.autograd.Function):
    """k1 stride-2 conv (conv_ops.py:sparse_conv1_down2): forward kernel 2
    over the offset-0 child table, dx kernel 2 over the fine level's
    offset-0 parent table, dW one gathered GEMM."""

    @staticmethod
    def forward(ctx, x, w, coarse, fine):
        ctx.save_for_backward(x, w)
        ctx.levels = (coarse, fine)
        return k_apply(x, coarse.child_idx[0:1].contiguous(), w[None],
                       coarse.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        coarse, fine = ctx.levels
        gm = _masked(g, coarse.valid, x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = k_apply(gm, fine.up_idx[0:1].contiguous(),
                         w.T.contiguous()[None], fine.valid)
        if ctx.needs_input_grad[1]:
            dw = conv3_dw_plain(x, gm, coarse.child_idx[0:1])[0].to(w.dtype)
        return dx, dw, None, None


def sparse_conv1_down2(x, w, coarse: LevelGraph, bias=None,
                       fine: LevelGraph | None = None):
    """kernel_size=1, stride-2 conv (the MinkUNet / ResNet downsample
    shortcut): each coarse voxel takes the fine voxel at exactly 2 * coord
    (k2 offset 0), through kernel 2 with K = 1. x: (N_fine, Cin), w: (Cin,
    Cout) in x.dtype. The backward needs the fine LevelGraph."""
    if _needs_grad(x, w):
        if fine is None:
            raise ValueError("sparse_conv1_down2: the backward needs `fine`")
        out = _Conv1Down2.apply(x, w, coarse, fine)
    else:
        out = k_apply(x, coarse.child_idx[0:1].contiguous(), w[None],
                      coarse.valid)
    return _masked_bias(out, bias, coarse.valid)


class _SumPool2(torch.autograd.Function):
    """conv_ops.py:sum_pool2: forward kernel 2's child sum, dx the parent
    gather of g."""

    @staticmethod
    def forward(ctx, x, coarse, fine):
        ctx.levels = (coarse, fine)
        return k_apply(x, coarse.child_idx, None, coarse.valid)

    @staticmethod
    def backward(ctx, g):
        coarse, fine = ctx.levels
        gm = g * coarse.valid[:, None].to(g.dtype)
        dx = gm[fine.parent_idx.long()] * fine.valid[:, None].to(g.dtype)
        return dx, None, None


def sum_pool2(x, coarse: LevelGraph, fine: LevelGraph | None = None):
    """Minkowski sum pooling (kernel_size=2, stride=2; the reference ResNet
    stem, models/resnet.py:49-51): kernel 2's unweighted sum over the valid
    children, f32 accumulation, in x.dtype. The backward needs the fine
    LevelGraph."""
    if _needs_grad(x):
        if fine is None:
            raise ValueError("sum_pool2: the backward needs `fine`")
        return _SumPool2.apply(x, coarse, fine)
    return k_apply(x, coarse.child_idx, None, coarse.valid)


def max_pool2(x, coarse: LevelGraph):
    """MinkowskiMaxPooling(kernel_size=2, stride=2) over the valid children,
    0 where a row has none; plain torch (a gather and a max, as in the JAX
    package)."""
    idx = coarse.child_idx.long()
    g = x[idx]                                            # (8, Nc, C)
    ok = coarse.child_valid[..., None]
    g = torch.where(ok, g, torch.finfo(x.dtype).min)
    out = g.max(dim=0).values
    out = torch.where(ok.any(dim=0), out, torch.zeros_like(out))
    return out * coarse.valid[:, None].to(x.dtype)


def unpool_nearest(x_coarse, fine: LevelGraph):
    """Each fine voxel takes its parent's features (a gather)."""
    out = x_coarse[fine.parent_idx.long()]
    return out * fine.valid[:, None].to(x_coarse.dtype)
