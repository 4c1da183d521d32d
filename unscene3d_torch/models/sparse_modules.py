"""Sparse-conv modules (counterpart of unscene3d_tpu/models/sparse_modules.py).

Parameter layouts equal the JAX package's, so the weight bridge is a copy:
k3 kernels (27, Cin, Cout) (also the k3 stride-2 `k3down2`), k2 kernels (8,
Cin, Cout), k1 kernels (Cin, Cout) (also the k1 stride-2 `k1down2`).

Eval (`module.eval()`) folds BatchNorm into the conv epilogue; training
(`module.train()`) runs conv -> BatchNorm on batch statistics -> ReLU as the
JAX train branch does. A stride-2 BasicBlock runs the unfolded branch in
eval too, BatchNorm on its running statistics, as the JAX block does.
"""

from __future__ import annotations

import torch
from torch import nn

from unscene3d_torch.ops import conv_ops
from unscene3d_torch.ops.conv3 import epilogue
from unscene3d_torch.ops.sparse_graph import LevelGraph

_KERNEL_OFFSETS = {"k3": 27, "down2": 8, "up2": 8, "k3down2": 27}
# default torch-style momentum of the running BatchNorm statistics, the
# reference's bn_momentum (unscene3d_tpu/models/sparse_modules.py:116); the
# backbone passes its own `bn_momentum` to every SparseBatchNorm
_BN_MOMENTUM = 0.02


class SparseConv(nn.Module):
    """Sparse convolution; `kind` in 'k3', 'k1', 'down2', 'up2', 'k3down2',
    'k1down2'. For 'down2', 'k3down2' and 'k1down2' pass the coarse
    LevelGraph (and the fine one as `other` for the backward), for 'up2'
    the fine one (and the coarse one as `other`).

    `dtype` is the compute dtype: x and the kernel are cast to it at every
    call, as flax casts its params. The kernel is stored in `dtype` by
    construction (an eval model: rounded once at load, to the values flax
    rounds to at every call); a training model stores f32 masters
    (`model.float()`, train/loop.py) and the cast is then real. The bias
    stays f32: it is added in f32."""

    def __init__(self, in_channels: int, out_channels: int, kind: str = "k3",
                 use_bias: bool = False, dtype=torch.float32):
        super().__init__()
        if kind in ("k1", "k1down2"):
            shape = (in_channels, out_channels)
        elif kind in _KERNEL_OFFSETS:
            shape = (_KERNEL_OFFSETS[kind], in_channels, out_channels)
        else:
            raise ValueError(f"unknown conv kind {kind!r}")
        self.kind = kind
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(shape, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x, level: LevelGraph, other: LevelGraph | None = None,
                scale=None, shift=None, residual=None, relu=False):
        """scale/shift/residual/relu: the fused eval epilogue (folded BN,
        residual add, activation); in kernel 1 for k3, one f32 pass
        otherwise."""
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype)
        if self.kind == "k3":
            return conv_ops.sparse_conv3(x, w, level, self.bias, scale=scale,
                                         shift=shift, residual=residual,
                                         relu=relu)
        if self.kind == "k1":
            out = conv_ops.sparse_conv1(x, w, level, self.bias)
        elif self.kind == "down2":
            out = conv_ops.sparse_conv_down2(x, w, level, self.bias,
                                             fine=other)
        elif self.kind == "k3down2":
            out = conv_ops.sparse_conv3_down2(x, w, level, self.bias,
                                              fine=other)
        elif self.kind == "k1down2":
            out = conv_ops.sparse_conv1_down2(x, w, level, self.bias,
                                              fine=other)
        else:
            out = conv_ops.sparse_conv_up2(x, w, level, self.bias,
                                           coarse=other)
        if scale is not None or residual is not None or relu:
            # unfused, one f32 pass (sparse_modules.py:_apply_epilogue)
            out = epilogue(out.float(), level.valid, scale, shift, residual,
                           relu).to(out.dtype)
        return out


class SparseBatchNorm(nn.Module):
    """BatchNorm over valid rows only (sparse_modules.py:111-162).

    Eval: `fold()` gives the affine constants scale = rsqrt(var + eps) *
    gamma, shift = beta - mean * scale for a conv epilogue, and `forward`
    normalises with the running statistics (the JAX eval branch, for the
    blocks that do not fold). Training: `forward` normalises with the batch
    statistics of the valid rows in f32 (biased variance) and keeps (mean,
    unbiased variance) in `batch_stats`;
    `update_running_stats()` then moves the running estimates by the
    torch-style momentum m = `momentum`: running = (1 - m) * running +
    m * batch. The update is a separate call, like flax's mutated `batch_stats`, so a
    rematerialised forward cannot apply it twice."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype=torch.float32, momentum: float = _BN_MOMENTUM):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = float(momentum)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.batch_stats = None

    def fold(self):
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return inv, self.bias - self.mean * inv

    def forward(self, x, valid):
        """(N, C) -> (N, C) in `dtype`, zero on invalid rows: batch
        statistics in training, the running ones in eval."""
        if not self.training:
            inv = torch.rsqrt(self.var + self.epsilon)
            y = (x.float() - self.mean) * inv * self.scale + self.bias
            return (y * valid[:, None].to(torch.float32)).to(self.dtype)
        w = valid.to(torch.float32)
        cnt = torch.clamp_min(w.sum(), 1.0)
        xf = x.float()
        mean = (xf * w[:, None]).sum(0) / cnt
        var = (torch.square(xf - mean) * w[:, None]).sum(0) / cnt
        unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
        self.batch_stats = (mean.detach(), unbiased.detach())
        inv = torch.rsqrt(var + self.epsilon)
        y = (xf - mean) * inv * self.scale + self.bias
        y = y * w[:, None]
        return y.to(self.dtype)

    @torch.no_grad()
    def update_running_stats(self):
        if self.batch_stats is None:
            return
        mean, unbiased = self.batch_stats
        m = self.momentum
        self.mean.copy_((1 - m) * self.mean + m * mean)
        self.var.copy_((1 - m) * self.var + m * unbiased)
        self.batch_stats = None


class BasicBlock(nn.Module):
    """Residual basic block. Stride 1, eval (sparse_modules.py:183-202):
    conv1 + folded BN + ReLU, then conv2 + folded BN + residual + ReLU, both
    in one k3 kernel launch each; a k1 conv + folded BN shortcut when the
    width changes. Training, and stride 2 in eval too (:204-223): conv -> BN
    -> ReLU -> conv -> BN (+ k1/BN shortcut) -> ReLU(out + residual).

    stride=2 (the MinkUNet / ResNet stage pattern, reference
    models/resnet.py:96-133): conv1 is the k3 stride-2 conv from the fine
    level into `level` (the coarse one) and the shortcut a k1 stride-2 conv;
    pass the fine level as `fine` (their backward reads it)."""

    def __init__(self, inplanes: int, planes: int, dtype=torch.float32,
                 bn_momentum: float = _BN_MOMENTUM, stride: int = 1):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"BasicBlock: stride {stride}")
        self.stride = stride
        self.conv1 = SparseConv(inplanes, planes,
                                "k3down2" if stride == 2 else "k3",
                                dtype=dtype)
        self.norm1 = SparseBatchNorm(planes, dtype=dtype, momentum=bn_momentum)
        self.conv2 = SparseConv(planes, planes, "k3", dtype=dtype)
        self.norm2 = SparseBatchNorm(planes, dtype=dtype, momentum=bn_momentum)
        if inplanes != planes or stride == 2:
            self.downsample_conv = SparseConv(
                inplanes, planes, "k1down2" if stride == 2 else "k1",
                dtype=dtype)
            self.downsample_norm = SparseBatchNorm(planes, dtype=dtype,
                                                   momentum=bn_momentum)
        else:
            self.downsample_conv = self.downsample_norm = None

    def forward(self, x, level: LevelGraph, fine: LevelGraph | None = None):
        if self.training or self.stride == 2:
            return self._forward_train(x, level, fine)
        residual = x
        if self.downsample_conv is not None:
            sd, bd = self.downsample_norm.fold()
            residual = self.downsample_conv(x, level, scale=sd, shift=bd)
        s1, b1 = self.norm1.fold()
        s2, b2 = self.norm2.fold()
        out = self.conv1(x, level, scale=s1, shift=b1, relu=True)
        return self.conv2(out, level, scale=s2, shift=b2, residual=residual,
                          relu=True)

    def _forward_train(self, x, level: LevelGraph, fine=None):
        out = torch.relu(self.norm1(self.conv1(x, level, fine), level.valid))
        out = self.norm2(self.conv2(out, level), level.valid)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_norm(
                self.downsample_conv(x, level, fine), level.valid)
        return torch.relu(out + residual)
