"""MinkUNet (ResUNet) and sparse ResNet families (counterpart of
unscene3d_tpu/models/resunet.py; reference models/resunet.py:11-240 and
models/resnet.py:9-140).

  * MinkUNetBase: a 3-down/3-up UNet over levels 0-3 with k2 stride-2 convs,
    skip concatenations and a k1 -> 512 -> BN -> ReLU -> k1 head; variants
    ResUNet14/18/34 and the A channel plans.
  * ResNetBase: a classifier trunk, a k3 stem and a sum pool, then four
    stages whose first block strides with a k3 stride-2 conv; it needs a
    6-level graph with the k3 stride-2 maps (`ops/kernel_maps.py:
    build_sparse_graph(coords, num_levels=6, build_down_nbr_maps=True)`).

Submodule names equal the JAX modules', so `models/weights.py:
load_flax_backbone_variables` carries the JAX variables over one to one.
The conv-BN-ReLU units run unfolded in eval too, BatchNorm on its running
statistics, as the JAX modules do; the stride-1 blocks fold BatchNorm into
their k3 convs' epilogue in eval. In training the strided and transposed
convs get the level on their other side, for their backward. The k3 convs
run kernel 1 (7 or 6 at brick or CSR levels), the k2 and stride-2 convs and
the sum pool kernel 2.
"""

from __future__ import annotations

import torch
from torch import nn

from unscene3d_torch.models.sparse_modules import (BasicBlock,
                                                   SparseBatchNorm,
                                                   SparseConv)
from unscene3d_torch.ops import conv_ops
from unscene3d_torch.ops.sparse_graph import SparseGraph


class _SparseNet(nn.Module):
    """The conv-BN-ReLU unit and the block stacks shared by both families."""

    def _conv_bn(self, name, cin, cout, kind, dtype):
        self.add_module(f"{name}_conv", SparseConv(cin, cout, kind,
                                                   dtype=dtype))
        self.add_module(f"{name}_bn", SparseBatchNorm(
            cout, dtype=dtype, momentum=self.bn_momentum))

    def _run_conv_bn(self, name, x, level, other=None):
        conv, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        return torch.relu(bn(conv(x, level, other), level.valid))

    def _blocks(self, name, cin, planes, n):
        for bi in range(n):
            self.add_module(f"{name}_{bi}", BasicBlock(
                cin, planes, dtype=self.dtype, bn_momentum=self.bn_momentum))
            cin = planes
        return planes

    def _run_blocks(self, name, x, level, n):
        for bi in range(n):
            x = getattr(self, f"{name}_{bi}")(x, level)
        return x


class MinkUNetBase(_SparseNet):
    planes: tuple = (64, 128, 256, 512, 256, 128, 128)
    layers: tuple = (2, 2, 2, 2, 2, 2)

    def __init__(self, out_channels: int, in_channels: int = 3,
                 init_dim: int = 64, planes: tuple | None = None,
                 layers: tuple | None = None, dtype=torch.float32,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.planes = tuple(planes or self.planes)
        self.layers = tuple(layers or self.layers)
        self.dtype = dtype
        self.bn_momentum = float(bn_momentum)
        p, L = self.planes, self.layers
        self._conv_bn("conv1p1s1", in_channels, init_dim, "k3", dtype)
        b1 = self._blocks("block1", init_dim, p[0], L[0])
        self._conv_bn("conv2p1s2", b1, b1, "down2", dtype)
        b2 = self._blocks("block2", b1, p[1], L[1])
        self._conv_bn("conv3p2s2", b2, b2, "down2", dtype)
        b3 = self._blocks("block3", b2, p[2], L[2])
        self._conv_bn("conv4p4s2", b3, b3, "down2", dtype)
        b4 = self._blocks("block4", b3, p[3], L[3])
        self._conv_bn("convtr4p8s2", b4, p[4], "up2", dtype)
        self._blocks("block5", p[4] + b3, p[4], L[4])
        self._conv_bn("convtr5p4s2", p[4], p[5], "up2", dtype)
        self._blocks("block6", p[5] + b2, p[5], L[5])
        self._conv_bn("convtr6p2s2", p[5], p[6], "up2", dtype)
        # head: k1 -> 512 -> BN -> ReLU, then the final k1 (reference
        # :227-240); the JAX model builds `final` without a dtype: f32
        self._conv_bn("final_hidden", p[6] + b1, 512, "k1", dtype)
        self.final = SparseConv(512, out_channels, "k1", use_bias=True)

    def forward(self, features, graph: SparseGraph):
        """features: (N0_pad, in_channels) -> (N0_pad, out_channels)."""
        if graph.num_levels < 4:
            raise ValueError("MinkUNet needs a graph of 4 levels or more")
        L, n = graph.levels, self.layers
        out = self._run_conv_bn("conv1p1s1", features, L[0])
        out_b1 = self._run_blocks("block1", out, L[0], n[0])
        out = self._run_conv_bn("conv2p1s2", out_b1, L[1], L[0])
        out_b2 = self._run_blocks("block2", out, L[1], n[1])
        out = self._run_conv_bn("conv3p2s2", out_b2, L[2], L[1])
        out_b3 = self._run_blocks("block3", out, L[2], n[2])
        out = self._run_conv_bn("conv4p4s2", out_b3, L[3], L[2])
        out = self._run_blocks("block4", out, L[3], n[3])
        out = self._run_conv_bn("convtr4p8s2", out, L[2], L[3])
        out = self._run_blocks("block5", torch.cat([out, out_b3], -1), L[2],
                               n[4])
        out = self._run_conv_bn("convtr5p4s2", out, L[1], L[2])
        out = self._run_blocks("block6", torch.cat([out, out_b2], -1), L[1],
                               n[5])
        out = self._run_conv_bn("convtr6p2s2", out, L[0], L[1])
        out = torch.cat([out, out_b1], -1)
        out = self._run_conv_bn("final_hidden", out, L[0])
        return self.final(out, L[0])


class ResUNet14(MinkUNetBase):
    layers = (1, 1, 1, 1, 1, 1)


class ResUNet18(MinkUNetBase):
    layers = (2, 2, 2, 2, 2, 2)


class ResUNet34(MinkUNetBase):
    layers = (2, 3, 4, 6, 2, 2)


class ResUNet14A(ResUNet14):
    planes = (64, 128, 256, 512, 256, 128, 96)


class ResUNet18A(ResUNet18):
    planes = (64, 128, 256, 512, 256, 128, 96)


class ResNetBase(_SparseNet):
    """Sparse ResNet trunk (OUT_PIXEL_DIST 32): the k3 stem at level 0, a
    sum pool to level 1, then stage s's stride-2 block from level s + 1
    into level s + 2 and its stride-1 blocks there; the final k1 conv at
    level 5."""

    planes: tuple = (64, 128, 256, 512)
    layers: tuple = (2, 2, 2, 2)

    def __init__(self, out_channels: int, in_channels: int = 3,
                 init_dim: int = 64, planes: tuple | None = None,
                 layers: tuple | None = None, dtype=torch.float32,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.planes = tuple(planes or self.planes)
        self.layers = tuple(layers or self.layers)
        self.dtype = dtype
        self.bn_momentum = float(bn_momentum)
        self.conv1 = SparseConv(in_channels, init_dim, "k3", dtype=dtype)
        self.bn1 = SparseBatchNorm(init_dim, dtype=dtype,
                                   momentum=self.bn_momentum)
        cin = init_dim
        for si, (planes_s, n) in enumerate(zip(self.planes, self.layers)):
            for bi in range(n):
                self.add_module(f"layer{si + 1}_{bi}", BasicBlock(
                    cin, planes_s, dtype=dtype, bn_momentum=self.bn_momentum,
                    stride=2 if bi == 0 else 1))
                cin = planes_s
        self.final = SparseConv(cin, out_channels, "k1", use_bias=True)

    def forward(self, features, graph: SparseGraph):
        """features: (N0_pad, in_channels) -> (N5_pad, out_channels)."""
        if graph.num_levels < 6 or graph.levels[2].down_nbr_idx is None:
            raise ValueError("ResNet needs a 6-level graph with the k3 "
                             "stride-2 maps (build_down_nbr_maps=True)")
        L = graph.levels
        x = torch.relu(self.bn1(self.conv1(features, L[0]), L[0].valid))
        x = conv_ops.sum_pool2(x, L[1], L[0])
        for si, n in enumerate(self.layers):
            for bi in range(n):
                fine = L[1 + si] if bi == 0 else None
                x = getattr(self, f"layer{si + 1}_{bi}")(x, L[2 + si], fine)
        return self.final(x, L[5])


class ResNet14(ResNetBase):
    layers = (1, 1, 1, 1)


class ResNet18(ResNetBase):
    layers = (2, 2, 2, 2)


class ResNet34(ResNetBase):
    layers = (3, 4, 6, 3)
