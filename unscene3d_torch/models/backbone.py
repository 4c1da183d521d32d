"""Res16UNet sparse-conv backbone family (counterpart of
unscene3d_tpu/models/backbone.py).

A 4-down/4-up UNet over the 5-level SparseGraph with skip concatenations,
returning the full-res features, the FPN list [stride 16, 8, 4, 2, 1] the
Mask3D decoder consumes, and the final k1 projection. Submodule names equal
the JAX package's, so the weight bridge maps names one to one.

Eval folds each BatchNorm into its conv's epilogue. Training runs conv ->
BN -> ReLU unfolded and recomputes each residual block in the backward
(torch.utils.checkpoint, as the JAX model's nn.remat under the backbone
conf's default `remat: true`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unscene3d_torch.models.sparse_modules import (BasicBlock,
                                                   SparseBatchNorm,
                                                   SparseConv)
from unscene3d_torch.ops.sparse_graph import SparseGraph


class Res16UNetBase(nn.Module):
    planes: tuple = (32, 64, 128, 256, 256, 256, 256, 256)
    layers: tuple = (2, 2, 2, 2, 2, 2, 2, 2)

    def __init__(self, out_channels: int, in_channels: int = 3,
                 init_dim: int = 32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        p, L = self.planes, self.layers
        # stem, then each strided conv keeps its input width
        self._conv_bn("conv0p1s1", in_channels, init_dim, "k3")
        inp = init_dim
        for s in range(4):
            self._conv_bn(f"conv{s + 1}p{2 ** s}s2", inp, inp, "down2")
            inp = self._blocks(f"block{s + 1}", inp, p[s], L[s])
        skips = [p[2], p[1], p[0], init_dim]
        for u in range(4):
            self._conv_bn(f"convtr{u + 4}p{2 ** (4 - u)}s2", inp, p[4 + u],
                          "up2")
            inp = self._blocks(f"block{u + 5}", p[4 + u] + skips[u], p[4 + u],
                               L[4 + u])
        # the JAX model builds `final` without a dtype: it runs in f32
        self.final = SparseConv(inp, out_channels, "k1", use_bias=True)

    def _conv_bn(self, name, cin, cout, kind):
        self.add_module(f"{name}_conv",
                        SparseConv(cin, cout, kind, dtype=self.dtype))
        self.add_module(f"{name}_bn", SparseBatchNorm(cout, dtype=self.dtype))

    def _blocks(self, name, cin, planes, n):
        for bi in range(n):
            self.add_module(f"{name}_{bi}",
                            BasicBlock(cin, planes, dtype=self.dtype))
            cin = planes
        return planes

    def _run_conv_bn(self, name, x, level, other=None):
        conv, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        if self.training:
            return torch.relu(bn(conv(x, level, other), level.valid))
        sc, sh = bn.fold()
        return conv(x, level, other, scale=sc, shift=sh, relu=True)

    def _run_blocks(self, name, x, level, n):
        for bi in range(n):
            block = getattr(self, f"{name}_{bi}")
            if self.training:
                x = checkpoint(block, x, level, use_reentrant=False)
            else:
                x = block(x, level)
        return x

    def forward(self, features, graph: SparseGraph):
        """features: (N0_pad, in_channels). Returns (res_1, fpn, final)."""
        if graph.num_levels != 5:
            raise ValueError("Res16UNet needs a 5-level SparseGraph")
        L = graph.levels
        out_p1 = self._run_conv_bn("conv0p1s1", features, L[0])
        out = out_p1
        skips = []
        for s in range(4):
            out = self._run_conv_bn(f"conv{s + 1}p{2 ** s}s2", out, L[s + 1],
                                    L[s])
            out = self._run_blocks(f"block{s + 1}", out, L[s + 1],
                                   self.layers[s])
            skips.append(out)
        fpn = [out]
        for u in range(4):
            lv = 3 - u
            out = self._run_conv_bn(f"convtr{u + 4}p{2 ** (4 - u)}s2", out,
                                    L[lv], L[lv + 1])
            skip = skips[lv - 1] if lv > 0 else out_p1
            out = torch.cat([out, skip], dim=-1)
            out = self._run_blocks(f"block{u + 5}", out, L[lv],
                                   self.layers[4 + u])
            fpn.append(out)
        final = self.final(out, L[0])
        return out, fpn, final


class Res16UNet14A(Res16UNetBase):
    planes = (32, 64, 128, 256, 128, 128, 96, 96)
    layers = (1, 1, 1, 1, 1, 1, 1, 1)


class Res16UNet18A(Res16UNetBase):
    planes = (32, 64, 128, 256, 128, 128, 96, 96)
    layers = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet18B(Res16UNetBase):
    planes = (32, 64, 128, 256, 128, 128, 128, 128)
    layers = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet34A(Res16UNetBase):
    planes = (32, 64, 128, 256, 256, 128, 64, 64)
    layers = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet34B(Res16UNetBase):
    planes = (32, 64, 128, 256, 256, 128, 64, 32)
    layers = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet34C(Res16UNetBase):
    """The reference's flagship backbone."""

    planes = (32, 64, 128, 256, 256, 128, 96, 96)
    layers = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet34D(Res16UNetBase):
    planes = (32, 64, 128, 256, 256, 128, 96, 128)
    layers = (2, 3, 4, 6, 2, 2, 2, 2)
