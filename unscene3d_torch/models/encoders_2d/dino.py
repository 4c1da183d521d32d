"""DINO ViT-S/8 feature extractor with the reduced-stride trick (the port's
counterpart of unscene3d_tpu/models/encoders_2d/dino.py; reference
third_party/dino_vit/extractor.py:16-140 and models/encoders_2d/dino.py:
7-126).

A ViT-S (dim 384, 6 heads, 12 blocks, patch 8) runs at stride 4: the
positional embeddings, stored for the 28 x 28 patch grid of a 224 image,
are resized to the denser token grid with torch's bicubic at the
reference's scale factors. It returns per-token descriptors (the KEY
vectors of block `facet_layer` by default), and `DinoNet` upsamples them
bilinearly to the frame.

Parameter names are the DINO repository's (`patch_embed.proj`,
`blocks.N.attn.qkv`, `blocks.N.mlp.fc1`, `norm`), so a `dino_deitsmall8`
checkpoint loads with `load_state_dict` (`load_dino_weights` strips the
`module.` prefix). The products are plain PyTorch: this encoder has no
Pallas kernel in the JAX package.

Two choices follow the JAX package, not the DINO repository: the MLP's GELU
is the tanh approximation (flax's `nn.gelu` default; the DINO weights were
trained with the exact erf form, up to 4.7e-4 apart per activation), and
the patch embedding is an `unfold` and a matmul, not a convolution, so that
its f32 result does not depend on cuDNN's TF32 setting. For the 'key' and
'query' facets the blocks after `facet_layer` are skipped: the output does
not depend on them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unscene3d_torch.runtime import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FACETS = ("key", "query", "token", "attn_qk")


def interpolate_pos_encoding(pos: torch.Tensor, h0: int, w0: int,
                             grid0: int) -> torch.Tensor:
    """The reference's pos-embed resize for an (h0, w0) token grid
    (extractor.py:85-119): bicubic, scale_factor ((w0 + 0.1) / g,
    (h0 + 0.1) / g), recompute_scale_factor=False. As the reference, it
    applies the W-derived scale to the ROW axis and flattens the (w0, h0)
    grid over the (h0, w0) token layout: a transposition on non-square
    grids, kept so that the trained weights see what they were trained on.

    pos: (1, g*g + 1, D) -> (1, h0*w0 + 1, D)."""
    if h0 == grid0 and w0 == grid0:
        return pos
    cls_pos, grid = pos[:, :1], pos[:, 1:]
    d = grid.shape[-1]
    grid = F.interpolate(
        grid.reshape(1, grid0, grid0, d).permute(0, 3, 1, 2),
        scale_factor=((w0 + 0.1) / grid0, (h0 + 0.1) / grid0),
        mode="bicubic", align_corners=False, recompute_scale_factor=False)
    if tuple(grid.shape[-2:]) != (w0, h0):
        raise ValueError(f"pos-embed resize gave {tuple(grid.shape[-2:])}, "
                         f"want {(w0, h0)}")
    return torch.cat([cls_pos, grid.permute(0, 2, 3, 1).reshape(1, -1, d)],
                     dim=1)


class PatchEmbed(nn.Module):
    """The patch convolution's parameters under the DINO name `proj`,
    applied as unfold + matmul (no cuDNN, no TF32 path)."""

    def __init__(self, dim: int, patch: int, stride: int):
        super().__init__()
        self.patch, self.stride = patch, stride
        self.proj = nn.Conv2d(3, dim, patch, stride=stride)

    def forward(self, x):
        """x (B, 3, H, W) -> (B, h*w, dim), tokens in row-major order."""
        cols = F.unfold(x, self.patch, stride=self.stride)   # (B, 3pp, L)
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        return torch.matmul(cols.transpose(1, 2), w.t()) + self.proj.bias


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def heads(self, x):
        """q, k, v, each (B, N, H, D / H)."""
        B, N, D = x.shape
        return self.qkv(x).reshape(B, N, 3, self.num_heads,
                                   D // self.num_heads).unbind(2)

    def forward(self, x):
        B, N, D = x.shape
        q, k, v = (t.transpose(1, 2) for t in self.heads(x))   # (B, H, N, d)
        attn = torch.matmul(q, k.transpose(-1, -2))
        attn = attn.div_(math.sqrt(D // self.num_heads)).softmax(-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, D)
        return self.proj(out)


class Mlp(nn.Module):
    """fc1 -> GELU (`gelu`: 'tanh', flax's default, or 'none', the exact
    erf form) -> fc2."""

    def __init__(self, dim: int, hidden: int, gelu: str = "tanh"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.gelu = gelu

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.gelu))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 gelu: str = "tanh"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViTExtractor(nn.Module):
    """ViT-S/8 run at a reduced stride; returns token-grid features."""

    def __init__(self, patch_size: int = 8, stride: int = 4, dim: int = 384,
                 depth: int = 12, num_heads: int = 6, facet_layer: int = 9):
        super().__init__()
        self.patch_size, self.stride = patch_size, stride
        self.depth, self.facet_layer = depth, facet_layer
        self.grid0 = 224 // patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid0 * self.grid0 + 1, dim))
        self.patch_embed = PatchEmbed(dim, patch_size, stride)
        self.blocks = nn.ModuleList(Block(dim, num_heads)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def init_random_(self, seed: int = 0) -> "ViTExtractor":
        """Seeded random weights (normal, std 0.02; biases zero, LayerNorms
        at identity), the same for a seed on any device."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias") or ".norm" in name or \
                        name.startswith("norm."):
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self

    def forward(self, images: torch.Tensor, facet: str = "key"):
        """images (B, H, W, 3), normalised. Returns (B, h, w, C) on the
        stride grid; for 'attn_qk' the last block's (keys, queries)."""
        if facet not in FACETS:
            raise ValueError(f"unknown facet {facet!r}")
        B, H, W, _ = images.shape
        h = (H - self.patch_size) // self.stride + 1
        w = (W - self.patch_size) // self.stride + 1
        x = self.patch_embed(images.permute(0, 3, 1, 2))
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + interpolate_pos_encoding(self.pos_embed, h, w, self.grid0)
        if facet == "token":
            for blk in self.blocks:
                x = blk(x)
            return self.norm(x)[:, 1:].reshape(B, h, w, -1)
        last = self.facet_layer if facet in ("key", "query") else \
            self.depth - 1
        for blk in self.blocks[:last]:
            x = blk(x)
        q, k, _ = self.blocks[last].attn.heads(self.blocks[last].norm1(x))
        q, k = (t[:, 1:].reshape(B, h, w, -1) for t in (q, k))
        if facet == "attn_qk":
            return k, q
        return k if facet == "key" else q


class DinoNet:
    """Per-pixel DINO descriptors (reference models/encoders_2d/dino.py:
    29-126): ImageNet normalisation, the ViT-S/8 at `stride`, then a
    bilinear upsample of the token grid to the frame's size."""

    feature_dim = 384

    def __init__(self, state_dict=None, facet: str = "key", stride: int = 4,
                 device="cuda"):
        """state_dict: a DINO ViT-S/8 state dict (`load_dino_weights`), or
        None for random weights from seed 0."""
        if facet not in ("key", "query", "token"):
            raise ValueError(f"DinoNet gives per-pixel 'key', 'query' or "
                             f"'token' features, not {facet!r}")
        self.device = resolve_device(device)
        self.facet = facet
        self.model = ViTExtractor(stride=stride)
        if state_dict is None:
            self.model.init_random_(0)
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(IMAGENET_STD, device=self.device)

    def __call__(self, images) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] (numpy or tensor). Returns
        (B, H, W, 384) f32 descriptors on the device (a permuted view)."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        H, W = x.shape[1:3]
        with torch.no_grad():
            feats = self.model((x - self.mean) / self.std, facet=self.facet)
            up = F.interpolate(feats.permute(0, 3, 1, 2), size=(H, W),
                               mode="bilinear", align_corners=False)
        return up.permute(0, 2, 3, 1)


def load_dino_weights(path_or_state_dict) -> dict[str, torch.Tensor]:
    """A DINO ViT state dict (a checkpoint path or an in-memory dict, under
    an optional `state_dict` wrapper and `module.` prefix) as f32 CPU
    tensors under the DINO names, ready for `ViTExtractor.load_state_dict`."""
    sd = path_or_state_dict
    if isinstance(sd, (str, bytes)):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.removeprefix("module."): torch.as_tensor(v, dtype=torch.float32)
            for k, v in sd.items()}
