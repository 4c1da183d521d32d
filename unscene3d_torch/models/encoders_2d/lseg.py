"""LSeg language-driven 2D encoder (the port's counterpart of
unscene3d_tpu/models/encoders_2d/lseg.py; reference third_party/LSeg_fork/
modules/models/lseg_net.py and lseg_vit.py): a DPT decoder over a
CLIP-aligned ViT-L/16, 512-d L2-normalised pixel features.

  * ViT: 24 blocks, dim 1024, 16 heads, exact-erf GELU, LayerNorm eps 1e-6;
    the block outputs at depths (5, 11, 17, 23) are hooked; the pos-embed,
    stored for a 24 x 24 grid (384 / 16), is resized bilinearly
    (align_corners=False) to the frame's token grid (lseg_vit.py:149-163).
  * Reassembly (act_postprocess): the "project" readout concat(patch, cls)
    -> Linear -> GELU, the token grid to an image, a 1 x 1 conv to (256,
    512, 1024, 1024) channels, then a x4 / x2 transposed conv, nothing, or a
    stride-2 3 x 3 conv (lseg_vit.py:446-523).
  * Scratch: bias-free 3 x 3 convs to 256 features, four fusion blocks of
    BatchNorm residual conv units with an align_corners=True x2 bilinear
    upsample (lseg_blocks.py:220-358), `head1` to 512, L2 normalisation, a
    last x2.

Parameter names are the reference's (`pretrained.model.blocks.N.attn.qkv`,
`pretrained.act_postprocessN.3`, `scratch.refinenetN.resConfUnit2.bn1`,
`scratch.head1`, ...), so `load_torch_lseg_weights` takes a reference
checkpoint's state dict as it is, without its `net.` prefix. As in the JAX
module, `refinenet4` has no `resConfUnit1` (it fuses no skip; the
reference's unused unit is not loaded). The products are nn.Linear,
torch.matmul and F.conv2d: the JAX package has no Pallas kernel here.
`models/weights.py:lseg_state_from_flax` bridges the JAX module's
variables.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unscene3d_torch.models.encoders_2d.dino import (IMAGENET_MEAN,
                                                     IMAGENET_STD, Block,
                                                     PatchEmbed)
from unscene3d_torch.runtime import resolve_device

RESAMPLES = ("up4", "up2", "none", "down2")
TINY = dict(vit_dim=64, vit_depth=4, vit_heads=2, hooks=(0, 1, 2, 3),
            reassemble_ch=(16, 32, 64, 64), features=16, native_grid=4)
# the reference's logit scale, exp(log(1 / 0.07)) (lseg_net.py:176-221)
LOGIT_SCALE = float(np.exp(np.log(1.0 / 0.07)))


def resize_pos_embed(pos, h: int, w: int):
    """(1, g*g + 1, D) -> (1, h*w + 1, D): the grid resized bilinearly with
    align_corners=False, the cls token kept (lseg_vit.py:149-163)."""
    tok, grid = pos[:, :1], pos[0, 1:]
    g = int(round(float(np.sqrt(grid.shape[0]))))
    d = grid.shape[-1]
    grid = F.interpolate(grid.reshape(1, g, g, d).permute(0, 3, 1, 2),
                         size=(h, w), mode="bilinear", align_corners=False)
    return torch.cat([tok, grid.permute(0, 2, 3, 1).reshape(1, h * w, d)],
                     dim=1)


def upsample2x(x):
    """Bilinear x2 with align_corners=True, (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class _ViT(nn.Module):
    """The ViT trunk under the reference's `pretrained.model` names."""

    def __init__(self, dim, depth, heads, patch, grid0):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid0 * grid0 + 1, dim))
        self.patch_embed = PatchEmbed(dim, patch, patch)
        self.blocks = nn.ModuleList(Block(dim, heads, gelu="none")
                                    for _ in range(depth))


class _ProjectReadout(nn.Module):
    """concat(patch tokens, cls broadcast) -> Linear -> exact GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, x):
        readout = x[:, :1].expand(-1, x.shape[1] - 1, -1)
        return self.project(torch.cat([x[:, 1:], readout], dim=-1))


def _postprocess(dim: int, ch: int, resample: str) -> nn.Sequential:
    """act_postprocessN: [readout, (transpose), (unflatten), 1 x 1 conv,
    resample]; the two reshapes are Identity here (forward does them), so
    the indices of the parameters are the reference's."""
    seq = [_ProjectReadout(dim), nn.Identity(), nn.Identity(),
           nn.Conv2d(dim, ch, 1)]
    if resample == "up4":
        seq.append(nn.ConvTranspose2d(ch, ch, 4, stride=4))
    elif resample == "up2":
        seq.append(nn.ConvTranspose2d(ch, ch, 2, stride=2))
    elif resample == "down2":
        seq.append(nn.Conv2d(ch, ch, 3, stride=2, padding=1))
    return nn.Sequential(*seq)


class _ResidualConvUnit(nn.Module):
    """relu -> conv -> BN -> relu -> conv -> BN, + skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features)

    def forward(self, x):
        out = self.bn1(self.conv1(F.relu(x)))
        return self.bn2(self.conv2(F.relu(out))) + x


class _FeatureFusion(nn.Module):
    def __init__(self, features: int, skip: bool):
        super().__init__()
        self.resConfUnit1 = _ResidualConvUnit(features) if skip else None
        self.resConfUnit2 = _ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(upsample2x(self.resConfUnit2(x)))


class LSegFeatureNet(nn.Module):
    """The LSeg image tower (forward_image, lseg_net.py:231-265). forward
    takes normalised (B, 3, H, W) images and returns NHWC tensors (out at
    H x W, path1 at H/2, path2 at H/4, path3 at H/8); `out` is the
    L2-normalised `out_dim` feature map."""

    def __init__(self, vit_dim: int = 1024, vit_depth: int = 24,
                 vit_heads: int = 16, patch_size: int = 16,
                 hooks: tuple = (5, 11, 17, 23),
                 reassemble_ch: tuple = (256, 512, 1024, 1024),
                 features: int = 256, out_dim: int = 512,
                 native_grid: int = 24):
        super().__init__()
        self.patch_size = patch_size
        self.hooks = tuple(hooks)
        self.pretrained = nn.Module()
        self.pretrained.model = _ViT(vit_dim, vit_depth, vit_heads,
                                     patch_size, native_grid)
        for i, (ch, rs) in enumerate(zip(reassemble_ch, RESAMPLES)):
            setattr(self.pretrained, f"act_postprocess{i + 1}",
                    _postprocess(vit_dim, ch, rs))
        self.scratch = nn.Module()
        for i, ch in enumerate(reassemble_ch):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    nn.Conv2d(ch, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}",
                    _FeatureFusion(features, skip=i < 4))
        self.scratch.head1 = nn.Conv2d(features, out_dim, 1)

    def init_random_(self, seed: int = 0) -> "LSegFeatureNet":
        """Seeded random weights: normal(0, 0.02) kernels and embeddings,
        zero biases, LayerNorms and BatchNorms at identity; the same for a
        seed on any device."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                    if isinstance(mod, nn.BatchNorm2d):
                        mod.running_mean.zero_()
                        mod.running_var.fill_(1.0)
                    continue
                for name, p in mod.named_parameters(recurse=False):
                    if name == "bias":
                        p.zero_()
                    else:
                        p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self

    def forward(self, images):
        B, _, H, W = images.shape
        vit = self.pretrained.model
        h, w = H // self.patch_size, W // self.patch_size
        x = vit.patch_embed(images)
        x = torch.cat([vit.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + resize_pos_embed(vit.pos_embed, h, w)
        hooked = []
        for i, blk in enumerate(vit.blocks):
            x = blk(x)
            if i in self.hooks:
                hooked.append(x)
        layers = []
        for i, tokens in enumerate(hooked):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            y = post[0](tokens).transpose(1, 2).unflatten(2, (h, w))
            y = post[3](y)
            if len(post) > 4:
                y = post[4](y)
            layers.append(y)
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(layers[i]) for i in range(4)]
        path4 = s.refinenet4(rn[3])
        path3 = s.refinenet3(path4, rn[2])
        path2 = s.refinenet2(path3, rn[1])
        path1 = s.refinenet1(path2, rn[0])
        feats = s.head1(path1)
        feats = feats / torch.clamp_min(
            torch.linalg.vector_norm(feats, dim=1, keepdim=True), 1e-12)
        out = upsample2x(feats)
        return tuple(t.permute(0, 2, 3, 1) for t in (out, path1, path2,
                                                     path3))


class LSegNet:
    """The reference wrapper's contract (models/encoders_2d/lseg.py:8-63):
    `__call__` takes (B, H, W, 3) images in [0, 1] and returns (B, H, W,
    512) normalised pixel features on the device; `forward_multi_res` the
    (out, 1/2, 1/4, 1/8) maps of (B, V, H, W, 3) frames; `relevance_maps`
    the per-pixel label logits against precomputed CLIP text embeddings
    (lseg_net.py:176-221 with precompute_text_feats=True). H and W must be
    multiples of 32."""

    feature_dim = 512

    def __init__(self, state_dict=None, image_size: tuple = (256, 320),
                 text_embeddings=None, tiny: bool = False, device="cuda",
                 seed: int = 0):
        """state_dict: `load_torch_lseg_weights(checkpoint)` or the port's
        own state dict; None for seeded random weights. `tiny`: the JAX
        package's tiny test configuration (ViT dim 64, depth 4)."""
        if image_size[0] % 32 or image_size[1] % 32:
            raise ValueError(
                f"LSeg needs H, W divisible by 32 (the token grid must "
                f"survive the /32 pyramid and the x2 fusions); got "
                f"{tuple(image_size)}")
        self.device = resolve_device(device)
        self.image_size = tuple(image_size)
        self.model = LSegFeatureNet(**(TINY if tiny else {}))
        if state_dict is None:
            self.model.init_random_(seed)
        else:
            load_lseg_state(self.model, state_dict)
        self.model.to(self.device).eval()
        self.text_embeddings = text_embeddings
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(IMAGENET_STD, device=self.device)

    def _forward(self, images):
        """(N, H, W, 3) in [0, 1] -> the tower's four NHWC maps."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(f"LSeg needs H, W divisible by 32, got "
                             f"{tuple(x.shape[1:3])}")
        with torch.no_grad():
            return self.model(((x - self.mean) / self.std).permute(0, 3, 1,
                                                                   2))

    def __call__(self, images) -> torch.Tensor:
        return self._forward(images)[0]

    def forward_multi_res(self, images):
        """images (B, V, H, W, 3) -> (out, half, quarter, eighth), each
        (B, V, h, w, C)."""
        x = torch.as_tensor(images)
        B, V = x.shape[:2]
        outs = self._forward(x.reshape((B * V,) + tuple(x.shape[2:])))
        return tuple(t.reshape((B, V) + tuple(t.shape[1:])) for t in outs)

    def relevance_maps(self, images) -> torch.Tensor:
        """(B, H, W, L) logits: LOGIT_SCALE * normalised features @
        normalised text embeddings^T."""
        if self.text_embeddings is None:
            raise ValueError("no text embeddings loaded")
        text = torch.as_tensor(self.text_embeddings, dtype=torch.float32,
                               device=self.device)
        text = text / torch.clamp_min(
            torch.linalg.vector_norm(text, dim=-1, keepdim=True), 1e-12)
        return LOGIT_SCALE * torch.matmul(self(images), text.T)


def load_torch_lseg_weights(path_or_state) -> dict[str, torch.Tensor]:
    """A reference LSeg checkpoint (a path, or an in-memory state dict,
    under an optional `state_dict` wrapper) as f32 CPU tensors under the
    port's names: the Lightning `net.` prefix stripped, as the reference
    wrapper strips it (models/encoders_2d/lseg.py:31-35)."""
    sd = path_or_state
    if isinstance(sd, (str, bytes)):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if any(k.startswith("net.") for k in sd):
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def load_lseg_state(model: LSegFeatureNet, state: dict) -> None:
    """Copy the model's own keys from `state`; a missing key or a shape
    mismatch raises. Keys the tower does not use (the reference's CLIP text
    tower, `pretrained.model.norm`, refinenet4's resConfUnit1, ...) are
    left out."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state)
    if missing:
        raise KeyError(f"LSeg weights: missing {missing}")
    picked = {}
    for k, v in own.items():
        t = torch.as_tensor(state[k])
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f"LSeg weights: {k} has shape "
                             f"{tuple(t.shape)}, model wants "
                             f"{tuple(v.shape)}")
        picked[k] = t.to(v.dtype)
    model.load_state_dict(picked, strict=True)
