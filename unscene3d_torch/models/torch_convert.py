"""MinkowskiEngine Res16UNet checkpoints -> the port's backbone state (the
counterpart of unscene3d_tpu/models/torch_convert.py).

Loads the reference ecosystem's pretrained weights, e.g. the CSC backbone
`CSC_train_Res16UNet34C_2cm.pth` that pseudo-mask generation reads
(pseudo_masks/unscene3d_pseudo_main.py:63-68).

Layouts:
  * an ME MinkowskiConvolution kernel is (kernel_volume, C_in, C_out), the
    port's shape, but ME's kernel region enumerates the FIRST spatial axis
    fastest where the port's offsets enumerate z fastest:
    `me_offset_permutation` gives the reorder (offset_order='z_fastest'
    for a checkpoint saved the other way);
  * BatchNorm (weight, bias, running_mean, running_var) -> SparseBatchNorm
    (scale, bias, mean, var).

Names follow the reference module tree (models/res16unet.py):
conv0p1s1/bn0, conv{k}p*s2/bn{k}, block{k}.{i}.{conv1,norm1,conv2,norm2,
downsample.0/1}, convtr{k}p*s2/bntr{k}, final. Unlike the JAX package's
converter, every key of the checkpoint must be used: an unused key raises,
as a missing one does.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

LAYERS_34 = (2, 3, 4, 6, 2, 2, 2, 2)
PLANES_34C = (32, 64, 128, 256, 256, 128, 96, 96)
_PREFIXES = ("model.", "module.", "backbone.")


def me_offset_permutation(kernel_size: int,
                          offset_order: str = "x_fastest") -> np.ndarray:
    """perm[j] = the index on the ME kernel axis of the port's offset j."""
    ours = list(itertools.product(*([range(kernel_size)] * 3)))  # z fastest
    if offset_order == "x_fastest":
        theirs = [tuple(reversed(t)) for t in ours]
    elif offset_order == "z_fastest":
        theirs = ours
    else:
        raise ValueError(offset_order)
    lookup = {t: i for i, t in enumerate(theirs)}
    return np.asarray([lookup[o] for o in ours], np.int64)


class _Reader:
    """The checkpoint's arrays, recording which keys were read."""

    def __init__(self, sd):
        self.sd = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
                   for k, v in sd.items()}
        self.used = set()

    def __contains__(self, key):
        return key in self.sd

    def __getitem__(self, key):
        if key not in self.sd:
            raise KeyError(f"CSC checkpoint: missing key {key!r}")
        self.used.add(key)
        return self.sd[key].astype(np.float32)


def _strip_prefixes(sd: dict) -> dict:
    for prefix in _PREFIXES:
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def convert_res16unet(state_dict: dict, offset_order: str = "x_fastest"
                      ) -> dict[str, torch.Tensor]:
    """An ME Res16UNet34C state dict (under an optional `model.`, `module.`
    or `backbone.` prefix) -> the state_dict of the port's Res16UNet34C
    (f32 CPU tensors). Raises KeyError on a missing or an unused key."""
    sd = _Reader(_strip_prefixes(dict(state_dict)))
    out = {}

    def conv(ours, theirs, ksize):
        w = sd[f"{theirs}.kernel"]
        if w.ndim == 3:
            w = w[me_offset_permutation(ksize, offset_order)]
        out[f"{ours}.kernel"] = w
        if f"{theirs}.bias" in sd:
            out[f"{ours}.bias"] = sd[f"{theirs}.bias"].reshape(-1)

    def bn(ours, theirs):
        # ME's BatchNorm wrapper nests a `bn`; a plain BatchNorm does not
        src = f"{theirs}.bn" if f"{theirs}.bn.weight" in sd else theirs
        for mine, key in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            out[f"{ours}.{mine}"] = sd[f"{src}.{key}"]
        # torch's BatchNorm counts its updates; the port keeps no count
        sd.used.add(f"{src}.num_batches_tracked")

    conv("conv0p1s1_conv", "conv0p1s1", 3)
    bn("conv0p1s1_bn", "bn0")
    for k in range(1, 5):
        name = f"conv{k}p{2 ** (k - 1)}s2"
        conv(f"{name}_conv", name, 2)
        bn(f"{name}_bn", f"bn{k}")
    for k, stride in zip(range(4, 8), (16, 8, 4, 2)):
        name = f"convtr{k}p{stride}s2"
        conv(f"{name}_conv", name, 2)
        bn(f"{name}_bn", f"bntr{k}")
    for bi, n in enumerate(LAYERS_34, start=1):
        for i in range(n):
            ours, theirs = f"block{bi}_{i}", f"block{bi}.{i}"
            for j in (1, 2):
                conv(f"{ours}.conv{j}", f"{theirs}.conv{j}", 3)
                bn(f"{ours}.norm{j}", f"{theirs}.norm{j}")
            if f"{theirs}.downsample.0.kernel" in sd:
                conv(f"{ours}.downsample_conv", f"{theirs}.downsample.0", 1)
                bn(f"{ours}.downsample_norm", f"{theirs}.downsample.1")
    if "final.kernel" in sd:
        w = sd["final.kernel"]
        out["final.kernel"] = w.reshape(w.shape[-2], w.shape[-1])
        if "final.bias" in sd:
            out["final.bias"] = sd["final.bias"].reshape(-1)

    unused = sorted(set(sd.sd) - sd.used)
    if unused:
        raise KeyError(f"CSC checkpoint: unused keys {unused}")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def load_csc_backbone(path: str, **kwargs) -> dict[str, torch.Tensor]:
    """The port's Res16UNet34C state_dict from a torch CSC checkpoint (a
    state dict, or a dict holding one under `state_dict`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return convert_res16unet(ckpt, **kwargs)




def random_me_state_dict(seed: int = 0,
                         prefix: str = "") -> dict[str, np.ndarray]:
    """Seeded random arrays of a Res16UNet34C (3 inputs, 20 outputs) under
    the reference's ME module names, in ME's layouts (a k3 / k2 kernel
    (volume, C_in, C_out), a k1 kernel (C_in, C_out), BatchNorm nested
    under `bn`): a stand-in for the CSC checkpoint in tests and on the card.
    Kernels are He-scaled so that the 30-layer forward stays finite."""
    layers, planes, in_ch, out_ch = LAYERS_34, PLANES_34C, 3, 20
    r = np.random.RandomState(seed)
    sd = {}

    def conv(name, k, cin, cout, bias=False):
        scale = np.sqrt(2.0 / (k ** 3 * cin))
        shape = (k ** 3, cin, cout) if k > 1 else (cin, cout)
        sd[f"{name}.kernel"] = (r.randn(*shape) * scale).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = (r.randn(cout) * 0.01).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.bn.weight"] = (r.rand(c) + 0.5).astype(np.float32)
        sd[f"{name}.bn.bias"] = (r.randn(c) * 0.1).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = (r.randn(c) * 0.1).astype(np.float32)
        sd[f"{name}.bn.running_var"] = (r.rand(c) + 0.5).astype(np.float32)
        sd[f"{name}.bn.num_batches_tracked"] = np.array(0, np.int64)

    def blocks(k, cin, p):
        for i in range(layers[k - 1]):
            c = cin if i == 0 else p
            for j, cj in ((1, c), (2, p)):
                conv(f"block{k}.{i}.conv{j}", 3, cj, p)
                bn(f"block{k}.{i}.norm{j}", p)
            if c != p:
                conv(f"block{k}.{i}.downsample.0", 1, c, p)
                bn(f"block{k}.{i}.downsample.1", p)

    init = 32
    conv("conv0p1s1", 3, in_ch, init)
    bn("bn0", init)
    inplanes = init
    for k in range(1, 5):
        conv(f"conv{k}p{2 ** (k - 1)}s2", 2, inplanes, inplanes)
        bn(f"bn{k}", inplanes)
        blocks(k, inplanes, planes[k - 1])
        inplanes = planes[k - 1]
    skips = [planes[2], planes[1], planes[0], init]
    for j, (k, stride) in enumerate(zip(range(4, 8), (16, 8, 4, 2))):
        p = planes[4 + j]
        conv(f"convtr{k}p{stride}s2", 2, inplanes, p)
        bn(f"bntr{k}", p)
        blocks(k + 1, p + skips[j], p)
        inplanes = p
    conv("final", 1, planes[7], out_ch, bias=True)
    return {prefix + k: v for k, v in sd.items()}
