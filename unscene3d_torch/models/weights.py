"""Weights: the bridge from the JAX package's variables, and seeded random
initialisation.

`torch_state_from_flax` maps the JAX model's `{"params", "batch_stats",
"buffers"}` tree (numpy leaves) to this package's state_dict:
  * sparse-conv kernels and biases, BatchNorm scale/bias/mean/var and the
    `gauss_B` buffer copy as they are (same layouts);
  * flax `Dense` kernels (in, out) are transposed for nn.Linear; LayerNorm
    `scale` becomes `weight`;
  * `DenseGeneral` q/k/v kernels (D, H, dh) and biases (H, dh) are reshaped
    to (H*dh, D) / (H*dh,); out_proj kernels (H, dh, D) to (D, H*dh);
  * Mask3D's own params (`query_feat`, `query_pos`, `level_embed`) copy as
    they are; `np_feat_proj_i` becomes `np_feature_projection.i`.
`load_flax_variables` raises on any missing or unused key;
`load_flax_backbone_variables` is the same bridge for a stand-alone backbone
(the CSC feature extractor's). It copies into
the model's params as they are stored: an eval model stores them in their
module's compute dtype, so under bf16 the sparse-conv kernels and the
transformer layers' Dense params are rounded once here rather than at every
forward; a training model (train/loop.py, `model.float()`) keeps f32
masters, so the JAX params and batch_stats come across unrounded.
`load_flax_dino_variables` bridges the JAX DINO ViT (`dino_state_from_flax`:
Dense kernels transposed, the patch conv from HWIO to OIHW), and
`load_flax_lseg_variables` the JAX LSegFeatureNet (`lseg_state_from_flax`:
the same layout changes, BatchNorm `mean` / `var` to `running_mean` /
`running_var`, the transposed convs' kernels as they are).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from unscene3d_torch.models.sparse_modules import SparseBatchNorm, SparseConv
from unscene3d_torch.models.transformer_layers import Dense, LayerNorm

# flax module names -> this package's attribute paths
_RENAMES = [
    (re.compile(r"^query_proj_(\d+)$"), r"query_projection.\1"),
    (re.compile(r"^np_feat_proj_(\d+)$"), r"np_feature_projection.\1"),
    (re.compile(r"^mask_embed_(\d+)$"), r"mask_embed_head.\1"),
    (re.compile(r"^cross_(\d+)_(\d+)$"), r"cross_attention.\1.\2"),
    (re.compile(r"^self_(\d+)_(\d+)$"), r"self_attention.\1.\2"),
    (re.compile(r"^ffn_(\d+)_(\d+)$"), r"ffn.\1.\2"),
    (re.compile(r"^squeeze_(\d+)_(\d+)$"), r"lin_squeeze.\1.\2"),
    (re.compile(r"^LayerNorm_0$"), "norm"),
    (re.compile(r"^MultiheadAttention_0$"), "attn"),
    (re.compile(r"^Dense_0$"), "linear1"),
    (re.compile(r"^Dense_1$"), "linear2"),
]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _rename(part: str) -> str:
    for pat, rep in _RENAMES:
        if pat.match(part):
            return pat.sub(rep, part)
    return part


def torch_state_from_flax(variables) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats", "buffers"} tree of numpy arrays ->
    state_dict of float32 CPU tensors."""
    state = {}
    for coll in ("params", "batch_stats", "buffers"):
        for path, arr in _flatten(variables.get(coll, {})):
            *mods, leaf = path
            names = [_rename(m) for m in mods]
            arr = np.asarray(arr, np.float32)
            if (not mods or mods[0] == "backbone"
                    or leaf in ("gauss_B", "mean", "var")):
                pass                                   # same layout
            elif mods[-1] in ("q_proj", "k_proj", "v_proj"):
                if leaf == "kernel":
                    d = arr.shape[0]
                    arr, leaf = arr.reshape(d, -1).T, "weight"
                else:
                    arr = arr.reshape(-1)
            elif mods[-1] == "out_proj":
                if leaf == "kernel":
                    d = arr.shape[-1]
                    arr, leaf = arr.reshape(-1, d).T, "weight"
            elif leaf == "kernel":                     # flax Dense
                arr, leaf = arr.T, "weight"
            elif leaf == "scale":                      # flax LayerNorm
                leaf = "weight"
            state[".".join(names + [leaf])] = torch.tensor(arr)
    return state


def torch_params_from_flax(params) -> dict[str, torch.Tensor]:
    """A flax-shaped `params` tree (the parameters, or their gradients or
    updates) as {this package's parameter name: f32 tensor}, with the
    layouts of `torch_state_from_flax`; tests compare gradients one to
    one through it."""
    return torch_state_from_flax({"params": params})


def load_state_strict(model: torch.nn.Module, state: dict,
                      what: str = "weight bridge") -> None:
    """`model.load_state_dict(state)`, raising on missing or unused keys and
    on shape mismatches, with `what` in the message."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"{what}: missing {missing}, unused {unused}")
    for k, v in state.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, "
                             f"model wants {tuple(own[k].shape)}")
    model.load_state_dict(state, strict=True)


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Copy the JAX variables into `model`; raises on missing or unused
    keys and on shape mismatches."""
    load_state_strict(model, torch_state_from_flax(variables))


def load_flax_backbone_variables(backbone: torch.nn.Module, variables) -> None:
    """Copy the variables of a stand-alone JAX backbone (`Res16UNet34C(...)
    .init`: `{"params", "batch_stats"}` with the conv and BatchNorm modules
    at the top) into `backbone`; raises on missing or unused keys and on
    shape mismatches, as `load_flax_variables` does."""
    load_flax_variables(_Prefixed(backbone), {
        coll: {"backbone": tree} for coll, tree in variables.items()})


_DINO_MODULES = {"norm1": "norm1", "norm2": "norm2", "attn/qkv": "attn.qkv",
                 "attn/proj": "attn.proj", "mlp_fc1": "mlp.fc1",
                 "mlp_fc2": "mlp.fc2"}


def dino_state_from_flax(variables) -> dict[str, torch.Tensor]:
    """The JAX ViTExtractor's `{"params"}` tree -> the DINO state dict of
    `encoders_2d/dino.py:ViTExtractor`: Dense kernels transposed, the patch
    conv from HWIO to OIHW, LayerNorm `scale` -> `weight`. Raises KeyError
    on a module it does not know."""
    state = {}
    for path, arr in _flatten(variables["params"]):
        *mods, leaf = path
        arr = np.asarray(arr, np.float32)
        if not mods:                                   # cls_token, pos_embed
            name = leaf
        elif mods == ["patch_embed"]:
            if leaf == "kernel":
                arr, leaf = arr.transpose(3, 2, 0, 1), "weight"
            name = f"patch_embed.proj.{leaf}"
        else:
            m = re.fullmatch(r"block_(\d+)", mods[0])
            sub = "/".join(mods[1:])
            if mods == ["norm"]:
                prefix = "norm"
            elif m and sub in _DINO_MODULES:
                prefix = f"blocks.{m.group(1)}.{_DINO_MODULES[sub]}"
            else:
                raise KeyError(f"DINO bridge: unknown module {'/'.join(mods)}")
            if leaf == "kernel":
                arr, leaf = arr.T, "weight"
            elif leaf == "scale":
                leaf = "weight"
            name = f"{prefix}.{leaf}"
        state[name] = torch.tensor(arr)
    return state


def load_flax_dino_variables(vit: torch.nn.Module, variables) -> None:
    """Copy the JAX ViTExtractor's variables into the port's ViTExtractor;
    raises on missing or unused keys and on shape mismatches."""
    load_state_strict(vit, dino_state_from_flax(variables), "DINO bridge")


_LSEG_VIT = {"norm1": "norm1", "norm2": "norm2", "attn/qkv": "attn.qkv",
             "attn/proj": "attn.proj", "mlp_fc1": "mlp.fc1",
             "mlp_fc2": "mlp.fc2"}


def _lseg_name(mods: list[str]) -> str:
    """The port's module path of a JAX LSegFeatureNet module path."""
    top, rest = mods[0], "/".join(mods[1:])
    if top == "vit":
        if rest == "patch_embed":
            return "pretrained.model.patch_embed.proj"
        m = re.fullmatch(r"block_(\d+)/(.+)", rest)
        if m and m.group(2) in _LSEG_VIT:
            return (f"pretrained.model.blocks.{m.group(1)}."
                    f"{_LSEG_VIT[m.group(2)]}")
    m = re.fullmatch(r"post(\d)", top)
    if m:
        idx = {"readout/project": "0.project.0", "conv": "3", "deconv": "4",
               "down": "4"}.get(rest)
        if idx is not None:
            return f"pretrained.act_postprocess{m.group(1)}.{idx}"
    if re.fullmatch(r"layer\d_rn", top) or top == "head1":
        return f"scratch.{top}"
    m = re.fullmatch(r"refinenet(\d)", top)
    if m:
        unit = {"rcu1": "resConfUnit1", "rcu2": "resConfUnit2"}
        parts = [unit.get(p, p) for p in mods[1:]]
        return ".".join([f"scratch.{top}"] + parts)
    raise KeyError(f"LSeg bridge: unknown module {'/'.join(mods)}")


def lseg_state_from_flax(variables) -> dict[str, torch.Tensor]:
    """The JAX LSegFeatureNet's `{"params", "batch_stats"}` tree -> the state
    dict of `encoders_2d/lseg.py:LSegFeatureNet`: Dense kernels transposed,
    conv kernels HWIO -> OIHW, the transposed convs' (Cin, Cout, k, k)
    kernels as they are, LayerNorm / BatchNorm `scale` -> `weight`, the
    BatchNorm statistics -> `running_mean` / `running_var` (with
    `num_batches_tracked` 0). Raises KeyError on a module it does not
    know."""
    state = {}
    for path, arr in _flatten(variables["params"]):
        *mods, leaf = path
        arr = np.asarray(arr, np.float32)
        if mods == ["vit"]:                       # cls_token, pos_embed
            state[f"pretrained.model.{leaf}"] = torch.tensor(arr)
            continue
        name = _lseg_name(mods)
        if leaf == "kernel":
            if arr.ndim == 4 and mods[-1] != "deconv":
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        state[f"{name}.{leaf}"] = torch.tensor(arr)
    for path, arr in _flatten(variables.get("batch_stats", {})):
        *mods, leaf = path
        name = _lseg_name(mods)
        state[f"{name}.running_{leaf}"] = torch.tensor(
            np.asarray(arr, np.float32))
        state[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return state


def load_flax_lseg_variables(net: torch.nn.Module, variables) -> None:
    """Copy the JAX LSegFeatureNet's variables into the port's
    LSegFeatureNet; raises on missing or unused keys and on shape
    mismatches."""
    load_state_strict(net, lseg_state_from_flax(variables), "LSeg bridge")


class _Prefixed(torch.nn.Module):
    """`backbone` under the name it has inside Mask3D, so that the bridge
    reads its kernels as sparse-conv kernels (same layout), not as Dense."""

    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def _trunc_normal(shape, std, gen):
    """Normal(0, std) truncated to +-2 std, by the inverse CDF (as
    flax's truncated_normal initialisers)."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(shape, generator=gen) * (1 - 2 * lo) + lo
    return torch.erfinv(2 * u - 1) * math.sqrt(2) * std


def init_random_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded random weights with the JAX package's initialiser families:
    sparse convs variance_scaling(2, fan_out, truncated normal), Dense
    lecun normal with zero bias, BatchNorm / LayerNorm at identity, gauss_B
    normal * gauss_scale, Mask3D's learned queries and level embeddings
    normal(1). Deterministic for a given seed on any device."""
    gen = torch.Generator().manual_seed(int(seed))
    stddev_fix = 0.87962566103423978   # std of a unit normal cut at +-2
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SparseConv):
                shape = tuple(mod.kernel.shape)
                fan_out = shape[-1] * (shape[0] if len(shape) == 3 else 1)
                std = math.sqrt(2.0 / fan_out) / stddev_fix
                mod.kernel.copy_(_trunc_normal(shape, std, gen))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, SparseBatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
            elif isinstance(mod, Dense):
                fan_in = mod.in_features
                std = math.sqrt(1.0 / fan_in) / stddev_fix
                mod.weight.copy_(_trunc_normal(tuple(mod.weight.shape), std,
                                               gen))
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            for name in ("query_feat", "query_pos", "level_embed"):
                p = getattr(mod, name, None)
                if isinstance(p, torch.nn.Parameter):
                    p.copy_(torch.randn(tuple(p.shape), generator=gen))
            if hasattr(mod, "gauss_B"):
                mod.gauss_B.copy_(torch.randn(tuple(mod.gauss_B.shape),
                                              generator=gen) * mod.gauss_scale)
    return model
