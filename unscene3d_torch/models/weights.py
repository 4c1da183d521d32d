"""Weights: the bridge from the JAX package's variables, and seeded random
initialisation.

`torch_state_from_flax` maps the JAX model's `{"params", "batch_stats",
"buffers"}` tree (numpy leaves) to this package's state_dict:
  * sparse-conv kernels and biases, BatchNorm scale/bias/mean/var and the
    `gauss_B` buffer copy as they are (same layouts);
  * flax `Dense` kernels (in, out) are transposed for nn.Linear; LayerNorm
    `scale` becomes `weight`;
  * `DenseGeneral` q/k/v kernels (D, H, dh) and biases (H, dh) are reshaped
    to (H*dh, D) / (H*dh,); out_proj kernels (H, dh, D) to (D, H*dh).
`load_flax_variables` raises on any missing or unused key. It copies into
the model's params as they are stored: an eval model stores them in their
module's compute dtype, so under bf16 the sparse-conv kernels and the
transformer layers' Dense params are rounded once here rather than at every
forward; a training model (train/loop.py, `model.float()`) keeps f32
masters, so the JAX params and batch_stats come across unrounded.
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
            if mods and mods[0] == "backbone" or leaf in ("gauss_B", "mean",
                                                          "var"):
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


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Copy the JAX variables into `model`; raises on missing or unused
    keys and on shape mismatches."""
    state = torch_state_from_flax(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"weight bridge: missing {missing}, unused {unused}")
    for k, v in state.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"weight bridge: {k} has shape {tuple(v.shape)}, "
                             f"model wants {tuple(own[k].shape)}")
    model.load_state_dict(state, strict=True)


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
    normal * gauss_scale. Deterministic for a given seed on any device."""
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
            if hasattr(mod, "gauss_B"):
                mod.gauss_B.copy_(torch.randn(tuple(mod.gauss_B.shape),
                                              generator=gen) * mod.gauss_scale)
    return model
