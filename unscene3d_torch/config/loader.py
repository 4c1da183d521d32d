"""Minimal Hydra-compatible config composer (the port's own copy of
unscene3d_tpu/config/loader.py).

It reads the repository's `conf/` as it is: a base yaml with a ``defaults``
list of group entries, group overrides on the CLI (``optimizer=adamw_lower``,
``data/collation_functions=freemask_voxelize_collate``), value overrides
(``general.num_targets=3``), OmegaConf-style interpolation
(``${general.num_targets}``) and ``_target_`` instantiation.

`instantiate` builds the port's objects: a ``_target_`` of
``unscene3d_tpu.X`` names ``unscene3d_torch.X``, and a target that the port
lacks raises ImportError naming it, without importing the JAX module. A
``dtype`` string becomes a torch dtype.
"""

from __future__ import annotations

import copy
import importlib
import os
import re
from typing import Any

import yaml

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_INLINE = re.compile(r"\$\{([^}]+)\}")


class ConfigNode(dict):
    """dict with attribute access."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _to_nodes(obj):
    if isinstance(obj, dict):
        return ConfigNode({k: _to_nodes(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_nodes(v) for v in obj]
    return obj


def _parse_value(s: str):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = ConfigNode()
        node = node[p]
    node[parts[-1]] = _to_nodes(value)


def _load_group(conf_dir: str, group: str, name: str) -> dict:
    """group may contain '/' (e.g. 'data/datasets'). The yaml's content is
    placed under the group's last path segment unless it carries
    '# @package _group_'-style placement -- we emulate Hydra's default of
    placing at the group path."""
    path = os.path.join(conf_dir, group, f"{name}.yaml")
    with open(path) as f:
        content = yaml.safe_load(f) or {}
    return content


def load_config(base: str, overrides: list[str] | None = None,
                conf_dir: str | None = None) -> ConfigNode:
    """base: path to the root yaml (with a ``defaults`` list)."""
    base = os.path.abspath(base)
    conf_dir = conf_dir or os.path.dirname(base)
    with open(base) as f:
        root = yaml.safe_load(f) or {}

    defaults = root.pop("defaults", [])
    overrides = list(overrides or [])

    # group overrides may replace entries of the defaults list
    group_over = {}
    value_over = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"bad override {ov!r}")
        key, val = ov.split("=", 1)
        if "/" in key or (key.count(".") == 0 and _is_group(conf_dir, key)):
            group_over[key.replace(".", "/")] = val
        else:
            value_over.append((key, val))

    cfg: dict = {}
    for entry in defaults:
        if entry == "_self_":
            cfg = _deep_merge(cfg, root)
            continue
        if isinstance(entry, dict):
            (group, name), = entry.items()
        else:
            group, name = entry.split(":") if ":" in entry else (entry, None)
        group = str(group)
        if group in group_over:
            name = group_over.pop(group)
        if name is None:
            continue
        content = _load_group(conf_dir, group, str(name))
        target_path = group.split("/")
        sub: dict = content
        for part in reversed(target_path):
            sub = {part: sub}
        cfg = _deep_merge(cfg, sub)
    if "_self_" not in defaults:
        cfg = _deep_merge(cfg, root)

    # leftover group overrides (groups not in defaults)
    for group, name in group_over.items():
        content = _load_group(conf_dir, group, name)
        sub = content
        for part in reversed(group.split("/")):
            sub = {part: sub}
        cfg = _deep_merge(cfg, sub)

    cfg = _to_nodes(cfg)
    for key, val in value_over:
        _set_path(cfg, key, _parse_value(val))

    _resolve_interpolations(cfg, cfg)
    return cfg


def _is_group(conf_dir: str, key: str) -> bool:
    return os.path.isdir(os.path.join(conf_dir, key))


def _resolve_interpolations(node, root, depth=0):
    if depth > 20:
        raise RecursionError("interpolation cycle")
    if isinstance(node, dict):
        for k, v in list(node.items()):
            node[k] = _resolve_value(v, root, depth)
        return node
    return node


def _resolve_value(v, root, depth):
    if isinstance(v, str):
        m = _INTERP.match(v)
        if m:
            ref = root.get_path(m.group(1))
            return _resolve_value(ref, root, depth + 1)
        if _INTERP_INLINE.search(v):
            return _INTERP_INLINE.sub(
                lambda m: str(_resolve_value(root.get_path(m.group(1)), root, depth + 1)),
                v,
            )
        return v
    if isinstance(v, dict):
        return _resolve_interpolations(v, root, depth)
    if isinstance(v, list):
        return [_resolve_value(x, root, depth) for x in v]
    return v


_JAX_PACKAGE = "unscene3d_tpu"
_PORT_PACKAGE = "unscene3d_torch"


def port_target(target: str) -> str:
    """The port's name for a ``_target_``: ``unscene3d_tpu.X`` ->
    ``unscene3d_torch.X``; any other name stays as it is."""
    head, _, rest = target.partition(".")
    return f"{_PORT_PACKAGE}.{rest}" if head == _JAX_PACKAGE else target


def _resolve_target(target: str):
    name = port_target(target)
    module, cls = name.rsplit(".", 1)
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if not name.startswith(_PORT_PACKAGE + "."):
            raise
        raise ImportError(f"config target {target!r}: the port has no "
                          f"module {module!r}") from e
    if not hasattr(mod, cls):
        raise ImportError(f"config target {target!r}: {module!r} has no "
                          f"{cls!r} in the port")
    return getattr(mod, cls)


def torch_dtype(name: str):
    """'float32' / 'bfloat16' / ... -> the torch dtype of that name."""
    import torch

    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def instantiate(node: dict, **kwargs):
    """Build the object named by ``_target_`` with the node's other keys as
    kwargs (Hydra's instantiate). Nested ``_target_`` nodes are built
    recursively; a list of numbers becomes a tuple (so ``[]`` becomes
    ``()``), as in the JAX package's loader."""
    if not isinstance(node, dict) or "_target_" not in node:
        raise ValueError("node has no _target_")
    node = copy.deepcopy(dict(node))
    fn = _resolve_target(node.pop("_target_"))
    params = {}
    for k, v in node.items():
        if isinstance(v, dict) and "_target_" in v:
            params[k] = instantiate(v)
        elif isinstance(v, list):
            params[k] = tuple(v) if all(isinstance(x, (int, float)) for x in v) else v
        elif k == "dtype" and isinstance(v, str):
            params[k] = torch_dtype(v)
        else:
            params[k] = v
    params.update(kwargs)
    return fn(**params)
