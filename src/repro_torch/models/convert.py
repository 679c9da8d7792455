"""Carry parameters between the JAX package's pytree and the port's modules.

The JAX package stacks every leaf under ``layers`` on a leading ``n_layers``
axis (one ``lax.scan`` over the blocks); the port keeps one module per layer.
Both sides use the same nested key paths, e.g. ``layers/attn/wq`` is
``[L, D, H, Dh]`` in the tree and ``layers[i]["attn"]["wq"]`` ``[D, H, Dh]``
in the port, so the conversion is a copy and an unstack, never a reshape.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.layers import dt


def _tree_leaves(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _tree_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _module_leaves(mod, prefix=()):
    """(path, parameter) of an LM's modules; ``layers`` paths are read from
    layer 0 and carry no layer index."""
    for key, val in mod.items():
        if isinstance(val, nn.ParameterDict):
            for name, t in val.items():
                yield prefix + (key, name), t
        elif isinstance(val, nn.ModuleList):
            yield from _module_leaves(val[0], prefix + (key,))
        else:
            yield from _module_leaves(val, prefix + (key,))


def _set(mod, path, arr, device, dtype):
    holder = mod
    for key in path[:-1]:
        holder = holder[key]
    want = tuple(holder[path[-1]].shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)} != {want}")
    t = torch.tensor(np.asarray(arr, np.float32))  # a copy, never a view
    holder[path[-1]] = nn.Parameter(t.to(device=device, dtype=dtype))


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cpu") -> nn.ModuleDict:
    """The port's parameters from the JAX package's parameter tree, given as
    nested dicts of numpy arrays (bfloat16 leaves may be ml_dtypes arrays;
    they widen to float32 exactly on the way)."""
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "meta")
    want = {path for path, _ in _module_leaves(params)}
    got = dict(_tree_leaves(tree))
    if set(got) != want:
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(want - set(got))}, unexpected "
                         f"{sorted(set(got) - want)}")
    pd = dt(cfg.param_dtype)
    for path, arr in got.items():
        if path[0] == "layers":
            for i, layer in enumerate(params["layers"]):
                _set(layer, path[1:], arr[i], device, pd)
        else:
            _set(params, path, arr, device, pd)
    return params


def params_to_numpy(params: nn.ModuleDict) -> dict:
    """Inverse of ``params_from_numpy``: nested dicts of float32 numpy arrays
    (bf16 parameters widen exactly), ``layers`` leaves stacked on axis 0."""
    out: dict = {}
    for path, _ in _module_leaves(params):
        if path[0] == "layers":
            per_layer = []
            for layer in params["layers"]:
                t = layer
                for key in path[1:]:
                    t = t[key]
                per_layer.append(t.detach().float().cpu().numpy())
            arr = np.stack(per_layer)
        else:
            t = params
            for key in path:
                t = t[key]
            arr = t.detach().float().cpu().numpy()
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return out
