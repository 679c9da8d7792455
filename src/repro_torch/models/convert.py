"""Carry parameters and train states between the JAX package's pytrees and
the port's modules.

The JAX package stacks every leaf under ``layers`` on a leading ``n_layers``
axis (one ``lax.scan`` over the blocks); the port keeps one module per layer.
Both sides use the same nested key paths, e.g. ``layers/attn/wq`` is
``[L, D, H, Dh]`` in the tree and ``layers[i]["attn"]["wq"]`` ``[D, H, Dh]``
in the port (parameter name ``layers.i.attn.wq``), so the conversion is a
copy and an unstack, never a reshape. The optimizer's ``mu``/``nu`` follow
the parameters' key paths on both sides (``repro_torch.optim``).
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


def _leaf_names(params):
    """(key path in the JAX tree, the port's parameter names) of every leaf:
    one name per layer for a path under ``layers``."""
    for path, _ in _module_leaves(params):
        if path[0] == "layers":
            yield path, [".".join(("layers", str(i)) + path[1:])
                         for i in range(len(params["layers"]))]
        else:
            yield path, [".".join(path)]


def _arrays_by_name(params, tree: dict, what: str):
    """(parameter name, numpy array) of every leaf of ``tree``, a tree with
    the parameters' key paths, ``layers`` leaves unstacked. Raises if its
    paths or shapes are not the parameters'."""
    got = dict(_tree_leaves(tree))
    want = dict(_leaf_names(params))
    if set(got) != set(want):
        raise ValueError(f"{what} tree mismatch: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    for path, names in want.items():
        for i, name in enumerate(names):
            arr = got[path][i] if path[0] == "layers" else got[path]
            shape = tuple(params.get_parameter(name).shape)
            if tuple(arr.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != {shape}")
            yield name, arr


def _f32(arr, device) -> torch.Tensor:
    """A float32 copy of a leaf on ``device``: a numpy array (bfloat16
    leaves may be ml_dtypes arrays) or a tensor on any device, as
    ``checkpoint.CheckpointManager.restore`` returns them. Never a view."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(arr, np.float32)).to(device)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cpu") -> nn.ModuleDict:
    """The port's parameters from the JAX package's parameter tree, given as
    nested dicts of numpy arrays or tensors (bfloat16 leaves widen to
    float32 exactly on the way)."""
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "meta")
    pd = dt(cfg.param_dtype)
    for name, arr in list(_arrays_by_name(params, tree, "parameter")):
        holder, _, key = name.rpartition(".")
        t = _f32(arr, device)
        params.get_submodule(holder)[key] = nn.Parameter(t.to(dtype=pd))
    return params


def named_to_numpy(params, named: dict) -> dict:
    """Tensors keyed by the port's parameter names (parameters, gradients,
    the optimizer's mu or nu) as nested dicts of float32 numpy arrays with
    the JAX tree's key paths, ``layers`` leaves stacked on axis 0."""
    out: dict = {}
    for path, names in _leaf_names(params):
        arrs = [named[n].detach().float().cpu().numpy() for n in names]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs) if path[0] == "layers" else arrs[0]
    return out


def params_to_numpy(params: nn.ModuleDict) -> dict:
    """Inverse of ``params_from_numpy``: nested dicts of float32 numpy arrays
    (bf16 parameters widen exactly), ``layers`` leaves stacked on axis 0."""
    return named_to_numpy(params, dict(params.named_parameters()))


def train_state_from_numpy(cfg: ModelConfig, state: dict, device="cpu") -> dict:
    """The port's train state (``launch.steps.make_train_state``'s layout)
    from the JAX package's, given as nested dicts of numpy arrays or
    tensors: params, opt.mu, opt.nu (f32) and step."""
    params = params_from_numpy(cfg, state["params"], device)
    opt = {k: {name: _f32(arr, device)
               for name, arr in _arrays_by_name(params, state["opt"][k],
                                                f"optimizer {k}")}
           for k in ("mu", "nu")}
    return {"params": params, "opt": opt, "step": int(state["step"])}


def train_state_to_numpy(state: dict) -> dict:
    """Inverse of ``train_state_from_numpy``: the JAX package's layout, with
    ``step`` as an int32 scalar."""
    params = state["params"]
    return {"params": params_to_numpy(params),
            "opt": {k: named_to_numpy(params, state["opt"][k])
                    for k in ("mu", "nu")},
            "step": np.asarray(state["step"], np.int32)}
