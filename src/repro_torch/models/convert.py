"""Carry parameters and train states between the JAX package's pytrees and
the port's modules.

The JAX package stacks every leaf of a layer stack (``layers``; the
encoder-decoder's ``enc_layers`` and ``dec_layers``) on a leading axis of
its depth (one ``lax.scan`` over the blocks); the port keeps one module per
layer, in an ``nn.ModuleList``. Both sides use the same nested key paths,
e.g. ``layers/attn/wq`` is ``[L, D, H, Dh]`` in the tree and
``layers[i]["attn"]["wq"]`` ``[D, H, Dh]`` in the port (parameter name
``layers.i.attn.wq``); an MoE's stacked experts ``layers/moe/w_up`` are
``[L, E, D, F]`` there and ``[E, D, F]`` a layer here. So the conversion is
a copy and an unstack, never a reshape. The optimizer's state (AdamW's
``mu``/``nu``, the compression ``residual``) follows the parameters' key
paths on both sides (``repro_torch.optim``).

The grouping of the port's names into the reference's leaves is
``optim.stacks.leaves``, which the optimizers share. A state whose tensors
are DTensors (``sharding.distribute_state``) is gathered leaf by leaf on the
way out (every rank takes part).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.layers import dt
from repro_torch.optim.stacks import leaves


def _tree_leaves(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _tree_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _leaf_paths(params):
    """(key path in the JAX tree, stacked, the port's names) of every leaf."""
    for key, stacked, names in leaves(n for n, _ in params.named_parameters()):
        yield tuple(key.split(".")), stacked, names


def _arrays_by_name(params, tree: dict, what: str):
    """(parameter name, numpy array) of every leaf of ``tree``, a tree with
    the parameters' key paths, layer stacks unstacked. Raises if its paths
    or shapes are not the parameters'."""
    got = dict(_tree_leaves(tree))
    want = {path: (stacked, names) for path, stacked, names in _leaf_paths(params)}
    if set(got) != set(want):
        raise ValueError(f"{what} tree mismatch: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    for path, (stacked, names) in want.items():
        for i, name in enumerate(names):
            arr = got[path][i] if stacked else got[path]
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
    init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
    params = init(cfg, torch.Generator().manual_seed(0), "meta")
    pd = dt(cfg.param_dtype)
    for name, arr in list(_arrays_by_name(params, tree, "parameter")):
        holder, _, key = name.rpartition(".")
        t = _f32(arr, device)
        params.get_submodule(holder)[key] = nn.Parameter(t.to(dtype=pd))
    return params


def named_to_numpy(params, named: dict) -> dict:
    """Tensors keyed by the port's parameter names (parameters, gradients,
    the optimizer's mu, nu or residual) as nested dicts of float32 numpy
    arrays with the JAX tree's key paths, layer stacks stacked on axis 0."""
    out: dict = {}
    for path, stacked, names in _leaf_paths(params):
        arrs = [_full(named[n]).detach().float().cpu().numpy() for n in names]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs) if stacked else arrs[0]
    return out


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def params_to_numpy(params: nn.ModuleDict) -> dict:
    """Inverse of ``params_from_numpy``: nested dicts of float32 numpy arrays
    (bf16 parameters widen exactly), layer stacks stacked on axis 0."""
    return named_to_numpy(params, dict(params.named_parameters()))


def train_state_from_numpy(cfg: ModelConfig, state: dict, device="cpu") -> dict:
    """The port's train state (``launch.steps.make_train_state``'s layout)
    from the JAX package's, given as nested dicts of numpy arrays or
    tensors: params, opt.mu, opt.nu and, with gradient compression,
    opt.residual (f32), and step."""
    params = params_from_numpy(cfg, state["params"], device)
    opt = {k: {name: _f32(arr, device)
               for name, arr in _arrays_by_name(params, tree, f"optimizer {k}")}
           for k, tree in state["opt"].items()}
    return {"params": params, "opt": opt, "step": int(state["step"])}


def train_state_to_numpy(state: dict) -> dict:
    """Inverse of ``train_state_from_numpy``: the JAX package's layout, with
    ``step`` as an int32 scalar."""
    params = state["params"]
    return {"params": params_to_numpy(params),
            "opt": {k: named_to_numpy(params, named)
                    for k, named in state["opt"].items()},
            "step": np.asarray(state["step"], np.int32)}


def train_state_keys(state: dict) -> dict:
    """The key paths of ``train_state_to_numpy(state)`` with no data (None
    leaves): a template for ``CheckpointManager.restore``, which reads only
    its keys, taken without gathering a distributed state."""
    params = state["params"]

    def tree():
        out: dict = {}
        for path, _, _ in _leaf_paths(params):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = None
        return out

    return {"params": tree(), "opt": {k: tree() for k in state["opt"]},
            "step": None}


def train_state_from_tree(template: dict, state: dict) -> dict:
    """The port's train state from the JAX package's layout (nested dicts of
    tensors on the device they are to live on, as ``restore`` returns
    them), in the structure of the port's state ``template`` (plain or
    distributed; only its module structure, names and dtypes are read).
    Plain tensors: ``sharding.distribute_state`` places them on a mesh."""
    values = {name: arr for name, arr in
              _arrays_by_name(template["params"], state["params"],
                              "parameter")}
    params = shd.replace_params(
        template["params"],
        lambda name, p: _f32(values[name], values[name].device).to(p.dtype))
    opt = {k: {name: _f32(arr, arr.device)
               for name, arr in _arrays_by_name(params, tree, f"optimizer {k}")}
           for k, tree in state["opt"].items()}
    return {"params": params, "opt": opt, "step": int(state["step"])}
