"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule: the JAX package's ``optim/adamw.py`` on tensors.

Parameters are the model's ``nn.Module``. Gradients and the optimizer state
are dicts keyed by the parameters' names (``named_parameters()``): ``mu`` and
``nu`` hold one f32 tensor per parameter, as the reference's state holds one
leaf per parameter leaf, so ``models/convert.py`` carries them across.
Updates run in place under ``torch.no_grad()``. ``torch.optim.AdamW`` is not
used: its state has another layout, and its schedule and decay are not the
reference's (warmup counts ``step + 1``; every leaf decays, norms and
embeddings included).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.sharding import mesh_reduce, spread


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False   # int8+error-feedback gradient compression
    grad_accum: int = 1            # microbatches per optimizer step


def schedule(oc: OptConfig, step: int) -> float:
    """Learning rate at ``step``: linear warmup from (step+1)/warmup, then a
    cosine from peak to ``min_lr_ratio`` of it."""
    warm = (step + 1.0) / max(oc.warmup_steps, 1)  # step 0 trains
    t = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1)
    t = min(max(t, 0.0), 1.0)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * t))
    return oc.peak_lr * (warm if step < oc.warmup_steps else cos)


def init_opt_state(params: nn.Module) -> dict:
    """{"mu", "nu"}: f32 zeros of each parameter's shape, by its name."""
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for name, p in params.named_parameters()}
    return {"mu": zeros(), "nu": zeros()}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32. Over DTensors on
    more than one rank (gradients in their parameters' Shard / Replicate
    layouts) each rank sums the squares of its local tensors, grouped by the
    mesh dims that shard them, and each group's sum is all-reduced over
    those dims once: a plain f32 scalar, the same on every rank. DTensor's
    own reductions would all-reduce each tensor's sum on some releases."""
    xs = list(tree.values())
    if not any(spread(x) for x in xs):
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in xs))
    groups = {}
    for x in xs:
        local = x.to_local() if isinstance(x, DTensor) else x
        key = ((x.device_mesh, tuple(i for i, p in enumerate(x.placements)
                                     if p.is_shard()))
               if isinstance(x, DTensor) else (None, ()))
        sq = torch.sum(torch.square(local.float()))
        groups[key] = groups[key] + sq if key in groups else sq
    sums = [mesh_reduce(mesh, dims)(sq, "sum") if dims else sq
            for (mesh, dims), sq in groups.items()]
    return torch.sqrt(sum(sums))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(oc: OptConfig, grads: Dict[str, torch.Tensor], opt_state: dict,
                 params: nn.Module, step: int):
    """One AdamW step in place on ``params`` and ``opt_state``; returns
    (params, opt_state, lr)."""
    lr = schedule(oc, step)
    bc1 = 1.0 - oc.b1 ** (step + 1.0)
    bc2 = 1.0 - oc.b2 ** (step + 1.0)
    for name, p in params.named_parameters():
        gf = grads[name].float()
        m, v = opt_state["mu"][name], opt_state["nu"][name]
        m.mul_(oc.b1).add_((1 - oc.b1) * gf)
        v.mul_(oc.b2).add_((1 - oc.b2) * gf * gf)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps) + oc.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, opt_state, lr
