"""Adafactor (Shazeer & Stern, 2018) with factored second moments: the JAX
package's ``optim/adafactor.py`` on tensors.

For a parameter of rank >= 2, [..., n, m], the second moment is kept as a
row factor [..., n] and a column factor [..., m] instead of n·m entries;
vectors keep a full one. Implemented subset, as in the reference: update
clipping by RMS, no first moment, relative step sizing off (the caller
passes the learning rate, e.g. ``optim.schedule``).

Parameters are the model's ``nn.Module`` and gradients are keyed by the
parameters' names. The update is the reference's on its leaves
(``optim.stacks.leaves``: the layers of a stack stacked on axis 0), and
the state is keyed by leaf (``{"v": {"layers.attn.wq": {"vr", "vc"},
"embed.table": ...}}``, a vector's ``{"v"}``). A stack of matrices is
never stacked: its factors are the layers' own (slice i of the leaf's
``vr``/``vc``), and the RMS clip of the whole leaf sums the layers'
squares in a first pass and scales in a second, which recomputes each
layer's update rather than keep them all. Only a stack of vectors (a norm
scale [L, D], factored across the layers) is stacked, which is small.
Parameters are written back in place under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from repro_torch.optim.stacks import gather, leaves, scatter


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8          # \hat{beta2}_t = 1 - t^{-decay}
    eps: float = 1e-30
    clip_threshold: float = 1.0
    beta1: float = 0.0          # 0 => no first moment (max memory savings)
    weight_decay: float = 0.0


def _factored(shape) -> bool:
    return len(shape) >= 2


def _leaf_shapes(params: nn.Module):
    """(leaf key, stacked, names, the leaf's shape) of every leaf."""
    named = dict(params.named_parameters())
    for key, stacked, names in leaves(named):
        shape = named[names[0]].shape
        yield key, stacked, names, ((len(names), *shape) if stacked else shape)


def init_adafactor_state(params: nn.Module) -> dict:
    device = next(params.parameters()).device

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    state = {}
    for key, _, _, shape in _leaf_shapes(params):
        state[key] = ({"vr": zeros(shape[:-1]),
                       "vc": zeros(shape[:-2] + shape[-1:])}
                      if _factored(shape) else {"v": zeros(shape)})
    return {"v": state}


def _second_moment(v: dict, gf: torch.Tensor, ac: AdafactorConfig,
                   beta2: float):
    """One tensor's second moment (its factors, or all of it) updated in
    place with the gradient ``gf``."""
    g2 = gf * gf + ac.eps
    if "vr" in v:
        v["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
        v["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
    else:
        v["v"].mul_(beta2).add_((1 - beta2) * g2)


def _scaled(v: dict, gf: torch.Tensor, ac: AdafactorConfig) -> torch.Tensor:
    """``gf`` over the square root of its second moment; a factored one is
    the rank-1 reconstruction from its factors."""
    if "vr" in v:
        vr, vc = v["vr"], v["vc"]
        denom = ((vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                   min=ac.eps))[..., None] * vc[..., None, :])
        return gf / torch.sqrt(torch.clamp(denom, min=ac.eps))
    return gf / torch.sqrt(torch.clamp(v["v"], min=ac.eps))


@torch.no_grad()
def adafactor_update(ac: AdafactorConfig, grads: Dict[str, torch.Tensor],
                     opt_state: dict, params: nn.Module, step: int, lr: float):
    """One step in place on ``params`` and ``opt_state``; returns (params,
    opt_state)."""
    t = step + 1.0
    beta2 = 1.0 - t ** (-ac.decay)
    named = dict(params.named_parameters())
    for key, stacked, names in leaves(named):
        v = opt_state["v"][key]
        by_layer = stacked and named[names[0]].dim() >= 2
        if by_layer:   # (parameter, gradient, the layer's slice of the state)
            parts = [(named[n], grads[n], {k: x[i] for k, x in v.items()})
                     for i, n in enumerate(names)]
        else:
            parts = [(gather(named, stacked, names),
                      gather(grads, stacked, names), v)]
        sumsq = 0.0
        for _, g, vi in parts:
            _second_moment(vi, g.float(), ac, beta2)
            sumsq = sumsq + torch.sum(torch.square(_scaled(vi, g.float(), ac)))
        # update clipping by the RMS of the whole leaf (the Adafactor
        # stabilizer)
        n = sum(p.numel() for p, _, _ in parts)
        clip = torch.clamp(torch.sqrt(sumsq / n) / ac.clip_threshold, min=1.0)
        for p, g, vi in parts:
            update = _scaled(vi, g.float(), ac) / clip
            if ac.weight_decay:
                update = update + ac.weight_decay * p.float()
            new = (p.float() - lr * update).to(p.dtype)
            if by_layer:
                p.copy_(new)
            else:
                for name, t_new in scatter(new, stacked, names).items():
                    named[name].copy_(t_new)
    return params, opt_state


def state_bytes(params: nn.Module, *, adam: bool) -> int:
    """Optimizer state footprint comparison (for the capacity analysis),
    counted over the reference's leaves as the reference counts it."""
    total = 0
    for _, _, _, shape in _leaf_shapes(params):
        n = math.prod(shape)
        if adam:
            total += 2 * 4 * n                      # mu + nu f32
        elif _factored(shape):
            total += 4 * (n // shape[-1] + shape[-1])   # vr + vc
        else:
            total += 4 * n
    return total
