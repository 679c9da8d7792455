"""Plain reference of the training step's optimizer: clipping by the global
norm, then AdamW with decoupled weight decay under a linear warmup and a
cosine schedule, every leaf decayed (norms and embeddings included), as the
configuration's optimizer is stated in the traffic file. Float32 throughout;
it imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict

import torch


def schedule(o: dict, step: int) -> float:
    """Learning rate at ``step`` (0-based): warmup from (step + 1) / warmup,
    then a cosine from the peak down to ``min_lr_ratio`` of it."""
    if step < o["warmup_steps"]:
        return o["peak_lr"] * (step + 1.0) / max(o["warmup_steps"], 1)
    t = (step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1)
    t = min(max(t, 0.0), 1.0)
    r = o["min_lr_ratio"]
    return o["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def clip(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


@torch.no_grad()
def step(o: dict, params: Dict[str, torch.Tensor], grads, mu, nu, k: int):
    """AdamW step ``k`` (0-based) in place on ``params``, ``mu`` and ``nu``."""
    lr = schedule(o, k)
    bc1, bc2 = 1.0 - o["b1"] ** (k + 1.0), 1.0 - o["b2"] ** (k + 1.0)
    for name, p in params.items():
        g = grads[name].float()
        mu[name].mul_(o["b1"]).add_((1 - o["b1"]) * g)
        nu[name].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
        delta = ((mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + o["eps"])
                 + o["weight_decay"] * p)
        p.sub_(lr * delta)
