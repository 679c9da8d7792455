"""Weights drawn from the seed, on the device, by the frozen init rules
(``init_rules.json``): one flat buffer in the dtype the cell runs, filled by
a few large normal draws and one uniform draw from a ``torch.Generator``
on the device, each parameter a view into it scaled or set by its rule.
The same seed gives the same tensors, so the reference draws its own copy
after the program's state is freed.

A configuration brings rules for the kinds of parameter the frozen table
lacks in its file's top-level ``init_rules`` object, in the same forms; it
may not name a kind the table already has, so no configuration redraws
an existing kind of parameter."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.harness.spec import PKG, SpecError, load_json

CHUNK = 1 << 30   # elements a draw: large calls, each within 32-bit indexing


def derive(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed and tags, so that the
    weights, the inputs and the sample each have a stream of their own."""
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def rules_for(own: Optional[dict]) -> dict:
    """``init_rules.json``'s rules with a configuration's ``own`` beside
    them; a kind of parameter that both name is refused."""
    rules, own = load_json(PKG / "init_rules.json")["rules"], own or {}
    clash = sorted(set(own) & set(rules))
    if clash:
        raise SpecError(f"init_rules: {clash} already in init_rules.json")
    return {**rules, **own}


def draw(shapes: List[Tuple[str, tuple]], model: dict, dtype: torch.dtype,
         seed: int, device, own_rules: Optional[dict] = None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat buffer, {name: view}) for the parameters ``shapes`` (in that
    order), drawn from ``seed`` by ``init_rules.json`` and the
    configuration's ``own_rules``."""
    rules = rules_for(own_rules)
    total = sum(math.prod(s) for _, s in shapes)
    g = generator(device, derive(seed, 1))
    flat = torch.empty(total, dtype=dtype, device=device)
    for o in range(0, total, CHUNK):
        flat[o:o + CHUNK].normal_(generator=g)
    views, uniform = views_of(flat, shapes), []
    for name, shape in shapes:
        v = views[name]
        rule = rules.get(name.rsplit(".", 1)[-1])
        if rule is None:
            raise KeyError(f"no init rule for {name}")
        if "normal" in rule:
            v.mul_(rule["normal"])
        elif "normal_fan_in" in rule:
            v.mul_(math.prod(shape[:rule["normal_fan_in"]]) ** -0.5)
        elif "const" in rule:
            v.fill_(rule["const"])
        elif "dt_log_uniform" in rule:
            uniform.append(v)
        else:
            raise KeyError(f"unknown init rule {rule} for {name}")
    if uniform:
        s = model["ssm"]
        u = torch.rand(sum(v.numel() for v in uniform), generator=g,
                       device=device, dtype=torch.float32)
        lo, hi = math.log(s["dt_min"]), math.log(s["dt_max"])
        dt = torch.exp(lo + u * (hi - lo))
        bias = dt + torch.log(-torch.expm1(-dt))
        o = 0
        for v in uniform:
            v.copy_(bias[o:o + v.numel()].view(v.shape))
            o += v.numel()
    return flat, views


def lay_into(params, views: Dict[str, torch.Tensor], requires_grad: bool):
    """Put ``views`` into the program's parameter structure (the meta
    modules ``build_model(cfg, "meta").init`` gives), checking that the
    program's names and shapes are the reference's, no more and no fewer."""
    from torch import nn

    have = {n: tuple(p.shape) for n, p in params.named_parameters()}
    want = {n: tuple(v.shape) for n, v in views.items()}
    if have != want:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shape = sorted(n for n in set(have) & set(want) if have[n] != want[n])[:5]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: missing {missing}, extra {extra}, "
                         f"shape {shape}")
    for name, v in views.items():
        mod, _, leaf = name.rpartition(".")
        params.get_submodule(mod)[leaf] = nn.Parameter(v, requires_grad=requires_grad)
    return params


def views_of(flat: torch.Tensor, shapes: List[Tuple[str, tuple]]
             ) -> Dict[str, torch.Tensor]:
    """{name: view} of ``flat`` laid out as ``draw`` lays it."""
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat.narrow(0, off, n).view(shape)
        off += n
    return out
