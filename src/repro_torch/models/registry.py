"""Uniform Model interface (the LM half of the JAX package's registry).

``build_model(cfg, device)`` returns a `Model` whose callables are what the
launcher, tests and ``chip_smoke.py`` need, all on ``device``:

  init(generator) -> params (nn.ModuleDict)
  loss(params, batch) -> (scalar, metrics)
  init_cache(batch, cache_len) -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  forward(params, tokens) -> (logits, aux)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    loss: Callable[[Any, dict], Tuple[torch.Tensor, dict]]
    init_cache: Callable[[int, int], Any]
    decode_step: Callable[[Any, Any, torch.Tensor, int], Tuple[torch.Tensor, Any]]
    forward: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family is not ported to repro_torch yet; "
            "see ROADMAP.md")
    device = torch.device(device)
    return Model(
        cfg=cfg,
        init=lambda gen: lm.init_lm(cfg, gen, device),
        loss=lambda p, b: lm.lm_loss(cfg, p, b),
        init_cache=lambda batch, cache_len: lm.init_lm_cache(
            cfg, batch, cache_len, device),
        decode_step=lambda p, c, t, pos: lm.lm_decode_step(cfg, p, c, t, pos),
        forward=lambda p, t: lm.lm_forward(cfg, p, t),
    )
