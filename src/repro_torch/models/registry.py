"""Uniform Model interface over every architecture family (the JAX
package's registry without ``input_specs``, which serves its dry-run).

``build_model(cfg, device)`` returns a `Model` whose callables are what the
launcher, tests and ``chip_smoke.py`` need, all on ``device``:

  init(generator) -> params (nn.ModuleDict; nn.ParameterDict for encdec)
  loss(params, batch) -> (scalar, metrics)
  init_cache(batch, cache_len) -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  forward(params, tokens[, frames or patches]) -> (logits, aux)

``forward`` takes the tokens alone for the decoder-only families; the
encoder-decoder takes ``forward(params, tokens, frames)`` (frames [B,T,D],
the stubbed frontend's output), and the VLM optionally
``forward(params, tokens, patches)`` (logits then cover patches + tokens).
The encoder-decoder's ``decode_step`` reads cross K/V that
``encdec.prefill_cross_cache`` wrote into the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    loss: Callable[[Any, dict], Tuple[torch.Tensor, dict]]
    init_cache: Callable[[int, int], Any]
    decode_step: Callable[[Any, Any, torch.Tensor, int], Tuple[torch.Tensor, Any]]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _lm_forward(cfg: ModelConfig, params, tokens, patches):
    return lm.lm_forward(
        cfg, params, tokens, extra_embed=patches,
        prefix_len=None if patches is None else patches.shape[1])


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    device = torch.device(device)
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen: ed.init_encdec(cfg, gen, device),
            loss=lambda p, b: ed.encdec_loss(cfg, p, b),
            init_cache=lambda batch, cache_len: ed.init_encdec_cache(
                cfg, batch, cache_len, device),
            decode_step=lambda p, c, t, pos: ed.encdec_decode_step(
                cfg, p, c, t, pos),
            forward=lambda p, t, frames: ed.encdec_forward(cfg, p, t, frames),
        )
    return Model(
        cfg=cfg,
        init=lambda gen: lm.init_lm(cfg, gen, device),
        loss=lambda p, b: lm.lm_loss(cfg, p, b),
        init_cache=lambda batch, cache_len: lm.init_lm_cache(
            cfg, batch, cache_len, device),
        decode_step=lambda p, c, t, pos: lm.lm_decode_step(cfg, p, c, t, pos),
        forward=lambda p, t, patches=None: _lm_forward(cfg, p, t, patches),
    )
