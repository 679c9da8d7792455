"""Uniform Model interface over every architecture family (the JAX
package's registry).

``build_model(cfg, device)`` returns a `Model` whose callables are what the
launcher, the dry-run, tests and ``chip_smoke.py`` need, all on ``device``:

  init(generator) -> params (nn.ModuleDict; nn.ParameterDict for encdec)
  loss(params, batch) -> (scalar, metrics)
  init_cache(batch, cache_len) -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  forward(params, tokens[, frames or patches]) -> (logits, aux)
  input_specs(shape) -> ({name: meta tensor}, cache_len | None)

``forward`` takes the tokens alone for the decoder-only families; the
encoder-decoder takes ``forward(params, tokens, frames)`` (frames [B,T,D],
the stubbed frontend's output), and the VLM optionally
``forward(params, tokens, patches)`` (logits then cover patches + tokens).
The encoder-decoder's ``decode_step`` reads cross K/V that
``encdec.prefill_cross_cache`` wrote into the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ed
from repro_torch.models import lm
from repro_torch.models import zamba2 as z2


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    loss: Callable[[Any, dict], Tuple[torch.Tensor, dict]]
    init_cache: Callable[[int, int], Any]
    decode_step: Callable[[Any, Any, torch.Tensor, int], Tuple[torch.Tensor, Any]]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    input_specs: Callable[[ShapeConfig], Tuple[dict, Optional[int]]]


def _spec(shape, dtype: str) -> torch.Tensor:
    """A batch input's shape and dtype, as a meta tensor (nothing allocated;
    the counterpart of a ``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _lm_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The reference's ``_lm_input_specs``: a decode step takes [B, 1]
    tokens and a cache of ``seq_len``; the train and prefill cells take
    int32 tokens and labels and an f32 mask over ``seq_len`` (the VLM's
    text, after its image patches in ``compute_dtype``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _spec((b, 1), "int32")}, s
    if cfg.family == "vlm":
        n_img = cfg.frontend.n_tokens
        s -= n_img
    specs = {"tokens": _spec((b, s), "int32"),
             "labels": _spec((b, s), "int32"),
             "mask": _spec((b, s), "float32")}
    if cfg.family == "vlm":
        specs["patches"] = _spec((b, n_img, cfg.frontend.embed_dim),
                                 cfg.compute_dtype)
    return specs, None


def _encdec_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The reference's ``_encdec_input_specs``: the stubbed frontend's
    frames [B, T_enc, D] beside the decoder's tokens, labels and mask."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _spec((b, 1), "int32")}, s
    return {"frames": _spec((b, cfg.frontend.n_tokens, cfg.d_model),
                            cfg.compute_dtype),
            "tokens": _spec((b, s), "int32"),
            "labels": _spec((b, s), "int32"),
            "mask": _spec((b, s), "float32")}, None


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
            input_specs=lambda shape: _encdec_input_specs(cfg, shape),
        )
    if cfg.family == "zamba2":   # the published Zamba2 (z2.Zamba2Config)
        return Model(
            cfg=cfg,
            init=lambda gen: z2.init_zamba2(cfg, gen, device),
            loss=lambda p, b: z2.zamba2_loss(cfg, p, b),
            init_cache=lambda batch, cache_len: z2.init_zamba2_cache(
                cfg, batch, cache_len, device),
            decode_step=lambda p, c, t, pos: z2.zamba2_decode_step(
                cfg, p, c, t, pos),
            forward=lambda p, t: z2.zamba2_forward(cfg, p, t),
            input_specs=lambda shape: _lm_input_specs(cfg, shape),
        )
    return Model(
        cfg=cfg,
        init=lambda gen: lm.init_lm(cfg, gen, device),
        loss=lambda p, b: lm.lm_loss(cfg, p, b),
        init_cache=lambda batch, cache_len: lm.init_lm_cache(
            cfg, batch, cache_len, device),
        decode_step=lambda p, c, t, pos: lm.lm_decode_step(cfg, p, c, t, pos),
        forward=lambda p, t, patches=None: _lm_forward(cfg, p, t, patches),
        input_specs=lambda shape: _lm_input_specs(cfg, shape),
    )
