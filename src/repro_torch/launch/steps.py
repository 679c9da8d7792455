"""train_step / serve_step / prefill_step builders shared by the entry points,
the tests and ``chip_smoke.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.registry import Model
from repro_torch.optim import (OptConfig, adamw_update, clip_by_global_norm,
                               init_opt_state)


def _refuse_compression(oc: Optional[OptConfig]):
    if oc is not None and oc.compress_grads:
        raise NotImplementedError(
            "gradient compression (optim/compression.py) is not ported to "
            "repro_torch yet; see ROADMAP.md")


def make_train_state(model: Model, gen: torch.Generator,
                     oc: Optional[OptConfig] = None) -> dict:
    """{"params", "opt": {"mu", "nu"}, "step": 0}; params drawn from ``gen``."""
    _refuse_compression(oc)
    params = model.init(gen)
    return {"params": params, "opt": init_opt_state(params), "step": 0}


def _grads(model: Model, params, batch: dict):
    """(metrics, {name: grad}) of ``model.loss`` at ``params``, by
    ``loss.backward()``; the gradients are taken off the parameters."""
    params.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = model.loss(params, batch)
        loss.backward()
    grads = {}
    for name, p in params.named_parameters():
        grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, oc: OptConfig):
    """(state, batch) -> (state, metrics): gradients (over ``oc.grad_accum``
    equal slices of the batch, averaged in f32, the last slice's loss
    metrics reported, as the reference's scan does), global-norm clipping,
    then AdamW in place. Metrics: loss, ce, aux, tokens, grad_norm, lr."""
    _refuse_compression(oc)

    def train_step(state: dict, batch: dict) -> Tuple[dict, dict]:
        params = state["params"]
        if oc.grad_accum > 1:
            b = batch["tokens"].shape[0]
            if b % oc.grad_accum:
                raise ValueError(f"batch {b} does not split into "
                                 f"{oc.grad_accum} microbatches")
            size = b // oc.grad_accum
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in params.named_parameters()}
            for i in range(oc.grad_accum):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                metrics, g = _grads(model, params, mb)
                for name, gi in g.items():
                    grads[name] += gi.float() / oc.grad_accum
        else:
            metrics, grads = _grads(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, oc.clip_norm)
        _, opt, lr = adamw_update(oc, grads, state["opt"], params, state["step"])
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def make_serve_step(model: Model):
    """One greedy decode step: (params, cache, tokens[B,1], pos) ->
    (next_tokens [B,1], logits [B,1,V], cache)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos: int):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits.argmax(dim=-1), logits, cache

    return serve_step


def make_prefill_step(model: Model):
    """Teacher-forced prefill: ``decode_step`` over the prompt positions in a
    Python loop, carrying the cache.

    Cache-position contract (the JAX package's): ``decode_step`` is strictly
    single-token — ``tokens`` is ``[B, 1]`` and ``pos`` is the absolute
    position of that token, which advances by exactly 1 per call (attention
    reads ``kv_len = pos + 1``). Returns ``prefill(params, cache, prompts[B,
    P]) -> (next_tokens[B, 1], cache)``, where ``next_tokens`` is the greedy
    prediction after the full prompt: what the first decode step consumes.
    """

    @torch.no_grad()
    def prefill(params, cache, prompts):
        nxt = None
        for pos in range(prompts.shape[1]):
            logits, cache = model.decode_step(params, cache,
                                              prompts[:, pos:pos + 1], pos)
            nxt = logits.argmax(dim=-1)
        return nxt, cache

    return prefill
