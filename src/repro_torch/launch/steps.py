"""serve_step / prefill_step builders shared by the serve entry point, the tests
and ``chip_smoke.py``. Training steps are not ported yet (ROADMAP.md)."""

from __future__ import annotations

import torch

from repro_torch.models.registry import Model


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
