"""train_step / serve_step / prefill_step builders shared by the entry points,
the dry-run, the tests and ``chip_smoke.py``, and the abstract (meta-device)
states the dry-run places on its mesh.

The train step takes a plain state on one device, or, given the mesh, a
state that ``sharding.distribute_state`` made DTensors: then the batch is
sharded over the batch axes (``sharding.shard_batch``), the activations
follow the reference's ``shard_act`` points, plain tensors the model makes
(RoPE tables, masks, constants) act as replicated, and every reduction
(the loss, the global norm) runs over all shards. The kernels take no
DTensor, so a distributed state trains on the plain paths
(``use_kernels=False``, the training default).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import sharding as shd
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.registry import Model, build_model
from repro_torch.optim import (OptConfig, adamw_update, clip_by_global_norm,
                               init_opt_state)
from repro_torch.optim.compression import compress_with_feedback, init_residual


def make_train_state(model: Model, gen: torch.Generator,
                     oc: Optional[OptConfig] = None) -> dict:
    """{"params", "opt": {"mu", "nu"}, "step": 0}; params drawn from ``gen``.
    With ``oc.compress_grads`` the optimizer state also holds the
    compression's ``residual`` (f32 zeros, by parameter name)."""
    params = model.init(gen)
    state = {"params": params, "opt": init_opt_state(params), "step": 0}
    if oc is not None and oc.compress_grads:
        state["opt"]["residual"] = init_residual(params)
    return state


def abstract_train_state(model: Model) -> dict:
    """The train state of ``model``'s config on the meta device: shapes and
    dtypes, nothing drawn and nothing allocated (the reference's
    ``jax.eval_shape`` of ``make_train_state``)."""
    return make_train_state(build_model(model.cfg, "meta"), torch.Generator())


def abstract_serve_state(model: Model, shape: ShapeConfig):
    """(params, cache) for a decode shape on the meta device: the cache
    holds ``shape.global_batch`` rows of ``input_specs``' cache length."""
    meta = build_model(model.cfg, "meta")
    _, cache_len = meta.input_specs(shape)
    return (meta.init(torch.Generator()),
            meta.init_cache(shape.global_batch, cache_len))


def _grads(model: Model, params, batch: dict):
    """(metrics, {name: grad}) of ``model.loss`` at ``params``, by
    ``loss.backward()``; the gradients are taken off the parameters."""
    params.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = model.loss(params, batch)
        loss.backward()
    grads = {}
    for name, p in params.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        grads[name] = g
        p.grad = None
    return {k: _full(v.detach()) for k, v in metrics.items()}, grads


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _on_full(fn: Callable, *named: Dict[str, torch.Tensor]):
    """``fn`` of dicts of tensors, run on full tensors where they are
    DTensors (every rank computes the same result), its dict outputs put
    back on the first input's placements."""
    like = named[0]
    outs = fn(*[{k: _full(v) for k, v in d.items()} for d in named])

    def back(d):
        return {k: (distribute_tensor(v, like[k].device_mesh,
                                      like[k].placements, src_data_rank=None)
                    if isinstance(like[k], DTensor) else v)
                for k, v in d.items()}

    return tuple(back(d) for d in outs)


def make_train_step(model: Model, oc: OptConfig, mesh=None):
    """(state, batch) -> (state, metrics): gradients (over ``oc.grad_accum``
    equal slices of the batch, averaged in f32, the last slice's loss
    metrics reported, as the reference's scan does); with
    ``oc.compress_grads`` int8 compression with error feedback (the
    quantized gradients are what a bandwidth-starved axis would all-reduce;
    the residual carries the error to the next step); global-norm clipping;
    then AdamW in place. Metrics: loss, ce, aux, tokens, grad_norm, lr
    (full tensors). With ``mesh`` the state must be distributed on it, and
    a plain batch (the global batch, the same on every rank) is sharded
    over the batch axes first."""

    def train_step(state: dict, batch: dict) -> Tuple[dict, dict]:
        if mesh is None:
            return _step(state, batch)
        batch = shd.shard_batch(batch, mesh)
        with shd.use_sharding_rules(mesh), implicit_replication():
            return _step(state, batch)

    def _step(state: dict, batch: dict) -> Tuple[dict, dict]:
        params = state["params"]
        if oc.grad_accum > 1:
            b = batch["tokens"].shape[0]
            if b % oc.grad_accum:
                raise ValueError(f"batch {b} does not split into "
                                 f"{oc.grad_accum} microbatches")
            size = b // oc.grad_accum
            grads = {name: torch.zeros_like(p, dtype=torch.float32)
                     for name, p in params.named_parameters()}
            for i in range(oc.grad_accum):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                metrics, g = _grads(model, params, mb)
                for name, gi in g.items():
                    grads[name] += gi.float() / oc.grad_accum
        else:
            metrics, grads = _grads(model, params, batch)
        opt = dict(state["opt"])
        if oc.compress_grads:
            grads, residual = _on_full(compress_with_feedback, grads,
                                       opt.pop("residual"))
        grads, gnorm = clip_by_global_norm(grads, oc.clip_norm)
        gnorm = _full(gnorm)
        _, opt, lr = adamw_update(oc, grads, opt, params, state["step"])
        if oc.compress_grads:
            opt["residual"] = residual
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def make_serve_step(model: Model, mesh=None):
    """One greedy decode step: (params, cache, tokens[B,1], pos) ->
    (next_tokens [B,1], logits [B,1,V], cache).

    With ``mesh`` the params must be distributed on it
    (``sharding.distribute_params``) and the cache too
    (``sharding.distribute_cache``, the reference's cache rules); plain
    tokens (the global batch) are sharded over the batch axes, and the
    logits come out sharded ``[batch axes, None, "model"]`` as the
    reference's decode cells lay them out (``fit_spec``); the next tokens
    keep the batch sharding."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos: int):
        if mesh is None:
            logits, cache = model.decode_step(params, cache, tokens, pos)
            return logits.argmax(dim=-1), logits, cache
        tokens = shd.shard_batch({"tokens": tokens}, mesh)["tokens"]
        with shd.use_sharding_rules(mesh), implicit_replication():
            logits, cache = model.decode_step(params, cache, tokens, pos)
            batch = shd.batch_axes(mesh, logits.shape[0])
            spec = shd.fit_spec(mesh, [batch, None, "model"], logits.shape)
            logits = logits.redistribute(mesh, shd.placements(mesh, spec))
            # the greedy pick over the vocab shards, none gathered
            return shd.argmax_sharded(logits), logits, cache

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
