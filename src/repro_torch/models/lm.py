"""Decoder-only LM assembly: dense / MoE / VLM / RWKV-6 / Zamba2-hybrid
families.

The blocks are an ``nn.ModuleList`` run in a Python loop (PyTorch runs
eagerly, so the JAX package's layer scan has no counterpart here); the
hybrid runs groups of ``attn_every`` Mamba-2 layers, each followed by the
one shared attention block, then the tail layers. The VLM is the dense
block under the gemma convention (embeddings scaled by sqrt(d_model)) with
projected image patches prepended as a bidirectional prefix.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as r6
from repro_torch.models.layers import remat as _remat
from repro_torch.runtime.spans import span
from repro_torch.sharding import shard_act


# ---------------------------------------------------------------------------
# Per-family blocks and their decode twins
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, gen, device) -> nn.ModuleDict:
    hd = cfg.resolved_head_dim
    return nn.ModuleDict({
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "attn": attn.init_attention(cfg, gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, hd, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
        "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, device),
    })


def init_block(cfg: ModelConfig, gen, device) -> nn.ModuleDict:
    if cfg.family in ("dense", "vlm"):
        return _attn_block(cfg, gen, device)
    if cfg.family == "moe":
        hd = cfg.resolved_head_dim
        return nn.ModuleDict({
            "ln1": L.init_norm(cfg, cfg.d_model, device),
            "attn": attn.init_attention(cfg, gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, hd, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device),
            "moe": moe_mod.init_moe(cfg, gen, device),
        })
    if cfg.family == "ssm":  # rwkv6
        return nn.ModuleDict({
            "ln1": L.init_norm(cfg, cfg.d_model, device),
            "rwkv": r6.init_rwkv_time_mix(cfg, gen, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device),
            "cmix": r6.init_rwkv_channel_mix(cfg, gen, device),
        })
    if cfg.family == "hybrid":  # zamba2 mamba layer
        return nn.ModuleDict({
            "ln": L.init_norm(cfg, cfg.d_model, device),
            "ssm": m2.init_mamba2(cfg, gen, device),
        })
    raise ValueError(cfg.family)


def init_shared_attn(cfg: ModelConfig, gen, device) -> nn.ModuleDict:
    """Zamba2's shared transformer block (one param set, applied periodically)."""
    return _attn_block(cfg, gen, device)


def block_fwd(cfg: ModelConfig, p, x, *, prefix_len=None):
    """Returns (x, aux_loss); aux_loss is None but for the MoE."""
    aux = None
    if cfg.family in ("dense", "vlm"):  # the layout of zamba2's shared block
        x = shared_attn_fwd(cfg, p, x, prefix_len=prefix_len)
    elif cfg.family == "moe":
        x = x + attn.self_attention(cfg, p["attn"], L.norm(cfg, p["ln1"], x),
                                    causal=True)
        y, aux = moe_mod.moe_ffn(cfg, p["moe"], L.norm(cfg, p["ln2"], x))
        x = x + y
    elif cfg.family == "ssm":
        x = x + r6.rwkv_time_mix(cfg, p["rwkv"], L.norm(cfg, p["ln1"], x))
        x = x + r6.rwkv_channel_mix(cfg, p["cmix"], L.norm(cfg, p["ln2"], x))
    elif cfg.family == "hybrid":
        x = x + m2.mamba2_block(cfg, p["ssm"], L.norm(cfg, p["ln"], x))
    else:
        raise ValueError(cfg.family)
    return x, aux


def shared_attn_fwd(cfg: ModelConfig, p, x, *, prefix_len=None):
    x = x + attn.self_attention(cfg, p["attn"], L.norm(cfg, p["ln1"], x),
                                causal=True, prefix_len=prefix_len)
    return x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["ln2"], x))


def block_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """Returns (x, cache): the layer's cache tensors, new or updated."""
    c = cache["cache"]
    if cfg.family in ("dense", "vlm"):
        x, c = shared_attn_decode(cfg, p, x, c, pos)
    elif cfg.family == "moe":
        y, c = attn.decode_self_attention(cfg, p["attn"],
                                          L.norm(cfg, p["ln1"], x), c, pos)
        x = x + y
        y, _ = moe_mod.moe_ffn(cfg, p["moe"], L.norm(cfg, p["ln2"], x))
        x = x + y
    elif cfg.family == "ssm":
        xn = L.norm(cfg, p["ln1"], x)
        y, tc = r6.rwkv_time_mix_decode(cfg, p["rwkv"], xn,
                                        {"shift_state": c["shift_state"],
                                         "wkv_state": c["wkv_state"]})
        x = x + y
        xn2 = L.norm(cfg, p["ln2"], x)
        x = x + r6.rwkv_channel_mix(cfg, p["cmix"], xn2,
                                    shift_state=c["cmix_shift_state"])
        c = {"shift_state": tc["shift_state"], "wkv_state": tc["wkv_state"],
             "cmix_shift_state": xn2[:, 0]}
    elif cfg.family == "hybrid":
        y, c = m2.mamba2_block_decode(cfg, p["ssm"], L.norm(cfg, p["ln"], x), c)
        x = x + y
    else:
        raise ValueError(cfg.family)
    return x, {"cache": c}


def shared_attn_decode(cfg: ModelConfig, p, x, kv_cache, pos: int):
    y, kv_cache = attn.decode_self_attention(cfg, p["attn"],
                                             L.norm(cfg, p["ln1"], x),
                                             kv_cache, pos)
    x = x + y
    x = x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["ln2"], x))
    return x, kv_cache


def init_block_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """One layer's decode cache, as the JAX package lays it out."""
    cd = L.dt(cfg.compute_dtype)
    if cfg.family in ("dense", "vlm", "moe"):
        return {"cache": attn.init_decode_cache(
            cfg, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim,
            device=device)}
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.ssm.head_dim
        k = cfg.ssm.head_dim
        return {"cache": {
            "shift_state": torch.zeros((batch, cfg.d_model), dtype=cd, device=device),
            "cmix_shift_state": torch.zeros((batch, cfg.d_model), dtype=cd,
                                            device=device),
            "wkv_state": torch.zeros((batch, h, k, k), device=device),
        }}
    if cfg.family == "hybrid":
        _, n_heads, conv_dim = m2._dims(cfg)
        return {"cache": {
            "conv_state": torch.zeros((batch, cfg.ssm.conv_kernel - 1, conv_dim),
                                      dtype=cd, device=device),
            "ssm_state": torch.zeros((batch, n_heads, cfg.ssm.head_dim,
                                      cfg.ssm.state_dim), device=device),
        }}
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Whole-model init / forward / decode
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> nn.ModuleDict:
    """Parameters with the JAX package's names and shapes, drawn from ``gen``
    with the same distributions and scales (not the same numbers)."""
    params = nn.ModuleDict({
        "embed": L.init_embed(cfg, gen, cfg.vocab_size, cfg.d_model, device),
        "layers": nn.ModuleList(
            [init_block(cfg, gen, device) for _ in range(cfg.n_layers)]),
        "final_norm": L.init_norm(cfg, cfg.d_model, device),
    })
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_unembed(cfg, gen, cfg.d_model,
                                           cfg.vocab_size, device)
    if cfg.family == "hybrid" and cfg.attn_every:
        params["shared_attn"] = init_shared_attn(cfg, gen, device)
    if cfg.family == "vlm" and cfg.frontend is not None:
        params["img_proj"] = nn.ParameterDict({"kernel": L._normal(
            gen, (cfg.frontend.embed_dim, cfg.d_model),
            cfg.frontend.embed_dim ** -0.5, L.dt(cfg.param_dtype), device)})
    return params


def _hybrid_groups(cfg: ModelConfig):
    """(full groups of ``attn_every`` layers, tail layers) of the hybrid."""
    k = cfg.attn_every
    full = cfg.n_layers // k if k else 0
    tail = cfg.n_layers - full * k if k else cfg.n_layers
    return full, tail


def _scan_blocks(cfg: ModelConfig, layers, x, *, prefix_len=None):
    """The homogeneous block stack, each block under ``cfg.remat``:
    (x, the blocks' summed aux loss)."""
    blk = _remat(cfg.remat, functools.partial(block_fwd, cfg,
                                              prefix_len=prefix_len))
    aux = torch.zeros((), device=x.device)
    for lp in layers:
        with span("lm.block"):
            x, a = blk(lp, x)
        if a is not None:
            aux = aux + a
    return x, aux


def _hybrid_fwd(cfg: ModelConfig, params, x):
    """Zamba2: groups of `attn_every` mamba layers + shared attention block,
    then the tail layers; each Mamba block and each application of the
    shared block under ``cfg.remat``."""
    full, _ = _hybrid_groups(cfg)
    k = cfg.attn_every
    layers = params["layers"]
    blk = _remat(cfg.remat, functools.partial(block_fwd, cfg))
    if full:
        shared = _remat(cfg.remat, functools.partial(
            shared_attn_fwd, cfg, params["shared_attn"]))
    for g in range(full):
        for lp in layers[g * k:(g + 1) * k]:
            with span("lm.block"):
                x, _ = blk(lp, x)
        with span("lm.block"):
            x = shared(x)
    for lp in layers[full * k:]:
        with span("lm.block"):
            x, _ = blk(lp, x)
    return x


def _head(cfg: ModelConfig, params, x):
    x = L.norm(cfg, params["final_norm"], x)
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    head = None if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(cfg, head, x, tied_table=tied)


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = L.embed(cfg, params["embed"], tokens)
    if cfg.family == "vlm":  # gemma convention
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
               extra_embed: Optional[torch.Tensor] = None,
               prefix_len: Optional[int] = None):
    """tokens: [B,S] -> (logits [B,S,V] f32, aux_loss). ``extra_embed``
    (the VLM's image patches [B,N,E]) is projected and prepended, so the
    logits cover N + S positions; ``prefix_len`` makes attention
    bidirectional over the first positions, which keeps those calls off the
    flash kernel (it has no prefix mask), as in the reference."""
    with span("lm.forward"):
        with span("lm.embed"):
            x = _embed(cfg, params, tokens)
            if extra_embed is not None:
                proj = (extra_embed.to(x.dtype)
                        @ params["img_proj"]["kernel"].to(x.dtype))
                x = torch.cat([proj, x], dim=1)
        x = shard_act(x, "batch", None, "model", kind="resid")
        if cfg.family == "hybrid":
            aux = torch.zeros((), device=x.device)
            x = _hybrid_fwd(cfg, params, x)
        else:
            x, aux = _scan_blocks(cfg, params["layers"], x,
                                  prefix_len=prefix_len)
        with span("lm.head"):
            return _head(cfg, params, x), aux


def lm_loss(cfg: ModelConfig, params, batch: dict):
    """batch: {tokens [B,S], labels [B,S], mask [B,S], patches [B,N,E] (VLM,
    optional)} -> (loss, metrics); with patches, the loss is over the text
    positions only."""
    extra = batch.get("patches")
    logits, aux = lm_forward(
        cfg, params, batch["tokens"], extra_embed=extra,
        prefix_len=(extra.shape[1] if extra is not None else None))
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, device=labels.device)
    ll = L.log_likelihood(logits, labels)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    loss = ce + aux
    metrics = {"loss": loss, "ce": ce, "aux": aux, "tokens": mask.sum()}
    return loss, metrics


def _stacked(one: dict, n: int) -> dict:
    return {name: t.new_zeros((n, *t.shape)) for name, t in one.items()}


def init_lm_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Decode caches stacked over layers, as the JAX package lays them out:
    {"layers": {"cache": {name: [L, ...]}}} (dense: k/v [L,B,T,Kv,Dh]; ssm:
    shift_state, cmix_shift_state, wkv_state; hybrid: conv_state, ssm_state)
    and, for the hybrid, {"shared_attn": {"k"/"v": [G,B,T,Kv,Dh]}} over its
    G full groups."""
    one = init_block_cache(cfg, batch, cache_len, device)["cache"]
    out = {"layers": {"cache": _stacked(one, cfg.n_layers)}}
    if cfg.family == "hybrid" and cfg.attn_every:
        full, _ = _hybrid_groups(cfg)
        kv = attn.init_decode_cache(cfg, batch, cache_len, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, device=device)
        out["shared_attn"] = _stacked(kv, full)
    return out


def _decode_layer(cfg: ModelConfig, lp, x, stacked: dict, i: int, pos: int):
    """One layer's decode step against slice ``i`` of the stacked cache; the
    slice is updated in place (attention writes its slice itself, the
    recurrent families return new states that are copied in)."""
    c = {name: t[i] for name, t in stacked.items()}
    x, new = block_decode(cfg, lp, x, {"cache": c}, pos)
    for name, t in new["cache"].items():
        if t is not c[name]:
            c[name].copy_(t)
    return x


def lm_decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor,
                   pos: int):
    """One decode step. tokens: [B,1]; pos: int -> (logits [B,1,V], cache).
    Each layer's slice of the stacked cache is updated in place."""
    x = _embed(cfg, params, tokens)
    stacked = cache["layers"]["cache"]
    if cfg.family == "hybrid":
        full, _ = _hybrid_groups(cfg)
        k = cfg.attn_every
        sa = cache.get("shared_attn")
        for g in range(full):
            for i in range(g * k, (g + 1) * k):
                x = _decode_layer(cfg, params["layers"][i], x, stacked, i, pos)
            x, _ = shared_attn_decode(cfg, params["shared_attn"], x,
                                      {"k": sa["k"][g], "v": sa["v"][g]}, pos)
        for i in range(full * k, cfg.n_layers):
            x = _decode_layer(cfg, params["layers"][i], x, stacked, i, pos)
    else:
        for i, lp in enumerate(params["layers"]):
            x = _decode_layer(cfg, lp, x, stacked, i, pos)
    return _head(cfg, params, x), cache
