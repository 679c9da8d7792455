"""Whisper-style encoder–decoder backbone: the JAX package's
``models/encdec.py`` on tensors.

The audio frontend (two conv layers over log-mel) is a stub, as in the
reference: the encoder consumes precomputed frame embeddings [B, T_enc, D]
(sinusoidal positions, non-causal self-attention). The decoder is a causal
stack with cross-attention; embeddings are tied, layernorm + GELU, no RoPE
(learned decoder positions).

The reference stacks each side's layers and scans them; here each side is
an ``nn.ModuleList`` run in a Python loop, with the reference's key paths
(``enc_layers.<i>.attn.wq``, ``dec_layers.<i>.cross_attn.wk``, ...).
The top level is an ``nn.ParameterDict`` so that ``pos_embed`` sits beside
the module entries under its own name. Each encoder and decoder block runs
under ``cfg.remat``, as the reference's ``_remat`` wraps them.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.layers import remat as _remat
from repro_torch.sharding import shard_act


def _init_enc_block(cfg: ModelConfig, gen, device) -> nn.ModuleDict:
    hd = cfg.resolved_head_dim
    return nn.ModuleDict({
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "attn": attn.init_attention(cfg, gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, hd, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
        "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, device),
    })


def _init_dec_block(cfg: ModelConfig, gen, device) -> nn.ModuleDict:
    hd = cfg.resolved_head_dim
    return nn.ModuleDict({
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "self_attn": attn.init_attention(cfg, gen, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, hd, device),
        "lnx": L.init_norm(cfg, cfg.d_model, device),
        "cross_attn": attn.init_attention(cfg, gen, cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, hd, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
        "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, device),
    })


def init_encdec(cfg: ModelConfig, gen: torch.Generator, device) -> nn.ParameterDict:
    """Parameters with the JAX package's names and shapes, drawn from ``gen``
    with the same distributions and scales (not the same numbers)."""
    return nn.ParameterDict({
        "embed": L.init_embed(cfg, gen, cfg.vocab_size, cfg.d_model, device),
        "pos_embed": L._normal(gen, (cfg.max_seq, cfg.d_model), 0.01,
                               L.dt(cfg.param_dtype), device),
        "enc_layers": nn.ModuleList(
            [_init_enc_block(cfg, gen, device) for _ in range(cfg.enc_layers)]),
        "enc_norm": L.init_norm(cfg, cfg.d_model, device),
        "dec_layers": nn.ModuleList(
            [_init_dec_block(cfg, gen, device) for _ in range(cfg.n_layers)]),
        "final_norm": L.init_norm(cfg, cfg.d_model, device),
    })


def _enc_block(cfg, p, x):
    x = x + attn.self_attention(cfg, p["attn"], L.norm(cfg, p["ln1"], x),
                                causal=False)
    return x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["ln2"], x))


def _dec_block(cfg, p, x, enc_out):
    x = x + attn.self_attention(cfg, p["self_attn"], L.norm(cfg, p["ln1"], x),
                                causal=True)
    x = x + attn.cross_attention(cfg, p["cross_attn"], L.norm(cfg, p["lnx"], x),
                                 enc_out)
    return x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["ln2"], x))


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B,T_enc,D] (the stubbed frontend's output)."""
    cd = L.dt(cfg.compute_dtype)
    x = frames.to(cd) + L.sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(cd)
    x = shard_act(x, "batch", None, "model", kind="resid")
    blk = _remat(cfg.remat, functools.partial(_enc_block, cfg))
    for lp in params["enc_layers"]:
        x = blk(lp, x)
    return L.norm(cfg, params["enc_norm"], x)


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = L.norm(cfg, params["final_norm"], x)
    return L.unembed(cfg, None, x, tied_table=params["embed"]["table"])


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B,S] over ``enc_out`` -> logits
    [B,S,V] f32."""
    x = L.embed(cfg, params["embed"], tokens)
    x = x + params["pos_embed"][:tokens.shape[1]].to(x.dtype)[None]
    x = shard_act(x, "batch", None, "model", kind="resid")
    blk = _remat(cfg.remat, functools.partial(_dec_block, cfg))
    for lp in params["dec_layers"]:
        x = blk(lp, x, enc_out)
    return _logits(cfg, params, x)


def encdec_forward(cfg: ModelConfig, params, tokens: torch.Tensor,
                   frames: torch.Tensor):
    """(logits [B,S,V] f32, aux_loss 0) of ``decode_train`` over
    ``encode(frames)``: ``Model.forward`` of this family."""
    logits = decode_train(cfg, params, tokens, encode(cfg, params, frames))
    return logits, torch.zeros((), device=logits.device)


def encdec_loss(cfg: ModelConfig, params, batch: dict):
    """batch: {frames [B,T,D], tokens [B,S], labels [B,S], mask?}."""
    logits, aux = encdec_forward(cfg, params, batch["tokens"], batch["frames"])
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, device=labels.device)
    ll = L.log_likelihood(logits, labels)
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce, {"loss": ce, "ce": ce, "aux": aux, "tokens": mask.sum()}


# --------------------------------------------------------------------- decode

def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Self-attention KV caches and the cross-attention K/V (filled by
    ``prefill_cross_cache``), stacked over the decoder layers as the
    reference lays them out: {"layers": {"k", "v": [L,B,T,Kv,Dh], "xk",
    "xv": [L,B,T_enc,Kv,Dh]}}."""
    hd = cfg.resolved_head_dim
    cd = L.dt(cfg.compute_dtype)
    enc_len = cfg.frontend.n_tokens if cfg.frontend else cfg.max_seq
    n = cfg.n_layers

    def zeros(length):
        return torch.zeros((n, batch, length, cfg.n_kv_heads, hd), dtype=cd,
                           device=device)

    return {"layers": {"k": zeros(cache_len), "v": zeros(cache_len),
                       "xk": zeros(enc_len), "xv": zeros(enc_len)}}


def prefill_cross_cache(cfg: ModelConfig, params, cache, enc_out: torch.Tensor):
    """Each decoder layer's cross K/V from the encoder output, computed once
    and written into the cache."""
    cd = L.dt(cfg.compute_dtype)
    layers = cache["layers"]
    with torch.no_grad():
        for i, lp in enumerate(params["dec_layers"]):
            for name, w in (("xk", "wk"), ("xv", "wv")):
                layers[name][i].copy_(torch.einsum(
                    "btd,dhk->bthk", enc_out.to(cd), lp["cross_attn"][w].to(cd)))
    return cache


def encdec_decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                       pos: int):
    """One decoder token. tokens: [B,1] -> (logits [B,1,V], cache); each
    layer's self-attention cache is written in place at ``pos``."""
    x = L.embed(cfg, params["embed"], tokens)
    x = x + params["pos_embed"][pos:pos + 1].to(x.dtype)[None]
    c = cache["layers"]
    for i, lp in enumerate(params["dec_layers"]):
        y, _ = attn.decode_self_attention(
            cfg, lp["self_attn"], L.norm(cfg, lp["ln1"], x),
            {"k": c["k"][i], "v": c["v"][i]}, pos)
        x = x + y
        x = x + attn.decode_cross_attention(
            cfg, lp["cross_attn"], L.norm(cfg, lp["lnx"], x),
            {"xk": c["xk"][i], "xv": c["xv"][i]})
        x = x + L.mlp(cfg, lp["mlp"], L.norm(cfg, lp["ln2"], x))
    return _logits(cfg, params, x), cache
