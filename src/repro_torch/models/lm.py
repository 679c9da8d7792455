"""Decoder-only LM assembly, dense family.

The blocks are an ``nn.ModuleList`` run in a Python loop (PyTorch runs
eagerly, so the JAX package's layer scan has no counterpart here). The other
families (MoE, RWKV-6, Zamba2 hybrid, VLM prefix) are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

PORTED_FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to repro_torch yet "
            f"(ported: {PORTED_FAMILIES}); see ROADMAP.md")


# ---------------------------------------------------------------------------
# Blocks and their decode twins
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, gen, device) -> nn.ModuleDict:
    hd = cfg.resolved_head_dim
    return nn.ModuleDict({
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "attn": attn.init_attention(cfg, gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, hd, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
        "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, device),
    })


def block_fwd(cfg: ModelConfig, p, x):
    x = x + attn.self_attention(cfg, p["attn"], L.norm(cfg, p["ln1"], x),
                                causal=True)
    return x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["ln2"], x))


def block_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """Returns (x, cache)."""
    y, c = attn.decode_self_attention(cfg, p["attn"],
                                      L.norm(cfg, p["ln1"], x), cache["cache"],
                                      pos)
    x = x + y
    x = x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["ln2"], x))
    return x, {"cache": c}


# ---------------------------------------------------------------------------
# Whole-model init / forward / decode
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> nn.ModuleDict:
    """Parameters with the JAX package's names and shapes, drawn from ``gen``
    with the same distributions and scales (not the same numbers)."""
    _check_family(cfg)
    params = nn.ModuleDict({
        "embed": L.init_embed(cfg, gen, cfg.vocab_size, cfg.d_model, device),
        "layers": nn.ModuleList(
            [init_block(cfg, gen, device) for _ in range(cfg.n_layers)]),
        "final_norm": L.init_norm(cfg, cfg.d_model, device),
    })
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_unembed(cfg, gen, cfg.d_model,
                                           cfg.vocab_size, device)
    return params


def _head(cfg: ModelConfig, params, x):
    x = L.norm(cfg, params["final_norm"], x)
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    head = None if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(cfg, head, x, tied_table=tied)


def lm_forward(cfg: ModelConfig, params, tokens: torch.Tensor):
    """tokens: [B,S] -> (logits [B,S,V] f32, aux_loss)."""
    x = L.embed(cfg, params["embed"], tokens)
    for lp in params["layers"]:
        x = block_fwd(cfg, lp, x)
    aux = torch.zeros((), device=x.device)
    return _head(cfg, params, x), aux


def lm_loss(cfg: ModelConfig, params, batch: dict):
    """batch: {tokens [B,S], labels [B,S], mask [B,S]} -> (loss, metrics)."""
    logits, aux = lm_forward(cfg, params, batch["tokens"])
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, device=labels.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    loss = ce + aux
    metrics = {"loss": loss, "ce": ce, "aux": aux, "tokens": mask.sum()}
    return loss, metrics


def init_lm_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """KV caches stacked over layers, as the JAX package lays them out:
    {"layers": {"cache": {"k": [L,B,T,Kv,Dh], "v": ...}}}."""
    _check_family(cfg)
    one = attn.init_decode_cache(cfg, batch, cache_len, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, device=device)
    return {"layers": {"cache": {
        name: t.new_zeros((cfg.n_layers, *t.shape)) for name, t in one.items()}}}


def lm_decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor,
                   pos: int):
    """One decode step. tokens: [B,1]; pos: int -> (logits [B,1,V], cache).
    Each layer's slice of the stacked cache is updated in place."""
    x = L.embed(cfg, params["embed"], tokens)
    kc = cache["layers"]["cache"]
    for i, lp in enumerate(params["layers"]):
        x, _ = block_decode(cfg, lp, x,
                            {"cache": {"k": kc["k"][i], "v": kc["v"][i]}}, pos)
    return _head(cfg, params, x), cache
