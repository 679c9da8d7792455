"""The published Zamba2 (Zyphra; https://huggingface.co/Zyphra/Zamba2-7B-Instruct,
the equations of ``transformers``' ``modeling_zamba2.py``): a stack of
Mamba-2 layers, some of which first run one of ``num_mem_blocks`` shared
transformer blocks, the blocks used in turn.

With e the embedding and h = e at the start, layer i of ``n_layers``:

    i the u-th of hybrid_layer_ids:  t = SharedBlock[u mod num_mem_blocks](h, e, u)
                                     h = h + Mamba_i(RMSNorm_i(h + Link_u(t)))
    any other layer:                 h = h + Mamba_i(RMSNorm_i(h))

    logits = RMSNorm_f(h) @ E^T      (the embedding tied)

SharedBlock_b(h, e, u), with no residual inside: x = RMSNorm(concat(h, e))
(2 d_model wide, the published ``attention_hidden_size``); causal RoPE attention of
``n_heads`` heads of ``head_dim`` at softmax scale ``(head_dim / 2) ** -0.5``,
projected back to d_model; y = RMSNorm(a); [g, p] = y @ [Wg, Wu] +
(y @ A_u) @ B_u, the rank-``adapter_rank`` adapter of use u; out
(gelu_erf(g) * p) @ Wd. Each use has its own adapter and link. Mamba_i is
``mamba2.mamba2_block`` with the config's B and C groups, conv bias and
gated-norm eps. Every RMSNorm is ``layers.norm`` at ``norm_eps``. The
output head is the tied embedding.

This is not the port's ``hybrid`` family (``models/lm.py::_hybrid_fwd``:
one d_model-wide shared block with a residual after every ``attn_every``
layers, tanh GELU, one group, no conv bias, eps 1e-6), whose arithmetic is
left as it was.

Spans: ``lm.forward``, ``lm.embed``, ``lm.block`` (a layer with its shared
block's use) and ``lm.head`` as the other families; inside the shared
block ``norm``, ``attn.*`` and ``mlp`` (the gate, up and down products and
GELU) as the dense block, and ``shared.concat``, ``shared.adapter``,
``shared.link`` (``runtime/spans.py``). The decode cache holds each
layer's conv and SSM states and one k/v cache per shared-block use;
prefill is decode steps over the prompt, as in the port's serve path. The
forward takes no rematerialisation policy: the published model is served
here, not trained.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import _const, _normal, dt
from repro_torch.runtime.spans import span


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """The published Zamba2's settings beside the pinned ``ModelConfig``'s
    (``family`` "zamba2"); defaults are ``transformers``' ``Zamba2Config``'s."""

    ssm_groups: int = 1                # mamba_ngroups: B and C groups
    conv_bias: bool = True             # use_conv_bias
    num_mem_blocks: int = 1            # shared transformer blocks, used in turn
    hybrid_layer_ids: Tuple[int, ...] = ()   # the layers that run one first
    adapter_rank: int = 128            # the shared MLP's adapter of each use
    norm_eps: float = 1e-5             # rms_norm_eps, every RMSNorm

    @classmethod
    def from_dict(cls, m: dict) -> "Zamba2Config":
        """From a ``model`` section: the pinned ``SSMConfig`` cannot hold
        ``ssm.n_groups``, so it becomes ``ssm_groups``."""
        m, ssm = dict(m), dict(m["ssm"])
        groups = ssm.pop("n_groups", 1)
        return cls(**{**m, "ssm": SSMConfig(**ssm), "ssm_groups": groups,
                      "hybrid_layer_ids": tuple(m.get("hybrid_layer_ids", ()))})


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------

def init_zamba2(cfg: Zamba2Config, gen: torch.Generator, device) -> nn.ModuleDict:
    """Parameters, named as the benchmark's reference names them, drawn from
    ``gen`` at the port's fan-in scales."""
    pd = dt(cfg.param_dtype)
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    wide = 2 * d   # concat(h, embedding)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def norm(dim):
        return nn.ParameterDict({"scale": _const(1.0, (dim,), pd, device)})

    def normal(*shape, fan_in=1):
        return _normal(gen, shape, math.prod(shape[:fan_in]) ** -0.5, pd, device)

    return nn.ModuleDict({
        "embed": L.init_embed(cfg, gen, cfg.vocab_size, d, device),
        "layers": nn.ModuleList([
            nn.ModuleDict({"ln": norm(d), "ssm": m2.init_mamba2(cfg, gen, device)})
            for _ in range(cfg.n_layers)]),
        "shared": nn.ModuleList([nn.ModuleDict({
            "ln1": norm(wide),
            "attn": nn.ParameterDict({
                "wq": normal(wide, h, hd), "wk": normal(wide, kv, hd),
                "wv": normal(wide, kv, hd), "wo": normal(h, hd, d, fan_in=2)}),
            "ln2": norm(d),
            "mlp": nn.ParameterDict({
                "w_gate": normal(d, f), "w_up": normal(d, f),
                "w_down": normal(f, d)}),
        }) for _ in range(cfg.num_mem_blocks)]),
        "uses": nn.ModuleList([nn.ParameterDict({
            "adapter_in": normal(d, r), "adapter_out": normal(r, 2 * f),
            "link": normal(d, d)}) for _ in cfg.hybrid_layer_ids]),
        "final_norm": norm(d),
    })


def init_zamba2_cache(cfg: Zamba2Config, batch: int, cache_len: int, device=None):
    """{"layers": {conv_state [L,B,K-1,C], ssm_state [L,B,H,P,N] f32},
    "shared": {"k"/"v": [U,B,T,Kv,Dh]}} over the L layers and U uses."""
    cd = dt(cfg.compute_dtype)
    s = cfg.ssm
    _, heads, conv_dim = m2._dims(cfg)
    n, uses = cfg.n_layers, len(cfg.hybrid_layer_ids)
    kv = (uses, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "layers": {
            "conv_state": torch.zeros((n, batch, s.conv_kernel - 1, conv_dim),
                                      dtype=cd, device=device),
            "ssm_state": torch.zeros((n, batch, heads, s.head_dim, s.state_dim),
                                     device=device)},
        "shared": {"k": torch.zeros(kv, dtype=cd, device=device),
                   "v": torch.zeros(kv, dtype=cd, device=device)},
    }


# ---------------------------------------------------------------------------
# The pieces of a layer
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``hidden_act`` "gelu": the exact (erf) form."""
    return F.gelu(x)


def _softmax_scale(cfg: Zamba2Config) -> float:
    """Zamba2's attention scales its scores by ``(head_dim / 2) ** -0.5``."""
    return (cfg.resolved_head_dim / 2) ** -0.5


def _block_of(cfg: Zamba2Config, u: int) -> int:
    """The shared block that use ``u`` runs: the blocks in turn."""
    return u % cfg.num_mem_blocks


def _mlp(cfg: Zamba2Config, p, up, y: torch.Tensor) -> torch.Tensor:
    """(gelu(g) * u) @ Wd with [g, u] = y @ [Wg, Wu] + (y @ A) @ B."""
    cd = dt(cfg.compute_dtype)
    y = y.to(cd)
    with span("mlp"):
        g, u = y @ p["w_gate"].to(cd), y @ p["w_up"].to(cd)
    with span("shared.adapter"):
        ad = (y @ up["adapter_in"].to(cd)) @ up["adapter_out"].to(cd)
        g, u = g + ad[..., :cfg.d_ff], u + ad[..., cfg.d_ff:]
    with span("mlp"):
        return (_gelu(g) * u) @ p["w_down"].to(cd)


def _shared_block(cfg: Zamba2Config, bp, up, h, e, kv=None,
                  pos: Optional[int] = None) -> torch.Tensor:
    """SharedBlock(h, e) of one use: over the sequence, or, with its k/v
    cache ``kv``, one decode step at ``pos``."""
    with span("shared.concat"):
        x = torch.cat([h, e], dim=-1)
    x = L.norm(cfg, bp["ln1"], x)
    if kv is None:
        a = attn.self_attention(cfg, bp["attn"], x, causal=True,
                                scale=_softmax_scale(cfg))
    else:
        a, _ = attn.decode_self_attention(cfg, bp["attn"], x, kv, pos,
                                          scale=_softmax_scale(cfg))
    return _mlp(cfg, bp["mlp"], up, L.norm(cfg, bp["ln2"], a))


def _linked(cfg: Zamba2Config, up, h, t) -> torch.Tensor:
    """The Mamba layer's input: h + Link_u(t)."""
    cd = dt(cfg.compute_dtype)
    with span("shared.link"):
        return h + t.to(cd) @ up["link"].to(cd)


def _mamba_layer(cfg: Zamba2Config, lp, h, x, cache=None):
    """h + Mamba(RMSNorm(x)), x being h or the linked input: over the
    sequence, or one decode step against the layer's ``cache`` (its states
    updated in place)."""
    xn = L.norm(cfg, lp["ln"], x)
    if cache is None:
        return h + m2.mamba2_block(cfg, lp["ssm"], xn)
    y, new = m2.mamba2_block_decode(cfg, lp["ssm"], xn, cache)
    for name, t in new.items():
        cache[name].copy_(t)
    return h + y


def _head(cfg: Zamba2Config, params, h) -> torch.Tensor:
    x = L.norm(cfg, params["final_norm"], h)
    return L.unembed(cfg, None, x, tied_table=params["embed"]["table"])


# ---------------------------------------------------------------------------
# Forward, loss, decode
# ---------------------------------------------------------------------------

def zamba2_forward(cfg: Zamba2Config, params, tokens: torch.Tensor):
    """tokens [B,S] -> (logits [B,S,V] f32, a zero aux loss)."""
    uses = {i: u for u, i in enumerate(cfg.hybrid_layer_ids)}
    with span("lm.forward"):
        with span("lm.embed"):
            e = L.embed(cfg, params["embed"], tokens)
        h = e
        for i, lp in enumerate(params["layers"]):
            with span("lm.block"):
                x, u = h, uses.get(i)
                if u is not None:
                    up = params["uses"][u]
                    t = _shared_block(cfg, params["shared"][_block_of(cfg, u)],
                                      up, h, e)
                    x = _linked(cfg, up, h, t)
                h = _mamba_layer(cfg, lp, h, x)
        with span("lm.head"):
            return _head(cfg, params, h), torch.zeros((), device=h.device)


def zamba2_loss(cfg: Zamba2Config, params, batch: dict):
    """batch {tokens, labels, mask (optional)} -> (mean next-token loss,
    metrics), as ``lm.lm_loss``."""
    logits, aux = zamba2_forward(cfg, params, batch["tokens"])
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, device=labels.device)
    ll = L.log_likelihood(logits, labels)
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce, {"loss": ce, "ce": ce, "aux": aux, "tokens": mask.sum()}


def zamba2_decode_step(cfg: Zamba2Config, params, cache: dict,
                       tokens: torch.Tensor, pos: int):
    """One decode step. tokens [B,1] at ``pos`` -> (logits [B,1,V], cache),
    the cache updated in place."""
    uses = {i: u for u, i in enumerate(cfg.hybrid_layer_ids)}
    states, kv = cache["layers"], cache["shared"]
    e = L.embed(cfg, params["embed"], tokens)
    h = e
    for i, lp in enumerate(params["layers"]):
        x, u = h, uses.get(i)
        if u is not None:
            up = params["uses"][u]
            t = _shared_block(cfg, params["shared"][_block_of(cfg, u)], up, h, e,
                              kv={"k": kv["k"][u], "v": kv["v"][u]}, pos=pos)
            x = _linked(cfg, up, h, t)
        h = _mamba_layer(cfg, lp, h, x,
                         cache={name: t[i] for name, t in states.items()})
    return _head(cfg, params, h), cache
