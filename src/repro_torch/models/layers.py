"""Shared neural-net building blocks.

Parameters are ``nn.ParameterDict``s keyed and shaped as the JAX package's
parameter dicts (``p["scale"]``, ``p["w_up"]`` [D, F], ...), so every function
here reads like its JAX counterpart and carrying weights across is a copy.
Params live in ``cfg.param_dtype``; compute casts to ``cfg.compute_dtype``
(bf16 by default) with f32 where it matters (norms, rope, logits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(gen: torch.Generator, shape, scale, dtype, device) -> nn.Parameter:
    x = scale * torch.randn(shape, generator=gen, dtype=torch.float32)
    return nn.Parameter(x.to(device=device, dtype=dtype))


def _const(value: float, shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dim: int, device) -> nn.ParameterDict:
    pd = dt(cfg.param_dtype)
    p = nn.ParameterDict({"scale": _const(1.0, (dim,), pd, device)})
    if cfg.norm == "layernorm":
        p["bias"] = _const(0.0, (dim,), pd, device)
    return p


def norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """qk-norm (qwen3): RMS-normalize the last (head) dim."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen, vocab: int, dim: int, device):
    # 0.02 std keeps tied-unembed logits sane at init (GPT/whisper convention)
    return nn.ParameterDict(
        {"table": _normal(gen, (vocab, dim), 0.02, dt(cfg.param_dtype), device)})


def embed(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens].to(dt(cfg.compute_dtype))


def unembed(cfg: ModelConfig, p, x: torch.Tensor, *, tied_table=None):
    """Project to vocab logits (f32)."""
    if tied_table is not None:
        w = tied_table.to(dt(cfg.compute_dtype)).T  # [D, V]
    else:
        w = p["kernel"].to(dt(cfg.compute_dtype))
    return (x @ w).float()


def init_unembed(cfg: ModelConfig, gen, dim: int, vocab: int, device):
    return nn.ParameterDict({"kernel": _normal(
        gen, (dim, vocab), dim ** -0.5, dt(cfg.param_dtype), device)})


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [Dh/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable). Split-half."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., :, None].float() * freqs  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU / GeGLU, or plain 2-layer)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen, dim: int, hidden: int, device):
    pd = dt(cfg.param_dtype)
    p = nn.ParameterDict({
        "w_up": _normal(gen, (dim, hidden), dim ** -0.5, pd, device),
        "w_down": _normal(gen, (hidden, dim), hidden ** -0.5, pd, device),
    })
    if cfg.gated_mlp:
        p["w_gate"] = _normal(gen, (dim, hidden), dim ** -0.5, pd, device)
    return p


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


def mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The single-device branch of the JAX ``mlp``: its tensor-parallel ring
    (``mlp_tp_overlap``) needs a mesh and is not ported yet (ROADMAP.md), and
    ``bf16_reduce`` changes nothing here since torch's bf16 matmul already
    returns bf16."""
    cd = dt(cfg.compute_dtype)
    x = x.to(cd)
    up = x @ p["w_up"].to(cd)
    if cfg.gated_mlp:
        h = _act(cfg.act, x @ p["w_gate"].to(cd)) * up
    else:
        h = _act(cfg.act, up)
    return h @ p["w_down"].to(cd)
