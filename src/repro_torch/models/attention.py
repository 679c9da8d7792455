"""GQA attention: full, chunked (flash-style streaming softmax in plain
torch), and cached decode paths.

The chunked path is the portable flash attention: a loop over KV blocks
carrying the running (max, denominator, accumulator), so long sequences run
without materializing S x S scores. On the card the CUDA kernel
(``repro_torch.kernels.flash_attention``) is the fast path; ``attention_core``
dispatches between them exactly as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _const, _normal, apply_rope, dt, rms_norm_headwise

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, gen, dim: int, n_heads: int, n_kv: int,
                   head_dim: int, device) -> nn.ParameterDict:
    pd = dt(cfg.param_dtype)
    scale = dim ** -0.5
    p = nn.ParameterDict({
        "wq": _normal(gen, (dim, n_heads, head_dim), scale, pd, device),
        "wk": _normal(gen, (dim, n_kv, head_dim), scale, pd, device),
        "wv": _normal(gen, (dim, n_kv, head_dim), scale, pd, device),
        "wo": _normal(gen, (n_heads, head_dim, dim),
                      (n_heads * head_dim) ** -0.5, pd, device),
    })
    if cfg.qk_norm:
        p["q_norm"] = _const(1.0, (head_dim,), pd, device)
        p["k_norm"] = _const(1.0, (head_dim,), pd, device)
    return p


# ---------------------------------------------------------------------------
# Cores (operate on projected q/k/v)
# ---------------------------------------------------------------------------

def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,Dh] -> [B,S,Kv,G,Dh]"""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def attention_full(
    q: torch.Tensor,          # [B,Sq,H,Dh]
    k: torch.Tensor,          # [B,Sk,Kv,Dh]
    v: torch.Tensor,          # [B,Sk,Kv,Dh]
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """Unchunked reference / decode path (scores materialized)."""
    n_kv = k.shape[2]
    qg = _grouped(q, n_kv)  # [B,Sq,Kv,G,Dh]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float() * scale, k.float())
    sq, sk = q.shape[1], k.shape[1]
    kpos = torch.arange(sk, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= kpos[None, :]
        if prefix_len is not None:  # prefix-LM: bidirectional over the prefix
            mask = mask | (kpos[None, :] < prefix_len)
        s = s.masked_fill(~mask, NEG_INF)
    if kv_len is not None:
        s = s.masked_fill(~(kpos < kv_len), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,          # [B,Sq,H,Dh]
    k: torch.Tensor,          # [B,Sk,Kv,Dh]
    v: torch.Tensor,          # [B,Sk,Kv,Dh]
    *,
    causal: bool,
    chunk_q: int = 512,
    chunk_k: int = 1024,
    q_offset: int = 0,
    prefix_len: Optional[int] = None,
    causal_skip: bool = False,
) -> torch.Tensor:
    """Flash-style two-level streaming attention in plain torch.

    Outer loop over Q blocks; inner loop over KV blocks carrying the running
    (m, l, acc). causal_skip: q block qi only visits the KV blocks covering
    positions [0, (qi+1)*Cq), which removes the masked-block waste.
    """
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    n_kv = k.shape[2]
    g = h // n_kv
    chunk_q = min(chunk_q, sq)
    chunk_k = min(chunk_k, sk)
    nq, nk = sq // chunk_q, sk // chunk_k
    assert sq % chunk_q == 0 and sk % chunk_k == 0, (sq, chunk_q, sk, chunk_k)
    scale = dh ** -0.5
    qg = _grouped(q, n_kv)
    skip = causal_skip and causal and prefix_len is None and q_offset == 0

    outs = []
    for qi in range(nq):
        qf = qg[:, qi * chunk_q:(qi + 1) * chunk_q].float() * scale
        m = torch.full((b, n_kv, g, chunk_q), NEG_INF, device=q.device)
        l = torch.zeros((b, n_kv, g, chunk_q), device=q.device)
        acc = torch.zeros((b, chunk_q, n_kv, g, dh), device=q.device)
        nk_used = -(-((qi + 1) * chunk_q) // chunk_k) if skip else nk
        for ki in range(nk_used):
            k_blk = k[:, ki * chunk_k:(ki + 1) * chunk_k].float()
            v_blk = v[:, ki * chunk_k:(ki + 1) * chunk_k].float()
            s = torch.einsum("bqkgd,btkd->bkgqt", qf, k_blk)
            if causal:
                qpos = (qi * chunk_q + torch.arange(chunk_q, device=q.device)
                        + q_offset)
                kpos = ki * chunk_k + torch.arange(chunk_k, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                if prefix_len is not None:
                    mask = mask | (kpos[None, :] < prefix_len)
                s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bkgqt,btkd->bqkgd", p, v_blk)
            m = m_new
        out = acc / l.permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(b, chunk_q, h, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (chunked attention tiling)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return n


def attention_core(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """Dispatch: kernels > chunked (long S) > full."""
    sq, sk = q.shape[1], k.shape[1]
    if cfg.use_kernels and sq > 1 and prefix_len is None:
        from repro_torch.kernels import ops  # deferred: kernels are optional

        return ops.flash_attention(q, k, v, causal=causal)
    if sq > 1 and max(sq, sk) >= cfg.attn_chunk_threshold and kv_len is None:
        return attention_chunked(
            q, k, v, causal=causal,
            chunk_q=_pick_chunk(sq, cfg.attn_chunk_q),
            chunk_k=_pick_chunk(sk, cfg.attn_chunk),
            q_offset=q_offset, prefix_len=prefix_len,
            causal_skip=cfg.causal_skip,
        )
    return attention_full(q, k, v, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, prefix_len=prefix_len)


# ---------------------------------------------------------------------------
# Full layer-level wrappers (projections + rope + cache handling)
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor):
    cd = dt(cfg.compute_dtype)
    x = x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])
    return q, k, v


def _output(cfg: ModelConfig, p, o: torch.Tensor) -> torch.Tensor:
    cd = dt(cfg.compute_dtype)
    return torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))


def self_attention(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """Training / prefill self-attention over [B,S,D]."""
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attention_core(cfg, q, k, v, causal=causal, prefix_len=prefix_len)
    return _output(cfg, p, o)


def decode_self_attention(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,        # [B,1,D]
    cache: dict,            # {"k": [B,T,Kv,Dh], "v": [B,T,Kv,Dh]}
    pos: int,               # current position
):
    """One-token decode against a fixed-length KV cache; returns (y, cache).

    The cache is written in place at ``pos`` (the JAX package uses
    ``dynamic_update_slice`` on a donated buffer; here the returned dict
    holds the same, updated tensors)."""
    q, k_new, v_new = _project_qkv(cfg, p, x)
    if cfg.use_rope:
        posb = torch.full((x.shape[0], 1), pos, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    o = attention_core(cfg, q, k, v, causal=False, kv_len=pos + 1)
    return _output(cfg, p, o), {"k": k, "v": v}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, n_kv: int,
                      head_dim: int, dtype=None, device=None):
    dtype = dtype or dt(cfg.compute_dtype)
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
