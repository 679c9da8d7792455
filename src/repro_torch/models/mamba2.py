"""Mamba-2 (SSD) block: chunked state-space recurrence with scalar-per-head
decay, used by the zamba2 hybrid.

The chunked algorithm is the SSD decomposition: intra-chunk terms are a
masked "attention-like" product against C·B^T with cumulative scalar
decays; the inter-chunk state is carried by a Python loop over chunks. On
the card the CUDA kernel (``repro_torch.kernels.ssd``) runs the whole
recurrence; ``mamba2_block`` dispatches between them as the JAX package
does.

Decode carries (conv_state [B,K-1,conv_dim], ssm_state [B,H,P,N]): O(1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _const, _normal, dt
from repro_torch.sharding import on_local_shards, shard_act


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_dim  # x, B, C share the conv
    return d_inner, n_heads, conv_dim


def init_mamba2(cfg: ModelConfig, gen, device) -> nn.ParameterDict:
    pd = dt(cfg.param_dtype)
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    in_dim = 2 * d_inner + 2 * s.state_dim + n_heads  # z, x, B, C, dt
    # The JAX package draws dt from numpy's RandomState(0), so both packages
    # hold the same dt_bias.
    dt_init = torch.tensor(np.exp(np.random.RandomState(0).uniform(
        np.log(s.dt_min), np.log(s.dt_max), size=(n_heads,))), dtype=torch.float32)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return nn.ParameterDict({
        "w_in": _normal(gen, (d, in_dim), d ** -0.5, pd, device),
        "w_out": _normal(gen, (d_inner, d), d_inner ** -0.5, pd, device),
        "conv": _normal(gen, (s.conv_kernel, conv_dim), 0.1, pd, device),
        "A_log": _const(0.0, (n_heads,), pd, device),   # A = -exp(A_log)
        "D": _const(1.0, (n_heads,), pd, device),
        "dt_bias": nn.Parameter(dt_bias.to(device=device, dtype=pd)),
        "norm_scale": _const(1.0, (d_inner,), pd, device),
    })


def _split_in(cfg: ModelConfig, h: torch.Tensor):
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    return torch.split(h, [d_inner, d_inner, s.state_dim, s.state_dim, n_heads],
                       dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, conv_state=None):
    """Depthwise causal conv. x: [B,S,C]; w: [K,C]."""
    k = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, C]
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(out), new_state


def ssd_chunked(
    x: torch.Tensor,       # [B,T,H,P]   (dt-scaled inputs)
    a: torch.Tensor,       # [B,T,H]     log decay (<= 0)
    b: torch.Tensor,       # [B,T,N]
    c: torch.Tensor,       # [B,T,N]
    state0: torch.Tensor,  # [B,H,P,N]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scalar-decay SSD. Returns (y [B,T,H,P] f32, state [B,H,P,N])."""
    bb, t, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    nc = t // chunk

    xs = x.reshape(bb, nc, chunk, h, p).float()
    as_ = a.reshape(bb, nc, chunk, h).float()
    bs = b.reshape(bb, nc, chunk, n).float()
    cs = c.reshape(bb, nc, chunk, n).float()

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))  # inclusive

    state = state0.float()
    ys = []
    for i in range(nc):
        xc, ac, bc, cc = xs[:, i], as_[:, i], bs[:, i], cs[:, i]
        la = torch.cumsum(ac, dim=1)     # [B,C,H] inclusive
        # intra-chunk: y_t = sum_{tau<=t} exp(la_t - la_tau) (c_t.b_tau) x_tau
        cb = torch.einsum("btn,bsn->bts", cc, bc)        # [B,C,C]
        # The upper triangle's exponent is positive and may overflow: select
        # it away (a mask applied by multiplying would make inf * 0 = NaN).
        diff = la[:, :, None, :] - la[:, None, :, :]     # [B,C,C,H]
        decay = torch.where(mask[None, :, :, None], torch.exp(diff),
                            torch.zeros_like(diff))
        w = cb[..., None] * decay
        y = torch.einsum("btsh,bshp->bthp", w, xc)
        # inter-chunk: y_t += c_t . (state * exp(la_t))
        y = y + torch.einsum("btn,bhpn,bth->bthp", cc, state, torch.exp(la))
        # state update: S' = exp(la_end) S + sum_tau exp(la_end - la_tau) x_tau b_tau^T
        la_end = la[:, -1]               # [B,H]
        dec_end = torch.exp(la_end[:, None] - la)        # [B,C,H]
        state = state * torch.exp(la_end)[..., None, None] + torch.einsum(
            "bshp,bsn,bsh->bhpn", xc, bc, dec_end)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bb, t, h, p)
    return y, state


def ssd_step(x, a, b, c, state):
    """Single-token SSD. x: [B,H,P]; a: [B,H]; b/c: [B,N]; state [B,H,P,N]."""
    xf, bf, cf = x.float(), b.float(), c.float()
    state = state * torch.exp(a.float())[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xf, bf)
    y = torch.einsum("bhpn,bn->bhp", state, cf)
    return y.to(x.dtype), state


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


def mamba2_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill path. x: [B,S,D] -> [B,S,D]."""
    cd = dt(cfg.compute_dtype)
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    h = x.to(cd) @ p["w_in"].to(cd)
    h = shard_act(h, "batch", None, "model")
    z, xi, bi, ci, dt_raw = _split_in(cfg, h)
    conv_in = torch.cat([xi, bi, ci], dim=-1)
    conv_out, _ = _causal_conv(conv_in, p["conv"].to(cd))
    xi, bi, ci = torch.split(conv_out, [d_inner, s.state_dim, s.state_dim], dim=-1)

    dt_v = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float()) * dt_v            # [B,S,H] log decay
    xh = xi.reshape(*xi.shape[:-1], n_heads, s.head_dim)
    x_dt = xh.float() * dt_v[..., None]

    if cfg.use_kernels:
        from repro_torch.kernels import ops  # deferred: kernels are optional

        y = ops.ssd(x_dt, a, bi.float(), ci.float(), chunk=s.chunk)
    else:
        state0 = torch.zeros((x.shape[0], n_heads, s.head_dim, s.state_dim),
                             device=x.device)
        y, _ = on_local_shards(   # independent per (batch row, head)
            lambda *args: ssd_chunked(*args, s.chunk), x_dt, (0, 2),
            [(x_dt, (0, None, 2, None)), (a, (0, None, 2)),
             (bi, (0, None, None)), (ci, (0, None, None)),
             (state0, (0, 2, None, None))],
            [(0, None, 2, None), (0, 2, None, None)])
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(*x.shape[:-1], d_inner).to(cd)
    y = _rms(y * F.silu(z), p["norm_scale"])
    out = y.to(cd) @ p["w_out"].to(cd)
    return shard_act(out, "batch", None, "model", kind="resid")


def mamba2_block_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: dict):
    """Decode path. x: [B,1,D]; cache: {conv_state [B,K-1,C], ssm_state [B,H,P,N]}."""
    cd = dt(cfg.compute_dtype)
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    h = x.to(cd) @ p["w_in"].to(cd)
    z, xi, bi, ci, dt_raw = _split_in(cfg, h)
    conv_in = torch.cat([xi, bi, ci], dim=-1)   # [B,1,C]
    conv_out, new_conv = _causal_conv(conv_in, p["conv"].to(cd),
                                      conv_state=cache["conv_state"])
    xi, bi, ci = torch.split(conv_out, [d_inner, s.state_dim, s.state_dim], dim=-1)

    dt_v = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = (-torch.exp(p["A_log"].float()) * dt_v)[:, 0]    # [B,H]
    xh = xi[:, 0].reshape(x.shape[0], n_heads, s.head_dim)
    x_dt = xh.float() * dt_v[:, 0, :, None]

    y, state = ssd_step(x_dt, a, bi[:, 0], ci[:, 0],
                        cache["ssm_state"].float())
    y = y + p["D"].float()[None, :, None] * xh.float()
    y = y.reshape(x.shape[0], 1, d_inner).to(cd)
    y = _rms(y * F.silu(z), p["norm_scale"])
    out = y.to(cd) @ p["w_out"].to(cd)
    return out, {"conv_state": new_conv, "ssm_state": state}
