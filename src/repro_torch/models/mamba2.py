"""Mamba-2 (SSD) block: chunked state-space recurrence with scalar-per-head
decay, used by the port's zamba2 hybrid and by the published Zamba2
(``models/zamba2.py``).

The published model's options come from its config
(``zamba2.Zamba2Config``): B and C in ``ssm_groups`` groups (head h reads
group h // (H / G); ``_groups``), a bias on the depthwise conv (a
``conv_bias`` parameter where ``cfg.conv_bias``), and the gated RMSNorm
taken per group of d_inner / G channels at ``norm_eps``
(``layers.norm_eps``). A block call reads them once. Any other config takes
the port's hybrid's: one group, no bias, eps 1e-6, with the arithmetic it
always had.

The chunked algorithm is the SSD decomposition: intra-chunk terms are a
masked "attention-like" product against C·B^T with cumulative scalar
decays; the inter-chunk state is carried by a Python loop over chunks. On
the card the CUDA kernel (``repro_torch.kernels.ssd``) runs the whole
recurrence; ``mamba2_block`` dispatches between them as the JAX package
does.

Decode carries (conv_state [B,K-1,conv_dim], ssm_state [B,H,P,N]): O(1).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import group_heads
from repro_torch.models.layers import _const, _normal, dt, norm_eps
from repro_torch.runtime.spans import span
from repro_torch.sharding import (cast_local, dividing_dims, from_local_parts,
                                  local_part, mesh_reduce, on_local_shards,
                                  shard_act, shard_index, sharding_dims,
                                  split_layout, spread, zero_gather_pays)


def _groups(cfg: ModelConfig) -> int:
    """B and C groups: the published Zamba2's ``ssm_groups``, else one."""
    return getattr(cfg, "ssm_groups", 1)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * _groups(cfg) * s.state_dim  # x, B, C share the conv
    return d_inner, n_heads, conv_dim


def init_mamba2(cfg: ModelConfig, gen, device) -> nn.ParameterDict:
    pd = dt(cfg.param_dtype)
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    in_dim = d_inner + conv_dim + n_heads  # z, x, B, C, dt
    # The JAX package draws dt from numpy's RandomState(0), so both packages
    # hold the same dt_bias.
    dt_init = torch.tensor(np.exp(np.random.RandomState(0).uniform(
        np.log(s.dt_min), np.log(s.dt_max), size=(n_heads,))), dtype=torch.float32)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    p = nn.ParameterDict({
        "w_in": _normal(gen, (d, in_dim), d ** -0.5, pd, device),
        "w_out": _normal(gen, (d_inner, d), d_inner ** -0.5, pd, device),
        "conv": _normal(gen, (s.conv_kernel, conv_dim), 0.1, pd, device),
        "A_log": _const(0.0, (n_heads,), pd, device),   # A = -exp(A_log)
        "D": _const(1.0, (n_heads,), pd, device),
        "dt_bias": nn.Parameter(dt_bias.to(device=device, dtype=pd)),
        "norm_scale": _const(1.0, (d_inner,), pd, device),
    })
    if getattr(cfg, "conv_bias", False):
        p["conv_bias"] = _normal(gen, (conv_dim,), 0.1, pd, device)
    return p


def _split_in(cfg: ModelConfig, h: torch.Tensor):
    """z, xBC, dt: the in-projection's columns in the published order."""
    d_inner, n_heads, conv_dim = _dims(cfg)
    return torch.split(h, [d_inner, conv_dim, n_heads], dim=-1)


def _conv(cfg: ModelConfig, p, xbc: torch.Tensor, groups: int, cd,
          conv_state=None):
    """The conv (its bias where the block has one) and SiLU over xBC, split
    into x, B and C: B and C [..., G, N] in ``groups`` groups, [..., N] in
    one. Returns (x, B, C, the conv's new state). Under ``use_kernels`` a
    call without a state goes to ``ops.causal_conv_silu``, bit for bit
    ``_causal_conv``, and returns no state."""
    from repro_torch.kernels import ops  # deferred: kernels are optional

    d_inner, n = _dims(cfg)[0], cfg.ssm.state_dim
    w = p["conv"].to(cd)
    bias = p["conv_bias"].to(cd) if "conv_bias" in p else None
    if cfg.use_kernels and conv_state is None:
        out, new_state = ops.causal_conv_silu(xbc, w, bias), None
    else:
        out, new_state = _causal_conv(xbc, w, conv_state, bias)
    xi, bi, ci = torch.split(out, [d_inner, groups * n, groups * n], dim=-1)
    if groups > 1:
        bi, ci = bi.unflatten(-1, (groups, n)), ci.unflatten(-1, (groups, n))
    return xi, bi, ci, new_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor, conv_state=None,
                 bias=None):
    """Depthwise causal conv, then its bias (where given) and SiLU. x:
    [B,S,C]; w: [K,C]; bias [C]."""
    k = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, C]
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    if bias is not None:
        out = out + bias
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(out), new_state


def ssd_chunked(
    x: torch.Tensor,       # [B,T,H,P]   (dt-scaled inputs)
    a: torch.Tensor,       # [B,T,H]     log decay (<= 0)
    b: torch.Tensor,       # [B,T,N], or [B,T,G,N] in G groups
    c: torch.Tensor,       # like b
    state0: torch.Tensor,  # [B,H,P,N]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scalar-decay SSD. Returns (y [B,T,H,P] f32, state [B,H,P,N]).
    With groups, head h reads group h // (H / G): each group's heads are a
    call of their own."""
    if b.dim() == 4:
        parts = [ssd_chunked(xg, ag, bg, cg, sg, chunk) for bg, cg, xg, ag, sg
                 in group_heads(b, c, (x, 2), (a, 2), (state0, 1))]
        return (torch.cat([y for y, _ in parts], dim=2),
                torch.cat([st for _, st in parts], dim=1))
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
    """Single-token SSD. x: [B,H,P]; a: [B,H]; b/c: [B,N], or [B,G,N] in G
    groups; state [B,H,P,N]."""
    if b.dim() == 3:   # each head its group's b and c
        hg = x.shape[1] // b.shape[1]
        bf, cf = (t.float().repeat_interleave(hg, dim=1) for t in (b, c))
        state = state * torch.exp(a.float())[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x.float(), bf)
        y = torch.einsum("bhpn,bhn->bhp", state, cf)
        return y.to(x.dtype), state
    xf, bf, cf = x.float(), b.float(), c.float()
    state = state * torch.exp(a.float())[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xf, bf)
    y = torch.einsum("bhpn,bn->bhp", state, cf)
    return y.to(x.dtype), state


def _rms(x: torch.Tensor, scale: torch.Tensor, groups: int = 1,
         eps: float = 1e-6) -> torch.Tensor:
    """The gated norm's RMSNorm, taken over each of ``groups`` equal groups
    of the last dim."""
    xf = x.float()
    if groups > 1:
        xf = xf.unflatten(-1, (groups, -1))
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    if groups > 1:
        y = y.flatten(-2)
    return (y * scale.float()).to(x.dtype)


def mamba2_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill path. x: [B,S,D] -> [B,S,D]. A DTensor ``x`` over more
    than one rank takes the plain recurrence on each rank's own heads
    (``_mamba2_sharded``; the kernel refuses DTensors), where gathering the
    weights' ZeRO shards pays (not a few rows a rank). Spans: ``mamba.in``
    the in-projection, ``mamba.conv`` the conv, its bias and SiLU,
    ``mamba.ssd`` dt, the decay, the recurrence and the D skip,
    ``mamba.gate_norm`` the gated RMSNorm, ``mamba.out`` the
    out-projection."""
    if (spread(x) and not cfg.use_kernels
            and zero_gather_pays(x, p["w_in"])):
        return _mamba2_sharded(cfg, p, x)
    cd = dt(cfg.compute_dtype)
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    groups, eps = _groups(cfg), norm_eps(cfg)
    with span("mamba.in"):
        h = x.to(cd) @ p["w_in"].to(cd)
        h = shard_act(h, "batch", None, "model")
        z, xbc, dt_raw = _split_in(cfg, h)
    with span("mamba.conv"):
        xi, bi, ci, _ = _conv(cfg, p, xbc, groups, cd)

    with span("mamba.ssd"):
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
            bc_dims = (0, None) + (None,) * (bi.dim() - 2)
            y, _ = on_local_shards(   # independent per (batch row, head)
                lambda *args: ssd_chunked(*args, s.chunk), x_dt, (0, 2),
                [(x_dt, (0, None, 2, None)), (a, (0, None, 2)),
                 (bi, bc_dims), (ci, bc_dims),
                 (state0, (0, 2, None, None))],
                [(0, None, 2, None), (0, 2, None, None)])
        y = y + p["D"].float()[None, None, :, None] * xh.float()
        y = y.reshape(*x.shape[:-1], d_inner).to(cd)
    with span("mamba.gate_norm"):
        y = _rms(y * F.silu(z), p["norm_scale"], groups, eps)
    with span("mamba.out"):
        out = y.to(cd) @ p["w_out"].to(cd)
        return shard_act(out, "batch", None, "model", kind="resid")


def _mamba2_sharded(cfg: ModelConfig, p, x: DTensor) -> DTensor:
    """The Mamba-2 block on each rank's local tensors, cut by heads over the
    mesh dims that shard w_out's rows (d_inner, heads contiguous), as
    Megatron cuts attention. w_in's contiguous column cut does not follow
    the heads, so w_in is gathered whole (its ``data`` and ``model`` shards,
    in the compute dtype) and cut to the rank's columns: the z, x and dt
    columns of its heads, and B and C whole (shared by every head, projected
    on every rank as the kv heads are in attention). Gathering the weight
    moves fewer bytes than moving the activations of the contiguous cut
    into the heads' layout in every train and prefill cell
    (``launch.dryrun.mamba2_w_in_costs``). The depthwise conv runs on the
    rank's x channels and B and C; the conv weights, A_log, D, dt_bias and
    the norm's scale are cut to them. The SSD runs per head. The gated
    RMSNorm's [rows, 1] f32 sum of squares is all-reduced over the heads'
    mesh dims (its gradient too), and w_out is row-parallel: its rows of the
    rank's heads, the output a partial sum reduce-scattered into the
    residual layout. The published Zamba2's options have no such plan."""
    if (_groups(cfg), "conv_bias" in p, norm_eps(cfg)) != (1, False, 1e-6):
        raise NotImplementedError("groups, a conv bias or another eps on a mesh")
    cd = dt(cfg.compute_dtype)
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    n, hp = s.state_dim, s.head_dim
    mesh = x.device_mesh
    pl = functools.partial(split_layout, mesh.ndim)
    rows = sharding_dims(x, 0)
    heads = dividing_dims(mesh, [i for i in sharding_dims(p["w_out"], 0)
                                 if i not in rows], n_heads)
    every = rows + heads
    h_loc = n_heads // math.prod(mesh.size(i) for i in heads)
    h0 = shard_index(mesh, pl(0, heads), 0) * h_loc
    c0, c_loc = h0 * hp, h_loc * hp

    def cut(t, spans, dim):
        return torch.cat([t.narrow(dim, a, m) for a, m in spans], dim=dim)

    w_in = local_part(cast_local(p["w_in"], cd), pl(0, ()), every)
    w_in = cut(w_in, [(c0, c_loc), (d_inner + c0, c_loc), (2 * d_inner, 2 * n),
                      (2 * d_inner + 2 * n + h0, h_loc)], 1)
    xl = local_part(x, pl(0, rows), heads)
    z, xi, bc, dt_raw = torch.split(xl.to(cd) @ w_in,
                                    [c_loc, c_loc, 2 * n, h_loc], dim=-1)
    conv = local_part(p["conv"], pl(0, ()), every)
    conv = cut(conv, [(c0, c_loc), (d_inner, 2 * n)], 1)
    conv_out, _ = _causal_conv(torch.cat([xi, bc], dim=-1), conv.to(cd))
    xi, bi, ci = torch.split(conv_out, [c_loc, n, n], dim=-1)

    # the per-head vectors cut to the rank's heads, the norm's scale to its
    # channels
    vec = {name: local_part(p[name], pl(0, ()), every).narrow(0, *span).float()
           for name, span in (("dt_bias", (h0, h_loc)), ("A_log", (h0, h_loc)),
                              ("D", (h0, h_loc)), ("norm_scale", (c0, c_loc)))}
    dt_v = F.softplus(dt_raw.float() + vec["dt_bias"])
    a = -torch.exp(vec["A_log"]) * dt_v                  # [B,S,H] log decay
    xh = xi.reshape(*xi.shape[:-1], h_loc, hp)
    x_dt = xh.float() * dt_v[..., None]
    state0 = torch.zeros((xl.shape[0], h_loc, hp, n), device=xl.device)
    y, _ = ssd_chunked(x_dt, a, bi, ci, state0, s.chunk)
    y = y + vec["D"][None, None, :, None] * xh.float()
    g = (y.reshape(*xl.shape[:-1], c_loc).to(cd) * F.silu(z)).float()
    # the gated RMSNorm over all of d_inner: the statistic summed over heads
    reduce = mesh_reduce(mesh, heads, partial_grad=True)
    ms = reduce((g * g).sum(-1, keepdim=True), "sum") / d_inner
    y = (g * torch.rsqrt(ms + 1e-6) * vec["norm_scale"]).to(cd)
    w_out = local_part(cast_local(p["w_out"], cd), pl(0, heads), rows)
    out = from_local_parts(y @ w_out, mesh, pl(0, rows, heads),
                           (*x.shape[:-1], w_out.shape[-1]))
    return shard_act(out, "batch", None, "model", kind="resid")


def mamba2_block_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: dict):
    """Decode path. x: [B,1,D]; cache: {conv_state [B,K-1,C], ssm_state [B,H,P,N]}."""
    cd = dt(cfg.compute_dtype)
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    groups, eps = _groups(cfg), norm_eps(cfg)
    h = x.to(cd) @ p["w_in"].to(cd)
    z, xbc, dt_raw = _split_in(cfg, h)   # xbc [B,1,C]
    xi, bi, ci, new_conv = _conv(cfg, p, xbc, groups, cd, cache["conv_state"])

    dt_v = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = (-torch.exp(p["A_log"].float()) * dt_v)[:, 0]    # [B,H]
    xh = xi[:, 0].reshape(x.shape[0], n_heads, s.head_dim)
    x_dt = xh.float() * dt_v[:, 0, :, None]

    y, state = ssd_step(x_dt, a, bi[:, 0], ci[:, 0],
                        cache["ssm_state"].float())
    y = y + p["D"].float()[None, :, None] * xh.float()
    y = y.reshape(x.shape[0], 1, d_inner).to(cd)
    y = _rms(y * F.silu(z), p["norm_scale"], groups, eps)
    out = y.to(cd) @ p["w_out"].to(cd)
    return out, {"conv_state": new_conv, "ssm_state": state}
