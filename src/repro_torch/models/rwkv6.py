"""RWKV-6 "Finch" time-mix and channel-mix blocks (data-dependent decay).

Training/prefill uses the **chunked-parallel form**: within a chunk the
recurrence is expanded into products against cumulative-decay-rescaled r/k,
and the chunk-to-chunk state is carried by a Python loop over chunks. On the
card the CUDA kernel (``repro_torch.kernels.wkv6``) runs the whole
recurrence; ``rwkv_time_mix`` dispatches between them as the JAX package
does.

Numerics: decays are computed in log space; the chunk length
(``cfg.ssm.chunk``, 64 for rwkv6) bounds the growth of ``exp(-la)``. The
naive per-step loop ``repro_torch.kernels.ref.wkv6_ref`` is the test oracle.

Decode carries (shift_state [B,D], wkv_state [B,H,Dh,Dh]): O(1) in context.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _const, _normal, dt
from repro_torch.sharding import (act_spec, dividing_dims, from_local_parts,
                                  local_part, on_local_shards, placements,
                                  shard_act, sharding_dims, split_layout,
                                  spread)

LORA_RANK = 64


def init_rwkv_time_mix(cfg: ModelConfig, gen, device) -> nn.ParameterDict:
    pd = dt(cfg.param_dtype)
    d = cfg.d_model
    da = cfg.ssm.head_dim * (d // cfg.ssm.head_dim)  # attn dim == d_model here
    return nn.ParameterDict({
        "w_r": _normal(gen, (d, da), d ** -0.5, pd, device),
        "w_k": _normal(gen, (d, da), d ** -0.5, pd, device),
        "w_v": _normal(gen, (d, da), d ** -0.5, pd, device),
        "w_g": _normal(gen, (d, da), d ** -0.5, pd, device),
        "w_o": _normal(gen, (da, d), da ** -0.5, pd, device),
        # data-dependent decay LoRA:  w_t = exp(-exp(w0 + tanh(x A) B))
        "decay_A": _normal(gen, (d, LORA_RANK), d ** -0.5, pd, device),
        "decay_B": _normal(gen, (LORA_RANK, da), LORA_RANK ** -0.5, pd, device),
        "w0": _const(-0.6, (da,), pd, device),   # decay ~ exp(-exp(-0.6))
        "u": _normal(gen, (da,), 0.3, pd, device),  # per-channel bonus
        # token-shift interpolation coefficients (one per stream: r,k,v,g,w)
        "mu": _const(0.5, (5, d), pd, device),
        "ln_scale": _const(1.0, (da,), pd, device),  # per-head groupnorm scale
    })


def _token_shift(x: torch.Tensor, shift_state=None) -> torch.Tensor:
    """Previous-token stream: [B,S,D] -> [B,S,D] shifted by one."""
    if shift_state is None:
        first = torch.zeros_like(x[:, :1])
    else:
        first = shift_state[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x, prev, mu):
    return x + (prev - x) * mu


def wkv6_chunked(
    r: torch.Tensor,       # [B,T,H,K]
    k: torch.Tensor,       # [B,T,H,K]
    v: torch.Tensor,       # [B,T,H,K]
    logw: torch.Tensor,    # [B,T,H,K]  log decay, <= 0
    u: torch.Tensor,       # [H,K]
    state0: torch.Tensor,  # [B,H,K,K]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6. Returns (out [B,T,H,K] in r's dtype, state [B,H,K,K])."""
    b, t, h, kk = r.shape
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    n = t // chunk

    rs = r.reshape(b, n, chunk, h, kk).float()
    ks = k.reshape(b, n, chunk, h, kk).float()
    vs = v.reshape(b, n, chunk, h, kk).float()
    lw = logw.reshape(b, n, chunk, h, kk).float()
    uf = u.float()

    causal = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)  # strict
    eye = torch.eye(chunk, device=r.device)

    state = state0.float()
    outs = []
    for i in range(n):
        rc, kc, vc, lwc = rs[:, i], ks[:, i], vs[:, i], lw[:, i]  # [B,C,H,K]
        la = torch.cumsum(lwc, dim=1)        # inclusive cumulative log decay
        la_prev = la - lwc                   # decay up to t-1
        r_dec = rc * torch.exp(la_prev)      # rescaled receptance (<= |r|)
        # intra-chunk pairwise scores, numerically exact: for kept (strictly
        # causal) pairs the exponent la_prev_t - la_tau <= 0, so clamping at
        # 0 before exp changes nothing; it only keeps the masked upper
        # triangle finite. [B,C,C,H,K] is bounded by the chunk size.
        diff = torch.clamp(la_prev[:, :, None] - la[:, None, :], max=0.0)
        scores = torch.einsum("bthk,bshk,btshk->bhts", rc, kc, torch.exp(diff))
        scores = scores * causal[None, None]
        diag = torch.einsum("bthk,hk,bthk->bht", rc, uf, kc)
        scores = scores + diag[..., None] * eye[None, None]
        out = torch.einsum("bhts,bshk->bthk", scores, vc)
        # inter-chunk: contribution from the carried state
        out = out + torch.einsum("bthk,bhkj->bthj", r_dec, state)
        # state update to the chunk end
        total = la[:, -1]                    # [B,H,K]
        k_fut = kc * torch.exp(total[:, None] - la)
        state = state * torch.exp(total)[..., None] + torch.einsum(
            "bthk,bthj->bhkj", k_fut, vc)
        outs.append(out)
    out = torch.stack(outs, dim=1).reshape(b, t, h, kk)
    return out.to(r.dtype), state


def wkv6_step(r, k, v, logw, u, state):
    """Single-token recurrence (decode). r/k/v/logw: [B,H,K]; state [B,H,K,K]."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    kv = torch.einsum("bhk,bhj->bhkj", kf, vf)
    out = torch.einsum("bhk,bhkj->bhj", rf,
                       state + u.float()[None, :, :, None] * kv)
    state = state * w[..., None] + kv
    return out.to(r.dtype), state


def _project_streams(cfg: ModelConfig, p, x, prev):
    cd = dt(cfg.compute_dtype)
    k_dim = cfg.ssm.head_dim

    def heads(y):
        return y.reshape(*y.shape[:-1], -1, k_dim)

    mu = p["mu"].float()
    xs = [_mix(x, prev, mu[i]).to(cd) for i in range(5)]
    r = heads(xs[0] @ p["w_r"].to(cd))
    k = heads(xs[1] @ p["w_k"].to(cd))
    v = heads(xs[2] @ p["w_v"].to(cd))
    g = F.silu(xs[3] @ p["w_g"].to(cd))
    lora = torch.tanh(xs[4].float() @ p["decay_A"].float())
    logw = -torch.exp(p["w0"].float() + lora @ p["decay_B"].float())
    return r, k, v, g, heads(logw)


def _group_norm(o: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS normalization of wkv output. o: [B,T,H,K] -> [B,T,H*K] f32."""
    of = o.float()
    ms = (of * of).mean(-1, keepdim=True)
    of = of * torch.rsqrt(ms + 1e-5)
    return of.reshape(*o.shape[:-2], -1) * scale.float()


def rwkv_time_mix(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill path. x: [B,S,D]. A DTensor ``x`` over more than one
    rank takes the plain recurrence on each rank's own heads
    (``_time_mix_sharded``); the kernel refuses DTensors."""
    if spread(x) and not cfg.use_kernels:
        return _time_mix_sharded(cfg, p, x)
    return _time_mix_local(cfg, p, x)


def _time_mix_local(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The time mix of ``x`` [B,S,D] with the parameters ``p`` (the block's,
    or the columns of its heads that one rank holds: w_r/k/v/g [D, Da],
    w_o [Da, D], decay_B [R, Da], w0, u, ln_scale [Da])."""
    cd = dt(cfg.compute_dtype)
    prev = _token_shift(x)
    r, k, v, g, logw = _project_streams(cfg, p, x, prev)
    h = r.shape[2]
    u = p["u"].float().reshape(h, cfg.ssm.head_dim)
    if cfg.use_kernels:
        from repro_torch.kernels import ops  # deferred: kernels are optional

        out = ops.wkv6(r, k, v, logw, u, chunk=cfg.ssm.chunk)
    else:
        state0 = torch.zeros((x.shape[0], h, cfg.ssm.head_dim,
                              cfg.ssm.head_dim), device=x.device)
        bthk = (0, None, 2, None)
        out, _ = on_local_shards(   # independent per (batch row, head)
            lambda *a: wkv6_chunked(*a, cfg.ssm.chunk), r, (0, 2),
            [(t, bthk) for t in (r, k, v, logw)]
            + [(u, (2, None)), (state0, (0, 2, None, None))],
            [bthk, (0, 2, None, None)])
    out = _group_norm(out, p["ln_scale"]).to(cd) * g
    y = out @ p["w_o"].to(cd)
    return shard_act(y, "batch", None, "model", kind="resid")


def _time_mix_sharded(cfg: ModelConfig, p, x: DTensor) -> DTensor:
    """The time mix on each rank's local tensors, laid out from the rules:
    the streams' projections column-parallel over the mesh dims that shard
    w_r's columns (whole heads on each rank), the output projection
    row-parallel, as ``layers._mlp_sharded`` lays out the MLP. The block
    input is gathered (compute dtype) over every mesh dim but the batch's,
    the weights over every mesh dim but the heads'; the per-head vectors
    and the decay LoRA's B are cut to the local heads, the LoRA's A and the
    token-shift mixes read whole. Each rank's recurrence and group norm run
    on its own heads; the output, a partial sum over the heads' shards, is
    reduce-scattered into the residual layout, and every gradient of an
    input or parameter that all ranks read comes back summed."""
    cd = dt(cfg.compute_dtype)
    mesh = x.device_mesh
    pl = functools.partial(split_layout, mesh.ndim)
    rows = sharding_dims(x, 0)
    heads = cfg.d_model // cfg.ssm.head_dim
    cols = dividing_dims(mesh, [i for i in sharding_dims(p["w_r"], 1)
                                if i not in rows], heads)
    every = rows + cols
    loc = {}
    for name in ("w_r", "w_k", "w_v", "w_g"):
        loc[name] = local_part(p[name].to(cd), pl(1, cols), rows)
    loc["w_o"] = local_part(p["w_o"].to(cd), pl(0, cols), rows)
    loc["decay_B"] = local_part(p["decay_B"].float(), pl(1, cols), rows)
    for name in ("w0", "u", "ln_scale"):
        loc[name] = local_part(p[name].float(), pl(0, cols), rows)
    for name in ("decay_A", "mu"):
        loc[name] = local_part(p[name].float(), pl(0, ()), every)
    y = _time_mix_local(cfg, loc, local_part(x, pl(0, rows), cols))
    y = from_local_parts(y, mesh, pl(0, rows, cols),
                         (*x.shape[:-1], p["w_o"].shape[-1]))
    return shard_act(y, "batch", None, "model", kind="resid")


def rwkv_time_mix_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: dict):
    """Decode path. x: [B,1,D]; cache: {shift_state [B,D], wkv_state [B,H,K,K]}."""
    cd = dt(cfg.compute_dtype)
    h = cfg.d_model // cfg.ssm.head_dim
    prev = cache["shift_state"][:, None, :].to(x.dtype)
    r, k, v, g, logw = _project_streams(cfg, p, x, prev)
    u = p["u"].float().reshape(h, cfg.ssm.head_dim)
    bhk = (0, 1, None)
    out, state = on_local_shards(   # independent per (batch row, head)
        wkv6_step, r[:, 0], (0, 1),
        [(t[:, 0], bhk) for t in (r, k, v, logw)]
        + [(u, (1, None)), (cache["wkv_state"].float(), (0, 1, None, None))],
        [bhk, (0, 1, None, None)])
    out = _group_norm(out[:, None], p["ln_scale"]).to(cd) * g
    y = out @ p["w_o"].to(cd)
    return y, {"shift_state": x[:, 0], "wkv_state": state}


# ---------------------------------------------------------------------------
# Channel mix (RWKV FFN)
# ---------------------------------------------------------------------------

def init_rwkv_channel_mix(cfg: ModelConfig, gen, device) -> nn.ParameterDict:
    pd = dt(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    return nn.ParameterDict({
        "w_k": _normal(gen, (d, f), d ** -0.5, pd, device),
        "w_v": _normal(gen, (f, d), f ** -0.5, pd, device),
        "w_r": _normal(gen, (d, d), d ** -0.5, pd, device),
        "mu": _const(0.5, (2, d), pd, device),  # k, r
    })


def rwkv_channel_mix(cfg: ModelConfig, p, x: torch.Tensor, shift_state=None):
    if spread(x):
        return _channel_mix_sharded(cfg, p, x, shift_state)
    cd = dt(cfg.compute_dtype)
    r, kv = _channel_mix_local(p, x, _token_shift(x, shift_state), cd)
    return shard_act(r * kv, "batch", None, "model", kind="resid")


def _channel_mix_local(p, x, prev, cd):
    """(the receptance, the value product) of the channel mix, from the
    block's weights or one rank's columns of them: w_k [D, F], w_v [F, D],
    w_r [D, D]."""
    mu = p["mu"].float()
    xk = _mix(x, prev, mu[0]).to(cd)
    xr = _mix(x, prev, mu[1]).to(cd)
    k = torch.square(F.relu(xk @ p["w_k"].to(cd)))
    k = shard_act(k, "batch", None, "model")
    r = torch.sigmoid(xr @ p["w_r"].to(cd))
    return r, k @ p["w_v"].to(cd)


def _channel_mix_sharded(cfg: ModelConfig, p, x: DTensor, shift_state=None):
    """The channel mix on each rank's local tensors. Its weights are
    replicated by the rules; each rank reads the columns of the mesh dims
    that shard the residual's d_model (when they divide d_ff too): w_k's
    and w_r's columns, w_v's rows, a local cut that moves nothing. The
    block input is gathered over every mesh dim but the batch's; the value
    product, a partial sum over the d_ff shards, is reduce-scattered onto
    the receptance's columns, which are the residual's."""
    cd = dt(cfg.compute_dtype)
    mesh = x.device_mesh
    pl = functools.partial(split_layout, mesh.ndim)
    rows = sharding_dims(x, 0)
    resid = placements(mesh, act_spec(mesh, x.shape, "batch", None, "model",
                                      kind="resid"))
    d = x.ndim - 1
    cols = dividing_dims(mesh, [i for i, q in enumerate(resid)
                                if q == Shard(d) and i not in rows], cfg.d_ff)
    loc = {"w_k": local_part(p["w_k"].to(cd), pl(1, cols), rows),
           "w_r": local_part(p["w_r"].to(cd), pl(1, cols), rows),
           "w_v": local_part(p["w_v"].to(cd), pl(0, cols), rows),
           "mu": local_part(p["mu"].float(), pl(0, ()), rows + cols)}
    xl = local_part(x, pl(0, rows), cols)
    prev = None if shift_state is None else \
        local_part(shift_state, pl(0, rows), cols)
    r, kv = _channel_mix_local(loc, xl, _token_shift(xl, prev), cd)
    shape = (*x.shape[:-1], p["w_v"].shape[-1])
    kv = shard_act(from_local_parts(kv, mesh, pl(0, rows, cols), shape),
                   "batch", None, "model", kind="resid")
    r = from_local_parts(r, mesh, pl(d, cols, batch=rows), shape)
    return shard_act(r * kv, "batch", None, "model", kind="resid")
