"""Top-k routed mixture-of-experts with capacity-based dispatch: the JAX
package's ``models/moe.py`` on tensors.

As in the reference, there is no dense one-hot dispatch product: routing
builds a ``[B,E,C]`` table of token indices (a masked cumulative count gives
each (token, choice) its slot in its expert's buffer, one scatter writes the
table) and gathers both dispatch and combine, so the work stays at
``top_k * cf * T * D * F``. A group is one batch row. The experts are stacked
``[E, D, F]`` and run as one batched product over E.

The reference's ``shard_act`` annotations place the expert buffers on a
mesh (``repro_torch.sharding``); on plain tensors they do nothing.

Ties in the top-k: ``jax.lax.top_k`` puts the lower expert index first among
equal gates, and a slot depends on the order of a token's choices.
``torch.topk`` promises no order among equal values on CUDA, so the choices
come from a stable descending sort of the gates (equal gates keep their
index order), which is the reference's order on every device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import _act, _normal, dt, init_mlp, mlp
from repro_torch.sharding import (cast_local, from_local_parts, local_part,
                                  mesh_reduce, on_local_shards, shard_act,
                                  shard_index, sharding_dims, split_layout,
                                  spread, zero_gather_pays)


def _normal_stack(gen: torch.Generator, shape, scale, dtype, device) -> nn.Parameter:
    """``_normal`` drawn one leading slice at a time straight into the
    parameter on ``device``: the host holds one expert's f32 draw, never the
    whole stack (arctic's [128, 7168, 4864] would be 17.8 GB in f32). On
    ``meta`` nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(0 if out.is_meta else shape[0]):
        x = scale * torch.randn(shape[1:], generator=gen, dtype=torch.float32)
        out[i].copy_(x.to(dtype))
    return nn.Parameter(out)


def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> nn.ParameterDict:
    """router [D,E], stacked w_gate/w_up [E,D,F] and w_down [E,F,D], and the
    shared expert or dense residual MLP under ``shared``."""
    mc = cfg.moe
    assert mc is not None
    pd = dt(cfg.param_dtype)
    d, f, e = cfg.d_model, mc.d_ff, mc.n_experts
    p = nn.ParameterDict({
        "router": _normal(gen, (d, e), d ** -0.5, pd, device),
        "w_gate": _normal_stack(gen, (e, d, f), d ** -0.5, pd, device),
        "w_up": _normal_stack(gen, (e, d, f), d ** -0.5, pd, device),
        "w_down": _normal_stack(gen, (e, f, d), f ** -0.5, pd, device),
    })
    if mc.shared_expert or mc.dense_residual:
        p["shared"] = init_mlp(cfg, gen, d, f if mc.shared_expert else cfg.d_ff,
                               device)
    return p


def _capacity(mc: MoEConfig, tokens_per_group: int) -> int:
    c = int(mc.top_k * tokens_per_group * mc.capacity_factor / mc.n_experts)
    return max(c, 4)


def _routes(mc: MoEConfig, logits: torch.Tensor, capacity: int):
    """logits: [B,S,E] -> (expert_idx, probs, slot, keep [B,S,K], gates
    [B,S,E] f32, per_token [B,S,E]: each token's choices of each expert)."""
    e = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    order = torch.sort(gates, dim=-1, descending=True, stable=True)
    probs = order.values[..., :mc.top_k]                         # [B,S,K]
    expert_idx = order.indices[..., :mc.top_k]

    # Position of each (token, choice) inside its expert's buffer: masked
    # cumulative count over the sequence, counting earlier top-k slots first.
    onehot = F.one_hot(expert_idx, e)                            # [B,S,K,E]
    prior_slots = torch.cumsum(onehot, dim=2) - onehot           # same token
    per_token = onehot.sum(2)                                    # [B,S,E]
    prior_tokens = torch.cumsum(per_token, dim=1) - per_token    # earlier tokens
    pos = prior_tokens[:, :, None, :] + prior_slots              # [B,S,K,E]
    slot = (pos * onehot).sum(-1)                                # [B,S,K]
    keep = slot < capacity
    return expert_idx, probs, slot, keep, gates, per_token


def route(mc: MoEConfig, logits: torch.Tensor, capacity: int):
    """logits: [B,S,E] -> routing tables.

    Returns (expert_idx [B,S,K], probs [B,S,K], slot [B,S,K], keep [B,S,K],
    aux_loss scalar); indices are int64.
    """
    expert_idx, probs, slot, keep, gates, per_token = _routes(mc, logits,
                                                              capacity)
    # Load-balance aux loss (Switch-style).
    me = gates.mean(dim=(0, 1))                                  # [E]
    ce = per_token.float().mean(dim=(0, 1)) / mc.top_k
    aux = logits.shape[-1] * torch.sum(me * ce)
    return expert_idx, probs, slot, keep, aux


def _dispatch_table(flat_e: torch.Tensor, flat_slot: torch.Tensor, s: int,
                    k: int, e: int, cap: int) -> torch.Tensor:
    """[B, E*C] token indices of each expert's buffer from each (token,
    choice)'s expert and slot ([B, S*K]). Dropped (overflow) choices all
    write column ``cap``, which is sliced off (which of them lands there is
    arbitrary on CUDA and never read). Empty slots hold token 0: their
    expert rows are computed and never combined, as in the reference."""
    b = flat_e.shape[0]
    token_of_choice = torch.arange(s, device=flat_e.device).repeat_interleave(k)
    rows = torch.arange(b, device=flat_e.device)[:, None].expand(b, s * k)
    table = torch.zeros((b, e, cap + 1), dtype=torch.long, device=flat_e.device)
    table.index_put_((rows, flat_e, flat_slot),
                     token_of_choice.expand(b, s * k))
    return table[:, :, :cap].reshape(b, e * cap)


def _experts(act: str, xc, w_gate, w_up, w_down) -> torch.Tensor:
    """act(x @ Wg) * (x @ Wu) @ Wd per expert: xc [B,E,C,D] -> [B,E,C,D]."""
    up = torch.einsum("becd,edf->becf", xc, w_up)
    gate = _act(act, torch.einsum("becd,edf->becf", xc, w_gate))
    return torch.einsum("becf,efd->becd", gate * up, w_down)


def _combine(y_e, expert_idx, slot, keep, probs, cap: int,
             denom=None) -> torch.Tensor:
    """Each token's kept choices gathered back from the expert buffers
    y_e [B,E,C,D], weighted by their gates, in f32: [B,S,D]; the weights
    are normalized over the kept top-k (the llama4/arctic convention), or
    by ``denom`` [B,S,1] where given."""
    b, e, _, d = y_e.shape
    s, k = expert_idx.shape[1], expert_idx.shape[2]
    y = torch.zeros((b, s, d), dtype=torch.float32, device=y_e.device)
    flat_ec = expert_idx * cap + torch.clamp(slot, max=cap - 1)  # [B,S,K]
    y_flat = y_e.reshape(b, e * cap, d)
    for j in range(k):
        gj = torch.gather(y_flat, 1, flat_ec[:, :, j, None].expand(b, s, d))
        wj = (probs[:, :, j] * keep[:, :, j]).float()
        y = y + wj[..., None] * gj.float()
    if denom is None:
        denom = (probs * keep).sum(-1, keepdim=True)
    return y / torch.clamp(denom, min=1e-9)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (y [B,S,D], aux_loss). A DTensor ``x`` over more than
    one rank with enough rows a rank that gathering the experts' ZeRO
    shards pays takes ``_moe_sharded``; one rank and a decode step's few
    rows keep DTensor's plan."""
    if spread(x) and zero_gather_pays(x, p["w_gate"], 1):
        return _moe_sharded(cfg, p, x)
    mc = cfg.moe
    cd = dt(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = mc.n_experts, mc.top_k
    cap = _capacity(mc, s)

    logits = x.to(cd) @ p["router"].to(cd)    # a 2-D product, as remat sees it
    expert_idx, probs, slot, keep, aux = route(mc, logits, cap)

    # ----- dispatch: a [B,E,C] token-index table, then one gather ----------
    flat_e = expert_idx.reshape(b, s * k)
    flat_slot = torch.where(keep, slot, cap).reshape(b, s * k)
    # [B,E*C], built per batch row (on a mesh, each rank its own rows')
    idx = on_local_shards(
        lambda fe, fs: _dispatch_table(fe, fs, s, k, e, cap), flat_e, (0,),
        [(flat_e, (0, 1)), (flat_slot, (0, 1))], [(0, 1)])
    x_e = torch.gather(x, 1, idx[..., None].expand(b, e * cap, d))
    x_e = shard_act(x_e.reshape(b, e, cap, d), "batch", "model", None, None)
    xc = x_e.to(cd)

    # ----- expert FFNs (batched over E) -------------------------------------
    w = [p[n].to(cd) for n in ("w_gate", "w_up", "w_down")]
    y_e = on_local_shards(   # independent per (batch row, expert)
        lambda *a: _experts(cfg.act, *a), xc, (0, 1),
        [(xc, (0, 1, None, None))] + [(t, (1, None, None)) for t in w],
        [(0, 1, None, None)])
    y_e = shard_act(y_e, "batch", "model", None, None)

    # ----- combine: K gathers back to token order ---------------------------
    y = on_local_shards(   # per batch row, over every expert
        lambda *a: _combine(*a, cap), y_e, (0,),
        [(y_e, (0, None, None, None))]
        + [(t, (0, None, None)) for t in (expert_idx, slot, keep, probs)],
        [(0, None, None)]).to(x.dtype)
    if "shared" in p:
        y = y + mlp(cfg, p["shared"], x)
    y = shard_act(y, "batch", None, "model", kind="resid")
    return y, aux * mc.aux_loss_weight


def _moe_sharded(cfg: ModelConfig, p, x: DTensor) -> Tuple[DTensor, DTensor]:
    """The MoE on each rank's local tensors, laid out from the parameters'
    rules on any mesh. A group is one batch row, so once the block input is
    gathered over every mesh dim but the batch's each rank holds every
    token of its rows: it routes them (the router's ``data`` shard
    gathered; the same routes on every rank of a row), builds the dispatch
    table and the expert buffers of its own experts only (the experts'
    mesh dims cut E; the buffers never move, so the reference's all-to-all
    is not needed), runs those experts (each weight's ``data`` shard
    gathered) and combines its own experts' kept choices with the
    normalisation over all of a token's kept choices: exact partial sums
    over the experts' mesh dims, reduce-scattered into the residual layout.
    The aux loss is a partial sum too: each rank's experts' f32 means over
    the batch (all-reduced over its mesh dims) and the scalar all-reduced
    over the experts'. Every gradient of what all ranks of a row read (the
    block input, the router) is a partial sum over the experts' mesh dims,
    summed in the backward; the weights' reduce-scattered over the batch's.
    The shared expert or dense residual stays on ``mlp``."""
    mc = cfg.moe
    cd = dt(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = mc.n_experts, mc.top_k
    cap = _capacity(mc, s)
    mesh = x.device_mesh
    pl = functools.partial(split_layout, mesh.ndim)
    rows = sharding_dims(x, 0)
    experts = tuple(i for i in sharding_dims(p["w_gate"], 0) if i not in rows)
    w = [local_part(cast_local(p[n], cd), pl(0, experts), rows)
         for n in ("w_gate", "w_up", "w_down")]
    router = local_part(cast_local(p["router"], cd), pl(0, ()),
                        rows + experts)
    xl = local_part(x, pl(0, rows), experts)
    b_loc, e_loc = xl.shape[0], w[0].shape[0]
    e0 = shard_index(mesh, pl(0, experts), 0) * e_loc

    expert_idx, probs, slot, keep, gates, per_token = _routes(
        mc, xl.to(cd) @ router, cap)
    mine = (expert_idx >= e0) & (expert_idx < e0 + e_loc)
    own_idx = torch.where(mine, expert_idx - e0, torch.zeros_like(expert_idx))
    own_keep = keep & mine
    flat_slot = torch.where(own_keep, slot, cap).reshape(b_loc, s * k)
    idx = _dispatch_table(own_idx.reshape(b_loc, s * k), flat_slot, s, k,
                          e_loc, cap)
    x_e = torch.gather(xl, 1, idx[..., None].expand(b_loc, e_loc * cap, d))
    y_e = _experts(cfg.act, x_e.reshape(b_loc, e_loc, cap, d).to(cd), *w)
    y = _combine(y_e, own_idx, slot, own_keep, probs, cap,
                 denom=(probs * keep).sum(-1, keepdim=True)).to(x.dtype)

    # the aux loss: this rank's experts' terms of e * sum(me * ce)
    own = slice(e0, e0 + e_loc)
    sums = torch.stack([gates[..., own].sum(dim=(0, 1)),
                        per_token[..., own].float().sum(dim=(0, 1))])
    means = mesh_reduce(mesh, rows)(sums, "sum") / (b * s)
    aux = mesh_reduce(mesh, experts)(
        e * torch.sum(means[0] * means[1] / k), "sum")

    # the shared MLP before the reduce-scatter, so that a remat recompute
    # stops short of it (it saves nothing for the backward)
    shared = mlp(cfg, p["shared"], x) if "shared" in p else None
    y = shard_act(from_local_parts(y, mesh, pl(0, rows, experts), x.shape),
                  "batch", None, "model", kind="resid")
    if shared is not None:
        y = from_local_parts(y.to_local() + local_part(shared, y.placements),
                             mesh, y.placements, y.shape)
    return y, from_local_parts(aux * mc.aux_loss_weight, mesh,
                               pl(0, ()), ())
