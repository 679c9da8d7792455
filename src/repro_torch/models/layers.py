"""Shared neural-net building blocks.

Parameters are ``nn.ParameterDict``s keyed and shaped as the JAX package's
parameter dicts (``p["scale"]``, ``p["w_up"]`` [D, F], ...), so every function
here reads like its JAX counterpart and carrying weights across is a copy.
Params live in ``cfg.param_dtype``; compute casts to ``cfg.compute_dtype``
(bf16 by default) with f32 where it matters (norms, rope, logits).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.spans import span
from repro_torch.sharding import (current_mesh, embed_sharded,
                                  from_local_parts, local_part, mesh_reduce,
                                  on_local_shards, shard_act, shard_index,
                                  sharding_dims, split_layout, spread,
                                  stacked_reduce, zero_gather_pays)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(gen: torch.Generator, shape, scale, dtype, device) -> nn.Parameter:
    """``scale`` times standard normals from ``gen`` (drawn in f32 on the
    host, then cast and moved). On ``meta`` nothing is drawn: the abstract
    state of the dry-run has shapes and dtypes only."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))
    x = scale * torch.randn(shape, generator=gen, dtype=torch.float32)
    return nn.Parameter(x.to(device=device, dtype=dtype))


def _const(value: float, shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Rematerialisation (the reference's ``_remat``)
# ---------------------------------------------------------------------------

# The products with no batch dimensions, which the reference's "dots" policy
# (``checkpoint_dots_with_no_batch_dims``) saves: every projection reaches
# ``aten.mm`` (a [B, S, D] @ [D, N] folds its rows); attention's and the
# experts' products carry batch dimensions (``aten.bmm``) and are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn):
    """``fn`` under the config's remat policy (``cfg.remat``), as the
    reference's ``_remat`` wraps a block in ``jax.checkpoint``: "none" is
    ``fn``; "full" keeps only the call's inputs for the backward and
    recomputes the rest (non-reentrant ``torch.utils.checkpoint``, which
    stops recomputing once the backward has what it needs, as XLA drops a
    dead recompute); "dots" also keeps the outputs of the 2-D products
    (``_DOTS``). Outside grad mode (serving, decode, the kernels' forwards)
    every policy is ``fn`` itself. No forward draws random numbers, so no
    RNG state is kept (which also lets meta tensors through)."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    extra = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
        if policy == "dots" else {})

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dim: int, device) -> nn.ParameterDict:
    pd = dt(cfg.param_dtype)
    p = nn.ParameterDict({"scale": _const(1.0, (dim,), pd, device)})
    if cfg.norm == "layernorm":
        p["bias"] = _const(0.0, (dim,), pd, device)
    return p


def _split(t: torch.Tensor, dim: int) -> int:
    """The number of ranks that share dim ``dim`` of ``t`` (1 for a plain
    tensor). Where it is 1 the norm and the loss keep the single device's
    arithmetic, bit for bit (``sharding.spread`` says why)."""
    if not isinstance(t, DTensor):
        return 1
    return math.prod(t.device_mesh.size(i) for i in sharding_dims(t, dim))


def _row_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean(-1, keepdim=True)``. On a DTensor, a sum over the last dim
    divided by its size, then replicated over the model axis: DTensor keeps
    a sharded mean average-partial under a subtraction, and the backward
    then meets sum-partial gradients it cannot convert to average-partial."""
    if isinstance(t, DTensor):
        return shard_act(t.sum(-1, keepdim=True) / t.shape[-1],
                         "batch", None, None)
    return t.mean(-1, keepdim=True)


def _norm_sharded(xf: DTensor, scale: torch.Tensor,
                  bias=None) -> DTensor:
    """The RMS norm of ``xf`` (f32) whose last dim the mesh shards (the
    layer norm where ``bias`` is given), on each rank's own shards: the
    row statistics are sums over the local columns all-reduced over the
    mesh dims that shard them (a [..., 1] f32 tensor; the reference's GSPMD
    plan), whose gradient is all-reduced back, since each rank normalises
    only its own columns with them. The activations never move; the scale
    and bias are cut to the local columns (their gradients summed over the
    batch's mesh dims)."""
    d = xf.ndim - 1
    mesh, n = xf.device_mesh, xf.shape[d]
    cols = sharding_dims(xf, d)
    reduce = mesh_reduce(mesh, cols, partial_grad=True)
    pl = split_layout(mesh.ndim, 0, cols)
    rows = tuple(i for i, q in enumerate(xf.placements)
                 if i not in cols and q.is_shard())
    xl = xf.to_local()
    if bias is None:
        ms = reduce((xl * xl).sum(-1, keepdim=True), "sum") / n
        y = xl * torch.rsqrt(ms + 1e-6) * local_part(scale.float(), pl, rows)
    else:
        xl = xl - reduce(xl.sum(-1, keepdim=True), "sum") / n
        var = reduce((xl * xl).sum(-1, keepdim=True), "sum") / n
        y = xl * torch.rsqrt(var + 1e-5) * local_part(scale.float(), pl, rows) \
            + local_part(bias.float(), pl, rows)
    return from_local_parts(y, mesh, xf.placements, xf.shape)


def norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    with span("norm"):
        xf = x.float()
        # Keep the f32 widening sharded like the residual stream.
        xf = shard_act(xf, "batch", None, "model", kind="resid")
        if _split(xf, xf.ndim - 1) > 1:
            y = _norm_sharded(xf, p["scale"],
                              p["bias"] if cfg.norm == "layernorm" else None)
        elif cfg.norm == "layernorm":
            mu = _row_mean(xf)
            var = _row_mean((xf - mu) ** 2)
            y = (xf - mu) * torch.rsqrt(var + 1e-5)
            y = y * p["scale"].float() + p["bias"].float()
        else:  # rmsnorm
            ms = (xf * xf).mean(-1, keepdim=True)
            y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
        return shard_act(y.to(x.dtype), "batch", None, "model", kind="resid")


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
    """``table[tokens]`` in the compute dtype, in the residual layout on a
    mesh (``sharding.embed_sharded``: the vocab partials reduce-scattered
    straight into it)."""
    table, cd = p["table"], dt(cfg.compute_dtype)
    if isinstance(table, DTensor):
        y = embed_sharded(table, tokens, cd)
    else:
        y = table[tokens].to(cd)
    return shard_act(y, "batch", None, "model", kind="resid")


def unembed(cfg: ModelConfig, p, x: torch.Tensor, *, tied_table=None):
    """Project to vocab logits (f32). On a mesh the input's model dim is
    gathered first (in the compute dtype), so that each rank's product
    yields its vocab columns whole: a product over a sharded model dim
    would leave f32 partial sums of every column to reduce-scatter, and
    their gradient to gather back."""
    if tied_table is not None:
        w = tied_table.to(dt(cfg.compute_dtype)).T  # [D, V]
    else:
        w = p["kernel"].to(dt(cfg.compute_dtype))
    if spread(x) and zero_gather_pays(x, w):
        # column-parallel over the vocab, as ``_mlp_sharded`` lays out its
        # up projection: the weight's d_model shards gathered
        mesh, d = x.device_mesh, x.ndim - 1
        pl = functools.partial(split_layout, mesh.ndim)
        rows = sharding_dims(x, 0)
        cols = tuple(i for i in sharding_dims(w, 1) if i not in rows)
        y = local_part(x, pl(0, rows), cols) @ local_part(w, pl(1, cols),
                                                          rows)
        return from_local_parts(y.float(), mesh, pl(d, cols, batch=rows),
                                (*x.shape[:-1], w.shape[-1]))
    x = shard_act(x, "batch", None, None)
    return shard_act((x @ w).float(), "batch", None, "model")


def vocab_partial(x: torch.Tensor, labels: torch.Tensor, v0=0):
    """The log-likelihood's partials over one slice of the vocab: ``x``
    [..., V_slice] holds the logits of columns ``v0 ..`` (``v0`` an int, or
    a tensor that broadcasts against ``labels``). Returns (m, the slice's
    largest logit, no gradient; s, the sum of ``exp(x - m)``; the label's
    logit where the slice holds the label, else 0), each [...].
    ``combine_vocab_partials`` joins the slices."""
    m = x.detach().amax(-1)
    s = torch.exp(x - m[..., None]).sum(-1)
    rel = labels - v0
    hit = (rel >= 0) & (rel < x.shape[-1])
    picked = torch.gather(x, -1, rel.clamp(0, x.shape[-1] - 1)[..., None])
    return m, s, torch.where(hit, picked[..., 0], torch.zeros_like(m))


def combine_vocab_partials(m: torch.Tensor, s: torch.Tensor,
                           x_label: torch.Tensor,
                           reduce=stacked_reduce) -> torch.Tensor:
    """``log_softmax(x)[label]`` from the slices' partials
    (``vocab_partial``): ``reduce(t, op)`` takes the max or the sum over the
    slices, of partials stacked on dim 0 by default, across the ranks that
    hold them on a mesh (``sharding.mesh_reduce``). The max carries no
    gradient (it cancels); the gradient on each slice is ``onehot -
    softmax`` of its own columns."""
    m_all = reduce(m, "max")
    s_all = reduce(s * torch.exp(m - m_all), "sum")
    return reduce(x_label, "sum") - m_all - torch.log(s_all)


def log_likelihood(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)[label]`` in f32: [..., V] and [...] -> [...].
    Logits sharded on the vocab over more than one rank (evenly:
    ``unembed``'s layout on a mesh, the reference's vocab-parallel head)
    stay sharded: each rank's partials over its columns (``vocab_partial``)
    are combined by all-reduces over the vocab's mesh dims
    (``combine_vocab_partials``). Anything else, a vocab that one rank
    holds whole included, takes ``torch.log_softmax`` and a gather, bit for
    bit the single-device arithmetic: the optimizer's first steps move a
    weight by about ``lr * g / (|g| + eps)``, which turns a last-bit change
    in a gradient near 0 into a visible one in the weight."""
    with span("lm.log_likelihood"):
        x = logits.float()
        d = x.ndim - 1
        dims = sharding_dims(x, d)
        if _split(x, d) == 1:
            logp = torch.log_softmax(x, dim=-1)
            return torch.gather(logp, -1, labels[..., None].long())[..., 0]
        mesh = x.device_mesh
        shard = shard_index(mesh, x.placements, d)
        reduce = mesh_reduce(mesh, dims)

        def local(xl, lab):
            parts = vocab_partial(xl, lab.long(), shard * xl.shape[-1])
            return combine_vocab_partials(*parts, reduce)

        lead = tuple(range(d))
        return on_local_shards(local, x, (0, d),
                               [(x, lead + (d,)), (labels, lead)], [lead])


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


def sinusoidal_positions(n: int, dim: int, device=None) -> torch.Tensor:
    """[n, dim] f32: sin over the first half of the columns, cos over the
    second (Whisper's encoder positions)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    inv = 1.0 / (10_000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                           device=device) / dim))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    """The JAX ``mlp``. With ``mlp_tp_overlap`` and a ``model`` axis
    installed (``sharding.use_sharding_rules``) that divides the sequence,
    a gated MLP on DTensors takes the Relic ring (``mlp_ring``: fused
    all-gather of gate+up, reduce-scatter of down, each transfer overlapping
    the previous chunk's matmul; its backward runs the dual rings). ``bf16_reduce`` changes
    nothing here since torch's bf16 matmul already returns bf16."""
    with span("mlp"):
        cd = dt(cfg.compute_dtype)
        x = x.to(cd)
        if cfg.mlp_tp_overlap and cfg.gated_mlp:
            from repro_torch.core import collective_matmul as cm

            mesh = current_mesh()
            if isinstance(x, DTensor) and cm.ring_eligible(mesh, x.shape[1]):
                return cm.mlp_ring(cfg.act, x, p["w_gate"].to(cd),
                                   p["w_up"].to(cd), p["w_down"].to(cd), mesh)
        w_up, w_down = p["w_up"].to(cd), p["w_down"].to(cd)
        w_gate = p["w_gate"].to(cd) if cfg.gated_mlp else None
        if spread(x) and zero_gather_pays(x, w_up):
            return _mlp_sharded(cfg, x, w_up, w_down, w_gate)
        # One device or one rank; or a few rows a rank (a decode step), where
        # moving the weights would cost more than moving the activations:
        # DTensor's plan.
        x = shard_act(x, "batch", None, None, kind="blockin")
        y = _mlp_local(cfg, x, w_up, w_down, w_gate)
        return shard_act(y, "batch", None, "model", kind="resid")


def _mlp_local(cfg: ModelConfig, x, w_up, w_down, w_gate=None):
    up = x @ w_up
    h = _act(cfg.act, x @ w_gate) * up if w_gate is not None \
        else _act(cfg.act, up)
    h = shard_act(h, "batch", None, "model")
    return h @ w_down


def _mlp_sharded(cfg: ModelConfig, x: DTensor, w_up: DTensor,
                 w_down: DTensor, w_gate=None) -> DTensor:
    """Megatron's column- then row-parallel MLP on each rank's local
    tensors, laid out from the parameters' rules (``param_placements``) on
    any mesh: the block input gathered over every mesh dim but its batch
    dims, in the compute dtype; each weight gathered over every mesh dim
    but those that shard d_ff (the ZeRO-3 gather of its ``data`` shard).
    The hidden stays sharded on d_ff and never moves; the down product is
    a partial sum over the d_ff shards, reduce-scattered into the residual
    layout. The backward runs the duals: the output's gradient gathered,
    the input's reduce-scattered over the d_ff mesh dims, each weight's
    reduce-scattered over the batch mesh dims."""
    mesh = x.device_mesh
    rows = sharding_dims(x, 0)
    cols = tuple(i for i in sharding_dims(w_up, 1) if i not in rows)
    pl = functools.partial(split_layout, mesh.ndim)
    w_in = [local_part(w, pl(1, cols), rows) for w in (w_up, w_gate)
            if w is not None]
    y = _mlp_local(cfg, local_part(x, pl(0, rows), cols), w_in[0],
                   local_part(w_down, pl(0, cols), rows), *w_in[1:])
    y = from_local_parts(y, mesh, pl(0, rows, cols),
                         (*x.shape[:-1], w_down.shape[-1]))
    return shard_act(y, "batch", None, "model", kind="resid")
