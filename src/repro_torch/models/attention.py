"""GQA attention: full, chunked (flash-style streaming softmax in plain
torch), and cached decode paths, plus cross-attention for encoder-decoder
models.

The chunked path is the portable flash attention: a loop over KV blocks
carrying the running (max, denominator, accumulator), so long sequences run
without materializing S x S scores. On the card the CUDA kernel
(``repro_torch.kernels.flash_attention``) is the fast path; ``attention_core``
dispatches between them exactly as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _const, _normal, apply_rope, dt, rms_norm_headwise
from repro_torch.runtime.spans import span
from repro_torch.sharding import (from_local_parts, local_part, mesh_reduce,
                                  on_local_shards, shard_act, shard_index,
                                  sharding_dims, split_layout, spread,
                                  stacked_reduce, zero_gather_pays)

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


def attention_partial(
    q: torch.Tensor,          # [B,Sq,H,Dh]
    k: torch.Tensor,          # [B,Tk,Kv,Dh], positions t0 .. t0 + Tk
    v: torch.Tensor,          # [B,Tk,Kv,Dh]
    *,
    t0: int = 0,
    kv_len: Optional[int] = None,
):
    """The softmax partials of ``q`` over one slice of the keys' time axis
    (flash-decoding's split-T), no causal mask: (o [B,Sq,H,Dh], the sum of
    ``exp(s - m) v`` unnormalised; m [B,Sq,H], the slice's largest score;
    l [B,Sq,H], the sum of ``exp(s - m)``), all f32. Global positions
    ``t0 + j`` at or past ``kv_len`` score ``NEG_INF``, as in
    ``attention_full``. ``combine_partials`` joins the slices."""
    n_kv = k.shape[2]
    qg = _grouped(q, n_kv)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float() * scale, k.float())
    if kv_len is not None:
        kpos = t0 + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(kpos < kv_len), NEG_INF)
    m = s.amax(-1)                                      # [B,Kv,G,Sq]
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    b, sq, h, _ = q.shape

    def per_head(t):                                    # -> [B,Sq,H]
        return t.permute(0, 3, 1, 2).reshape(b, sq, h)

    return o.reshape(q.shape), per_head(m), per_head(p.sum(-1))


def combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     reduce=stacked_reduce) -> torch.Tensor:
    """The attention output (f32) from the slices' partials
    (``attention_partial``): ``reduce(t, op)`` takes the max or the sum over
    the slices, of partials stacked on dim 0 by default, across the ranks
    that hold the slices on a mesh (``sharding.mesh_reduce``). Each slice is
    rescaled by ``exp(m - max m)``."""
    m_all = reduce(m, "max")
    c = torch.exp(m - m_all)
    l_all = reduce(l * c, "sum")
    o_all = reduce(o * c[..., None], "sum")
    return o_all / l_all[..., None]


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


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, h0: int, h_loc: int,
                  group: int, dim: int = 2):
    """The kv heads (dim ``dim`` of ``k`` and ``v``) that local q heads
    ``h0 .. h0 + h_loc`` read (global q head ``h`` reads kv head
    ``h // group``), laid out so that the local call's own GQA grouping
    maps local head ``j`` to its kv head: a contiguous slice where the
    heads split evenly, else one kv head per q head."""
    want = [(h0 + j) // group for j in range(h_loc)]
    lo, n = want[0], want[-1] - want[0] + 1
    if h_loc % n == 0 and all(w - lo == j // (h_loc // n)
                              for j, w in enumerate(want)):
        return k.narrow(dim, lo, n), v.narrow(dim, lo, n)
    idx = torch.tensor(want, device=k.device)
    return k.index_select(dim, idx), v.index_select(dim, idx)


def _per_head_shard(fn, q: DTensor, k, v) -> DTensor:
    """``fn`` on each rank's local tensors: q keeps its batch (dim 0) and
    head (dim 2) sharding, so each rank computes its own heads of its own
    batch rows; k and v are batch-sharded, replicated over every other mesh
    dim (their gradients partial there), and cut to the kv heads of this
    rank's q heads. The result keeps q's layout. (Local tensors: DTensor's
    einsum rules cannot flatten a sharded dim on every release.)"""
    h, n_kv = q.shape[2], k.shape[2]
    h0 = shard_index(q.device_mesh, q.placements, 2)

    def local(ql, kl, vl):
        h_loc = ql.shape[2]
        if h_loc < h:
            kl, vl = _kv_for_heads(kl, vl, h0 * h_loc, h_loc, h // n_kv)
        return fn(ql, kl, vl)

    bshd, batch = (0, 1, 2, 3), (0, None, None, None)
    return on_local_shards(local, q, (0, 2), [(q, bshd), (k, batch),
                                              (v, batch)], [bshd])


def _split_t_dims(k: torch.Tensor, v: torch.Tensor):
    """The mesh dims that shard k's and v's time axis (dim 1), as
    ``distribute_cache`` lays out (evenly) a cache whose T the ``model``
    axis divides; empty where they do not."""
    if not isinstance(v, DTensor) or v.placements != k.placements:
        return ()
    return sharding_dims(k, 1)


def _split_t(q: DTensor, k: DTensor, v: DTensor, dims,
             kv_len: Optional[int]) -> DTensor:
    """Attention against a cache whose time axis the mesh dims ``dims``
    shard, the cache left where it is: q is laid out on the cache's batch
    sharding with its heads whole (a few KB), each rank computes the
    partials over its own slice (global positions ``t0 + j``), and the
    partials are combined by all-reduces over ``dims``. The result takes
    q's layout again (a partial sum in q's layout is replicated there)."""
    mesh = k.device_mesh
    shard = shard_index(mesh, k.placements, 1)
    reduce = mesh_reduce(mesh, dims)

    def local(ql, kl, vl):
        o, m, l = attention_partial(ql, kl, vl, t0=shard * kl.shape[1],
                                    kv_len=kv_len)
        return combine_partials(o, m, l, reduce).to(ql.dtype)

    bthd, batch = (0, 1, 2, 3), (0, None, None, None)
    o = on_local_shards(local, k, (0, 1), [(q, batch), (k, bthd), (v, bthd)],
                        [batch])
    return o.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in q.placements])


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
    """Dispatch: kernels > chunked (long S) > full. DTensors (a sharded
    forward) take the plain paths on each rank's local q heads and batch
    rows (``_per_head_shard``), or, against a cache whose time axis is
    sharded, split-T on each rank's slice (``_split_t``): the kernels
    refuse them."""
    sq, sk = q.shape[1], k.shape[1]
    if cfg.use_kernels and sq > 1 and prefix_len is None:
        from repro_torch.kernels import ops  # deferred: kernels are optional

        return ops.flash_attention(q, k, v, causal=causal)
    if isinstance(q, DTensor) and not causal and prefix_len is None:
        dims = _split_t_dims(k, v)
        if dims:
            return _split_t(q, k, v, dims, kv_len)
    if isinstance(q, DTensor):
        return _per_head_shard(
            lambda q_, k_, v_: attention_core(
                cfg, q_, k_, v_, causal=causal, q_offset=q_offset,
                kv_len=kv_len, prefix_len=prefix_len), q, k, v)
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

def _heads_gathered(y: DTensor, h: int) -> DTensor:
    """``y`` [B, S, H*Dh] with its flat heads dim gathered over each mesh dim
    that shards it but does not divide the ``h`` heads (DTensor cannot
    unflatten such a dim)."""
    mesh = y.device_mesh
    bad = [isinstance(pl, Shard) and pl.dim == 2 and h % mesh.size(i) != 0
           for i, pl in enumerate(y.placements)]
    if not any(bad):
        return y
    return y.redistribute(mesh, [Replicate() if b else pl
                                 for b, pl in zip(bad, y.placements)])


class _GatheredHeadsGrad(torch.autograd.Function):
    """The identity, whose gradient gets ``_heads_gathered`` before the
    backward of a heads flatten unflattens it."""

    @staticmethod
    def forward(ctx, y, h):
        ctx.h = h
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _heads_gathered(g, ctx.h), None


def _to_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as a product with the heads flattened, a 2-D
    product (``aten.mm``, which remat's "dots" keeps; torch's einsum would
    reach a batch-1 ``aten.bmm``), then the heads unflattened. On DTensors
    the flat dim is gathered first where it must be."""
    d, h, hd = w.shape
    y = x @ w.reshape(d, h * hd)
    if isinstance(y, DTensor):
        y = _heads_gathered(y, h)
    return y.unflatten(2, (h, hd))


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor,
                 x_kv: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``x_kv`` (cross-attention) or ``x``."""
    cd = dt(cfg.compute_dtype)
    x = shard_act(x.to(cd), "batch", None, None, kind="blockin")
    src = x if x_kv is None else x_kv.to(cd)
    q = _to_heads(x, p["wq"].to(cd))
    k = _to_heads(src, p["wk"].to(cd))
    v = _to_heads(src, p["wv"].to(cd))
    # On a mesh the heads are laid out first, so that each head's products
    # are whole where the qk-norm takes its sums over the head dim (which no
    # rank splits): the norm then moves nothing.
    q = shard_act(q, "batch", None, "model", None)
    k = shard_act(k, "batch", None, None, None)
    v = shard_act(v, "batch", None, None, None)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])
    return q, k, v


def _output(cfg: ModelConfig, p, o: torch.Tensor) -> torch.Tensor:
    cd = dt(cfg.compute_dtype)
    o, wo = o.to(cd), p["wo"].to(cd)
    h, hd, d = wo.shape
    o = o.flatten(2)             # flattened heads, as in ``_to_heads``
    if isinstance(o, DTensor):
        o = _GatheredHeadsGrad.apply(o, h)
    y = o @ wo.reshape(h * hd, d)
    return shard_act(y, "batch", None, "model", kind="resid")


def _takes_local_plan(cfg: ModelConfig, p, x: torch.Tensor) -> bool:
    """Whether attention over ``x`` runs ``_attention_sharded``: a DTensor
    over more than one rank (``sharding.spread``), the plain paths (the
    kernels refuse DTensors), and enough rows a rank that gathering the
    weights' ZeRO shards pays (``sharding.zero_gather_pays``; a decode
    step's few rows leave them in place)."""
    return (spread(x) and not cfg.use_kernels
            and zero_gather_pays(x, p["wq"]))


def _attention_sharded(cfg: ModelConfig, p, x: DTensor, src=None, *,
                       causal: bool, positions=None,
                       prefix_len: Optional[int] = None) -> DTensor:
    """Megatron's attention on each rank's local tensors, laid out from the
    parameters' rules on any mesh: the block input (and the
    cross-attention's ``src``) gathered over every mesh dim but the batch's,
    in the compute dtype; wq column-parallel and wo row-parallel over the
    mesh dims that shard wq's heads, each gathered over the others (the
    ZeRO-3 gather of its ``data`` shard); wk and wv whole (the rules
    replicate the kv heads over ``model``), cut to the kv heads the rank's
    q heads read (``_kv_for_heads``). Each rank projects, normalises and
    rotates its own q heads and those kv heads, and attends; the output, a
    partial sum over the heads' shards, is reduce-scattered into the
    residual layout. Every rank's use of an input or weight that all of
    them read covers its own heads only, so each such gradient is partial
    and summed in the backward: the block input's reduce-scattered, the
    weights' reduce-scattered over the batch mesh dims (all-reduced over
    the heads' too for wk, wv and the norms' scales)."""
    cd = dt(cfg.compute_dtype)
    mesh = x.device_mesh
    pl = functools.partial(split_layout, mesh.ndim)
    wq, wk, wv, wo = (p[n].to(cd) for n in ("wq", "wk", "wv", "wo"))
    rows = sharding_dims(x, 0)
    heads = tuple(i for i in sharding_dims(wq, 1) if i not in rows)
    every = rows + heads
    xl = local_part(x.to(cd), pl(0, rows), heads)
    srcl = xl if src is None else local_part(src.to(cd), pl(0, rows), heads)
    wq_l = local_part(wq, pl(1, heads), rows)
    wk_l = local_part(wk, pl(0, ()), every)
    wv_l = local_part(wv, pl(0, ()), every)
    h, h_loc = wq.shape[1], wq_l.shape[1]
    if h_loc < h:   # project only the kv heads this rank's q heads read
        h0 = shard_index(mesh, pl(1, heads), 1) * h_loc
        wk_l, wv_l = _kv_for_heads(wk_l, wv_l, h0, h_loc, h // wk.shape[1],
                                   dim=1)
    q, k, v = (_to_heads(xl, wq_l), _to_heads(srcl, wk_l),
               _to_heads(srcl, wv_l))
    if cfg.qk_norm:
        q = rms_norm_headwise(q, local_part(p["q_norm"], pl(0, ()), every))
        k = rms_norm_headwise(k, local_part(p["k_norm"], pl(0, ()), every))
    if cfg.use_rope and src is None:
        if positions is None:
            positions = torch.arange(xl.shape[1], device=xl.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attention_core(cfg, q, k, v, causal=causal, prefix_len=prefix_len)
    wo_l = local_part(wo, pl(0, heads), rows)
    y = o.to(cd).flatten(2) @ wo_l.reshape(-1, wo_l.shape[-1])
    y = from_local_parts(y, mesh, pl(0, rows, heads),
                         (*x.shape[:-1], wo.shape[-1]))
    return shard_act(y, "batch", None, "model", kind="resid")


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
    if _takes_local_plan(cfg, p, x):
        return _attention_sharded(cfg, p, x, causal=causal,
                                  positions=positions, prefix_len=prefix_len)
    with span("attn.qkv"):
        q, k, v = _project_qkv(cfg, p, x)
    if cfg.use_rope:
        with span("attn.rope"):
            if positions is None:
                positions = torch.arange(x.shape[1], device=x.device)[None, :]
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    with span("attn.core"):
        o = attention_core(cfg, q, k, v, causal=causal, prefix_len=prefix_len)
    with span("attn.out"):
        return _output(cfg, p, o)


def cross_attention(cfg: ModelConfig, p, x: torch.Tensor,
                    enc: torch.Tensor) -> torch.Tensor:
    """Decoder queries over the encoder output [B,T,D], no mask and no rope;
    with ``sq > 1`` and ``use_kernels`` it goes to the flash kernel,
    non-causal, as the reference's ``attention_core`` sends it."""
    if _takes_local_plan(cfg, p, x):
        return _attention_sharded(cfg, p, x, enc, causal=False)
    q, k, v = _project_qkv(cfg, p, x, x_kv=enc)
    o = attention_core(cfg, q, k, v, causal=False)
    return _output(cfg, p, o)


def _write_position(cache_t: torch.Tensor, pos: int, new: torch.Tensor):
    """``cache_t[:, pos] = new`` in place. On a DTensor cache (its time axis
    possibly sharded, as the cache rules lay it out) the rank that holds
    position ``pos`` writes it into its local shard; ``new`` is laid out on
    the cache's batch sharding first."""
    if not isinstance(cache_t, DTensor):
        cache_t[:, pos] = new.to(cache_t.dtype)
        return
    mesh, pl = cache_t.device_mesh, cache_t.placements
    batch_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                     for p in pl)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, batch_pl).to_local()
    local = cache_t.to_local()
    t_loc = local.shape[1]
    if shard_index(mesh, pl, 1) == pos // t_loc:
        local[:, pos % t_loc] = new.to(local.dtype)


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
    _write_position(k, pos, k_new[:, 0])
    _write_position(v, pos, v_new[:, 0])
    o = attention_core(cfg, q, k, v, causal=False, kv_len=pos + 1)
    return _output(cfg, p, o), {"k": k, "v": v}


def decode_cross_attention(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,        # [B,1,D]
    cache: dict,            # {"xk": [B,T,Kv,Dh], "xv": ...} from the encoder
) -> torch.Tensor:
    """One decoder token against the cross K/V precomputed at prefill."""
    cd = dt(cfg.compute_dtype)
    q = _to_heads(x.to(cd), p["wq"].to(cd))
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
    o = attention_core(cfg, q, cache["xk"].to(cd), cache["xv"].to(cd),
                       causal=False)
    return _output(cfg, p, o)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, n_kv: int,
                      head_dim: int, dtype=None, device=None):
    dtype = dtype or dt(cfg.compute_dtype)
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
