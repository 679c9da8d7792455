"""Overlapped collective matmuls — the Relic SPSC ring across devices. The
port of ``src/repro/core/collective_matmul.py`` on ``torch.distributed``.

Megatron-style tensor parallelism needs two collectives per block:

  * ``f``: all-gather sequence-sharded activations before a column-parallel
    matmul;
  * ``g``: reduce-scatter the row-parallel matmul's partial sums back to
    sequence shards.

The unoverlapped forms serialize transfer and compute. Following the
paper's producer/consumer specialization, each becomes a **static ring**:
at every step one P2P send/recv to the group-local neighbour (transfer
lane) moves the next chunk while the matmul (compute lane) consumes the
current one — a depth-1 SPSC queue between two fixed-role lanes, no dynamic
scheduling (Wang et al., ASPLOS'23).

The functions taking a ``group`` work on local shards (the reference's
per-device views inside ``shard_map``); ``mlp_ring`` and the ``tp_*``
front-ends take and return DTensors, laid out as the reference's
``in_specs`` / ``out_specs`` say. The per-chunk products are
``torch.matmul``, as the reference computes them outside any Pallas kernel.
A group of one rank permutes to itself, which is the identity (no
send/recv to self is made). Each ring is an ``autograd.Function`` whose
backward runs the dual rings, as ``lax.ppermute``'s transpose does in the
reference: all-gather-matmul's input gradient is a matmul-reduce-scatter
and the reverse, and the weight gradients run the all-gather ring again
rather than keep a gathered copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch import sharding as shd
from repro_torch.core.lanes import Handle, two_lane_ring


#: Callables told the bytes of each ring move made on meta tensors, which
#: sends nothing (the dry-run's meter counts them as a collective-permute).
meta_moves: list = []


def _group_info(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _shift(buf: torch.Tensor, group, offset: int) -> Handle:
    """Issue the ring move of ``buf`` from group rank ``d`` to ``d + offset``
    (mod p); the handle waits and returns what ``d - offset`` sent. On meta
    tensors nothing is issued: each of ``meta_moves`` is told the buffer's
    bytes, and the handle returns an empty buffer of its shape."""
    p, d = _group_info(group)
    if p == 1:
        return lambda: buf
    if buf.is_meta:
        for tell in meta_moves:
            tell(buf.numel() * buf.element_size())
        moved = torch.empty_like(buf)
        return lambda: moved
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dst = dist.get_global_rank(group, (d + offset) % p)
    src = dist.get_global_rank(group, (d - offset) % p)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, dst, group),
        dist.P2POp(dist.irecv, out, src, group),
    ])

    def wait() -> torch.Tensor:
        for r in reqs:
            r.wait()
        return out

    return wait


# --------------------------------------------------------------------------
# Reference (unoverlapped) forms
# --------------------------------------------------------------------------

def allgather_matmul_ref(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """y = allgather(x, seq axis) @ w   (x: [S/p, K], w: [K, N/p] local)."""
    p, _ = _group_info(group)
    x_full = x.new_empty((p * x.shape[0], *x.shape[1:]))
    shd.all_gather_rows(x_full, x, group)  # [S, K]
    return x_full @ w  # [S, N/p]


def matmul_reducescatter_ref(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """z = reduce_scatter(y @ w, seq axis)  (y: [S, N/p], w: [N/p, K] local)."""
    p, _ = _group_info(group)
    partial_z = (y @ w).contiguous()  # [S, K] partial sum over sharded N
    out = partial_z.new_empty((partial_z.shape[0] // p, *partial_z.shape[1:]))
    dist.reduce_scatter_tensor(out, partial_z, group=group)
    return out


# --------------------------------------------------------------------------
# Overlapped ring forms (two-lane)
# --------------------------------------------------------------------------

def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The rings' accumulator: f32, or wider where an input is."""
    out = torch.float32
    for t in ts:
        out = torch.promote_types(out, t.dtype)
    return out


def _ag_ring(x: torch.Tensor, group, acc, compute):
    """The all-gather ring over x's chunks: at step ``s`` rank ``d`` holds
    the chunk of rank ``src = (d + s) % p`` and runs ``compute(src, chunk,
    acc) -> acc`` while that chunk moves to neighbour ``d - 1`` (the move
    for step ``s + 1`` starts before step ``s``'s compute: transfer lane
    producing, compute lane consuming). The reference's loop makes ``p``
    moves for ``p`` steps and XLA drops the last, whose buffer no step
    reads; here it is never made."""
    p, d = _group_info(group)
    return two_lane_ring(p, x, acc,
                         lambda step, buf, a: compute((d + step) % p, buf, a),
                         lambda step, buf: _shift(buf, group, -1))


def _ag_matmul(x, w, group):
    s_loc = x.shape[0]
    p, _ = _group_info(group)

    def compute(src, buf, acc):
        acc[src * s_loc:(src + 1) * s_loc] = buf @ w
        return acc

    acc = torch.zeros((p * s_loc, w.shape[1]),
                      dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    return _ag_ring(x, group, acc, compute)


def _ag_outer(x, dy, group):
    """allgather(x)ᵀ @ dy, [K, N/p] in f32 (or wider), with x's chunks moved
    by the ring (the gathered x is never held)."""
    s_loc, acc_t = x.shape[0], _acc_dtype(x, dy)

    def compute(src, buf, acc):
        return acc + buf.to(acc_t).t() @ dy[src * s_loc:(src + 1) * s_loc].to(acc_t)

    acc = torch.zeros((x.shape[1], dy.shape[1]), dtype=acc_t, device=x.device)
    return _ag_ring(x, group, acc, compute)


def _mm_rs(y, w, group):
    p, d = _group_info(group)
    s_loc, acc_t = y.shape[0] // p, _acc_dtype(y, w)

    def partial(step):
        c = (d - step) % p
        return (y[c * s_loc:(c + 1) * s_loc] @ w).to(acc_t)

    buf = partial(0)  # f32 ring accumulator (0 + partial, exactly)
    for step in range(1, p):
        moving = _shift(buf, group, +1)
        part = partial(step)       # compute lane, while the buffer moves
        buf = moving() + part
    buf = _shift(buf, group, +1)()  # the last hop home
    return buf.to(torch.promote_types(y.dtype, w.dtype))


def _rs_outer(y, dz, group):
    """yᵀ @ allgather(dz), [N/p, K] in f32 (or wider): dz's chunks moved by
    the ring."""
    s_loc, acc_t = dz.shape[0], _acc_dtype(y, dz)

    def compute(src, buf, acc):
        return acc + y[src * s_loc:(src + 1) * s_loc].to(acc_t).t() @ buf.to(acc_t)

    acc = torch.zeros((y.shape[1], dz.shape[1]), dtype=acc_t, device=y.device)
    return _ag_ring(dz, group, acc, compute)


class _AllGatherMatmul(torch.autograd.Function):
    """y = allgather(x) @ w. Its transpose is the dual ring: dx is the
    matmul-reduce-scatter of dy @ wᵀ, and dw = allgather(x)ᵀ @ dy runs the
    all-gather ring over x again."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return _ag_matmul(x, w, group)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_rs(dy, w.t(), ctx.group).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _ag_outer(x, dy, ctx.group).to(w.dtype)
        return dx, dw, None


class _MatmulReduceScatter(torch.autograd.Function):
    """z = reduce_scatter(y @ w). Its transpose: dy is the all-gather-matmul
    of dz with wᵀ, and dw = yᵀ @ allgather(dz) runs the ring over dz."""

    @staticmethod
    def forward(ctx, y, w, group):
        ctx.save_for_backward(y, w)
        ctx.group = group
        return _mm_rs(y, w, group)

    @staticmethod
    def backward(ctx, dz):
        y, w = ctx.saved_tensors
        dy = dw = None
        if ctx.needs_input_grad[0]:
            dy = _ag_matmul(dz, w.t(), ctx.group).to(y.dtype)
        if ctx.needs_input_grad[1]:
            dw = _rs_outer(y, dz, ctx.group).to(w.dtype)
        return dy, dw, None


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Ring all-gather-matmul: y[S, N/p] from x[S/p, K] and w[K, N/p].

    Step ``s``: rank ``d`` holds the x-chunk originally from rank
    ``(d + s) % p``; it computes that chunk's rows of y while the chunk moves
    to neighbour ``d - 1`` (so everyone eventually sees every chunk).
    Differentiable: the backward runs the dual rings."""
    return _AllGatherMatmul.apply(x, w, group)


def matmul_reducescatter(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Ring matmul-reduce-scatter: z[S/p, K] from y[S, N/p] and w[N/p, K].

    The partial product for one sequence chunk is computed per step and added
    to an f32 accumulator that moves toward its home rank: the buffer that
    finally lands on rank ``h`` sits on rank ``(h + t) % p`` at step ``t``,
    so a rank holding it contributes its partial for chunk ``(d - t) % p``,
    then the buffer moves one hop (``d -> d + 1``). The buffer *is* the SPSC
    slot; the next chunk's product is computed while the buffer is in
    flight, and added when it lands (the reference's sums, in its order:
    each step adds one partial to the running f32 sum, then moves it).
    Differentiable: the backward runs the dual rings."""
    return _MatmulReduceScatter.apply(y, w, group)


def _gated_act(act: str, g: torch.Tensor) -> torch.Tensor:
    """The ring's activation, applied in f32 and cast back (the reference's
    ``jax.nn.silu`` / ``jax.nn.gelu``, tanh form); any other name applies
    none, as in the reference."""
    if act == "silu":
        return F.silu(g.float()).to(g.dtype)
    if act == "gelu":
        return F.gelu(g.float(), approximate="tanh").to(g.dtype)
    return g


class _AllGatherMatmulGated(torch.autograd.Function):
    """act(allgather(x) @ wg) * (allgather(x) @ wu). The backward runs the
    all-gather ring over x once more: each chunk's gate and up products are
    recomputed, giving that chunk's rows of dG and dU and its share of the
    weight gradients; dx is then one matmul-reduce-scatter ring of [dG, dU]
    against [wg, wu]ᵀ."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, group, act):
        ctx.save_for_backward(x, w_gate, w_up)
        ctx.group, ctx.act = group, act
        s_loc = x.shape[0]
        p, _ = _group_info(group)

        def compute(src, buf, acc):
            g = _gated_act(act, buf @ w_gate)
            acc[src * s_loc:(src + 1) * s_loc] = g * (buf @ w_up)
            return acc

        acc = torch.zeros((p * s_loc, w_gate.shape[1]),
                          dtype=torch.promote_types(x.dtype, w_gate.dtype),
                          device=x.device)
        return _ag_ring(x, group, acc, compute)

    @staticmethod
    def backward(ctx, dh):
        x, w_gate, w_up = ctx.saved_tensors
        s_loc, n = x.shape[0], w_gate.shape[1]
        d_gu = torch.empty((dh.shape[0], 2 * n), dtype=dh.dtype,
                           device=dh.device)

        def compute(src, buf, acc):
            rows = slice(src * s_loc, (src + 1) * s_loc)
            with torch.enable_grad():
                g = (buf @ w_gate).detach().requires_grad_(True)
                u = (buf @ w_up).detach().requires_grad_(True)
                dg, du = torch.autograd.grad(
                    _gated_act(ctx.act, g) * u, (g, u), dh[rows])
            d_gu[rows, :n], d_gu[rows, n:] = dg, du
            xt = buf.to(acc_t).t()
            return acc[0] + xt @ dg.to(acc_t), acc[1] + xt @ du.to(acc_t)

        acc_t = _acc_dtype(x, dh)
        zero = torch.zeros((x.shape[1], n), dtype=acc_t, device=x.device)
        dwg, dwu = _ag_ring(x, ctx.group, (zero, zero.clone()), compute)
        dx = None
        if ctx.needs_input_grad[0]:
            w_gu = torch.cat([w_gate, w_up], dim=1)
            dx = _mm_rs(d_gu, w_gu.t(), ctx.group).to(x.dtype)
        return dx, dwg.to(w_gate.dtype), dwu.to(w_up.dtype), None, None


def allgather_matmul_gated(x: torch.Tensor, w_gate: torch.Tensor,
                           w_up: torch.Tensor, group, *,
                           act: str = "silu") -> torch.Tensor:
    """Fused two-lane ring: one x-chunk transfer feeds BOTH gate and up
    matmuls (half the ring traffic of two separate AG-matmuls); the
    elementwise act(g)*u happens on the consumer lane. x: [S/p, K] local,
    w_gate/w_up: [K, N/p] local. Output: [S, N/p]. Differentiable."""
    return _AllGatherMatmulGated.apply(x, w_gate, w_up, group, act)


# --------------------------------------------------------------------------
# Mesh-level front-ends (DTensors in, DTensors out)
# --------------------------------------------------------------------------

def _local(t: torch.Tensor, mesh, spec, partial=None) -> torch.Tensor:
    """``t``'s local shard under ``spec`` (a plain tensor is taken as the
    full value, the same on every rank); differentiable either way. Its
    gradient is a partial sum over the mesh axes named in ``partial`` (the
    batch axes, for a weight that every batch shard reads)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    pl = shd.placements(mesh, spec)
    grad = tuple(Partial() if n in (partial or ()) else p
                 for n, p in zip(mesh.mesh_dim_names, pl))
    return t.redistribute(mesh, pl).to_local(grad_placements=grad)


def _wrap(local: torch.Tensor, mesh, spec, shape) -> DTensor:
    return DTensor.from_local(local, mesh, shd.placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=shd.contiguous_stride(shape))


def _batch_entry(mesh):
    return tuple(n for n in ("pod", "data")
                 if n in mesh.mesh_dim_names) or None


def mlp_ring(cfg_act: str, x: torch.Tensor, w_gate, w_up, w_down, mesh,
             axis_name: str = "model") -> DTensor:
    """Relic-ring TP MLP over a sequence-sharded residual stream.

    x: [B, S(model-sharded), D]; weights Megatron column/row sharded on the
    model axis. One AG ring (fused gate+up) + one RS ring; every transfer
    overlaps the previous chunk's matmul. Returns [B, S(model-sharded), D].
    The batch dim keeps its ("pod", "data") sharding: each batch shard runs
    its own ring (in the reference, the axes outside ``axis_name`` are left
    to the partitioner)."""
    group = mesh.get_group(axis_name)
    batch = _batch_entry(mesh)
    x_spec = (batch, axis_name, None)
    xl = _local(x, mesh, x_spec)
    wg = _local(w_gate, mesh, (None, axis_name), partial=batch)
    wu = _local(w_up, mesh, (None, axis_name), partial=batch)
    wd = _local(w_down, mesh, (axis_name, None), partial=batch)
    b, s_loc, k = xl.shape
    h = allgather_matmul_gated(xl.reshape(b * s_loc, k), wg, wu, group,
                               act=cfg_act)
    out = matmul_reducescatter(h, wd, group)
    out = out.reshape(b, s_loc, wd.shape[1]).to(xl.dtype)
    return _wrap(out, mesh, x_spec, (x.shape[0], x.shape[1], w_down.shape[1]))


def tp_allgather_matmul(x_sharded: torch.Tensor, w_col: torch.Tensor, mesh,
                        axis_name: str = "model", *,
                        overlapped: bool = True) -> DTensor:
    """Mesh-level f-layer: x [S(model-sharded), K] @ w [K, N(model-sharded)]
    -> y [S, N(model-sharded)]."""
    fn = allgather_matmul if overlapped else allgather_matmul_ref
    y = fn(_local(x_sharded, mesh, (axis_name, None)),
           _local(w_col, mesh, (None, axis_name)), mesh.get_group(axis_name))
    return _wrap(y, mesh, (None, axis_name),
                 (x_sharded.shape[0], w_col.shape[1]))


def tp_matmul_reducescatter(y: torch.Tensor, w_row: torch.Tensor, mesh,
                            axis_name: str = "model", *,
                            overlapped: bool = True) -> DTensor:
    """Mesh-level g-layer: y [S, N(model-sharded)] @ w [N(model-sharded), K]
    -> z [S(model-sharded), K]."""
    fn = matmul_reducescatter if overlapped else matmul_reducescatter_ref
    z = fn(_local(y, mesh, (None, axis_name)),
           _local(w_row, mesh, (axis_name, None)), mesh.get_group(axis_name))
    return _wrap(z, mesh, (axis_name, None), (y.shape[0], w_row.shape[1]))


def ring_eligible(mesh: Optional[object], seq_len: int,
                  axis_name: str = "model") -> bool:
    """True if ``mesh`` has ``axis_name`` and it divides ``seq_len``: when
    the model's MLP takes the ring (the reference's condition)."""
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return False
    return seq_len % mesh.size(mesh.mesh_dim_names.index(axis_name)) == 0
