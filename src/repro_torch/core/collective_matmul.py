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
send/recv to self is issued). The rings carry no gradient: a P2P transfer
is invisible to autograd, so a ring called where autograd would record it
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import sharding as shd
from repro_torch.core.lanes import Handle, two_lane_ring


def _no_grad_check(*xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            "the collective-matmul rings carry no gradient (a P2P transfer is "
            "invisible to autograd); call them under torch.no_grad()")


def _group_info(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _shift(buf: torch.Tensor, group, offset: int) -> Handle:
    """Issue the ring move of ``buf`` from group rank ``d`` to ``d + offset``
    (mod p); the handle waits and returns what ``d - offset`` sent."""
    p, d = _group_info(group)
    if p == 1:
        return lambda: buf
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

def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Ring all-gather-matmul: y[S, N/p] from x[S/p, K] and w[K, N/p].

    Step ``s``: rank ``d`` holds the x-chunk originally from rank
    ``(d + s) % p``; it computes that chunk's rows of y while the chunk moves
    to neighbour ``d - 1`` (so everyone eventually sees every chunk). The
    move for step ``s+1`` is issued before step ``s``'s matmul — transfer
    lane producing, compute lane consuming. The reference's loop makes
    ``p`` moves for ``p`` steps and XLA drops the last, whose buffer no step
    reads; here it is never issued."""
    _no_grad_check(x, w)
    p, d = _group_info(group)
    s_loc = x.shape[0]
    dtype = torch.promote_types(x.dtype, w.dtype)

    def transfer(step, buf):
        return _shift(buf, group, -1)

    def compute(step, buf, acc):
        # buf holds the chunk of rank (d + step) % p.
        src = (d + step) % p
        acc[src * s_loc:(src + 1) * s_loc] = buf @ w
        return acc

    acc0 = torch.zeros((p * s_loc, w.shape[1]), dtype=dtype, device=x.device)
    return two_lane_ring(p, x, acc0, compute, transfer)


def matmul_reducescatter(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Ring matmul-reduce-scatter: z[S/p, K] from y[S, N/p] and w[N/p, K].

    The partial product for one sequence chunk is computed per step and added
    to an f32 accumulator that moves toward its home rank: the buffer that
    finally lands on rank ``h`` sits on rank ``(h + t) % p`` at step ``t``,
    so a rank holding it contributes its partial for chunk ``(d - t) % p``,
    then the buffer moves one hop (``d -> d + 1``). The buffer *is* the SPSC
    slot; the next chunk's product is computed while the buffer is in
    flight, and added when it lands (the reference's sums, in its order:
    each step adds one partial to the running f32 sum, then moves it)."""
    _no_grad_check(y, w)
    p, d = _group_info(group)
    s_loc = y.shape[0] // p

    def partial(step):
        c = (d - step) % p
        return (y[c * s_loc:(c + 1) * s_loc] @ w).float()

    buf = partial(0)  # f32 ring accumulator (0 + partial, exactly)
    for step in range(1, p):
        moving = _shift(buf, group, +1)
        part = partial(step)       # compute lane, while the buffer moves
        buf = moving() + part
    buf = _shift(buf, group, +1)()  # the last hop home
    return buf.to(torch.promote_types(y.dtype, w.dtype))


def _gated_act(act: str, g: torch.Tensor) -> torch.Tensor:
    """The ring's activation, applied in f32 and cast back (the reference's
    ``jax.nn.silu`` / ``jax.nn.gelu``, tanh form); any other name applies
    none, as in the reference."""
    if act == "silu":
        return F.silu(g.float()).to(g.dtype)
    if act == "gelu":
        return F.gelu(g.float(), approximate="tanh").to(g.dtype)
    return g


def allgather_matmul_gated(x: torch.Tensor, w_gate: torch.Tensor,
                           w_up: torch.Tensor, group, *,
                           act: str = "silu") -> torch.Tensor:
    """Fused two-lane ring: one x-chunk transfer feeds BOTH gate and up
    matmuls (half the ring traffic of two separate AG-matmuls); the
    elementwise act(g)*u happens on the consumer lane. x: [S/p, K] local,
    w_gate/w_up: [K, N/p] local. Output: [S, N/p]."""
    _no_grad_check(x, w_gate, w_up)
    p, d = _group_info(group)
    s_loc = x.shape[0]
    dtype = torch.promote_types(x.dtype, w_gate.dtype)

    def transfer(step, buf):
        return _shift(buf, group, -1)

    def compute(step, buf, acc):
        src = (d + step) % p
        g = _gated_act(act, buf @ w_gate)
        acc[src * s_loc:(src + 1) * s_loc] = g * (buf @ w_up)
        return acc

    acc0 = torch.zeros((p * s_loc, w_gate.shape[1]), dtype=dtype,
                       device=x.device)
    return two_lane_ring(p, x, acc0, compute, transfer)


# --------------------------------------------------------------------------
# Mesh-level front-ends (DTensors in, DTensors out)
# --------------------------------------------------------------------------

def _local(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``t``'s local shard under ``spec`` (a plain tensor is taken as the
    full value, the same on every rank)."""
    placements = shd.placements(mesh, spec)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements).to_local()
    return distribute_tensor(t, mesh, placements, src_data_rank=None).to_local()


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
    wg = _local(w_gate, mesh, (None, axis_name))
    wu = _local(w_up, mesh, (None, axis_name))
    wd = _local(w_down, mesh, (axis_name, None))
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
