"""Inter-pod pipeline parallelism (GPipe schedule) — the third scale of the
Relic pattern. The port of ``src/repro/core/pipeline.py``.

Contiguous layer blocks live on each rank of the ``pod`` axis (`stage =
rank in that group`), microbatches stream through, and the stage→stage
activation hand-off is a P2P send/recv — a fixed-role producer/consumer
chain with a depth-1 buffer, i.e. the paper's SPSC queue stretched across
pods.

Schedule: GPipe (fill, steady state, drain): T = M + S - 1 ticks for M
microbatches over S stages. Bubble fraction = (S-1)/(M+S-1).

Gradients flow through the schedule: the hand-off is an autograd function
whose backward sends the gradient the opposite way, and every rank runs the
same ops at every tick (selections by ``torch.where``, as the reference's
``jnp.where``), so every rank's backward reaches every hand-off in the same
order. The result is the reference's psum of one-hot contributions,
replicated on every stage; its backward is the identity, since each rank
holds the same replicated cotangent (``torch.distributed.nn.functional
.all_reduce`` would all-reduce the gradient as well and count a replicated
loss once per stage).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard


def _group_info(group):
    """(size, this rank's index) of ``group``."""
    return dist.get_world_size(group), dist.get_rank(group)


def _move(x: torch.Tensor, group, to: Optional[int],
          frm: Optional[int]) -> torch.Tensor:
    """Send ``x`` to group rank ``to`` and return what group rank ``frm``
    sent (zeros where ``frm`` is None)."""
    x = x.contiguous()
    out = torch.empty_like(x) if frm is not None else torch.zeros_like(x)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, to),
                              group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _HandOff(torch.autograd.Function):
    """Non-cyclic permute stage -> stage + 1: the last stage sends nothing
    and stage 0 receives zeros. Backward moves the gradient stage + 1 ->
    stage."""

    @staticmethod
    def forward(ctx, x, group):
        p, d = _group_info(group)
        ctx.group = group
        return _move(x, group, d + 1 if d + 1 < p else None,
                     d - 1 if d > 0 else None)

    @staticmethod
    def backward(ctx, g):
        p, d = _group_info(ctx.group)
        return _move(g, ctx.group, d - 1 if d > 0 else None,
                     d + 1 if d + 1 < p else None), None


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) to a replicated value; the cotangent of a replicated
    value is already the same on every rank, so backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _my_stage(a: torch.Tensor, stage: int, mesh, axis_name: str) -> torch.Tensor:
    """This stage's slice of a ``[n_stages, ...]`` leaf: a DTensor is taken
    sharded over ``axis_name`` on dim 0 (each rank holds its stage), a plain
    tensor is the full stack, the same on every rank."""
    if isinstance(a, DTensor):
        dim = mesh.mesh_dim_names.index(axis_name)
        placements = list(a.placements)
        placements[dim] = Shard(0)
        return a.redistribute(mesh, placements).to_local()[0]
    return a[stage]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x_mb: torch.Tensor,
    mesh,
    *,
    axis_name: str = "pod",
) -> torch.Tensor:
    """Run microbatches through pod-resident pipeline stages.

    Args:
      stage_fn: ``(stage_params_local, x) -> y`` — one stage's layer block
        applied to one microbatch activation ``[mb, S, D]``.
      stage_params: tensor or nested dict/list of tensors with leading dim =
        n_stages (each rank uses its stage's slice).
      x_mb: ``[M, mb, S, D]`` microbatches (the same on every rank).
      mesh: the DeviceMesh containing ``axis_name``.

    Returns: ``[M, mb, S, D]`` outputs of the final stage (replicated).
    """
    group = mesh.get_group(axis_name)
    n_stages, stage = _group_info(group)
    n_leading = {a.shape[0] for a in _leaves(stage_params)}
    assert n_leading == {n_stages}, (n_leading, n_stages)
    m = x_mb.shape[0]
    ticks = m + n_stages - 1
    params_me = _tree_map(
        lambda a: _my_stage(a, stage, mesh, axis_name), stage_params)
    first = torch.tensor(stage == 0, device=x_mb.device)
    is_last = stage == n_stages - 1

    in_buf = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for t in range(ticks):
        mb_idx = t - stage                      # microbatch at this stage
        active = 0 <= mb_idx < m
        safe_idx = min(max(mb_idx, 0), m - 1)
        # stage 0 consumes fresh microbatches; others consume the buffer
        # filled by their upstream neighbour last tick (the SPSC slot).
        x_in = torch.where(first, x_mb[safe_idx], in_buf)
        y = stage_fn(params_me, x_in)
        y = torch.where(torch.tensor(active, device=y.device), y,
                        torch.zeros_like(y))
        # last stage retires finished microbatches (every rank writes, so
        # every rank's outputs depend on its stage's y)
        idx = torch.tensor([safe_idx], device=y.device)
        keep = torch.tensor(active and is_last, device=y.device)
        outputs = outputs.index_copy(
            0, idx, torch.where(keep, y, outputs[safe_idx])[None])
        if t + 1 < ticks:   # the last tick's hand-off would feed no tick
            in_buf = _HandOff.apply(y, group)
    # only the last stage holds real outputs; broadcast them to every stage
    return _SumReplicated.apply(outputs, group)


def split_stages(layers_stacked: Any, n_stages: int) -> Any:
    """[L, ...] stacked layer params -> [n_stages, L/n_stages, ...]."""
    def one(a):
        n = a.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])

    return _tree_map(one, layers_stacked)
