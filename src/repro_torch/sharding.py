"""Partitioning rules: parameter names -> DTensor placements, plus
activation sharding constraints. The port of ``src/repro/sharding.py``.

Mesh axes (as the reference's):
  single-pod: ("data", "model")
  multi-pod:  ("pod", "data", "model")

Layout (2D "FSDP + TP"):
  * ``model`` carries tensor/expert parallelism (Megatron column/row, vocab-
    parallel embeddings, expert sharding).
  * ``data`` carries the batch AND a ZeRO-3-style shard of every weight's
    non-model dimension.
  * ``pod`` carries batch only (pure DP between pods).

The rules table, ``fit_spec`` and the layout knobs are the reference's,
copied (the reference's module imports JAX). A fitted spec (one entry per
tensor dim, as a ``PartitionSpec`` holds them) becomes one DTensor placement
per mesh dim (``placements``): a mesh axis that names tensor dim ``d`` is
``Shard(d)``, an axis no dim names is ``Replicate()``.

The port's parameters are named ``layers.3.attn.wq`` (one tensor per
layer); ``port_param_entries`` reads the reference's rule for its stacked
leaf ``layers/attn/wq`` and drops the stack dim.

Activation constraints go through ``shard_act``, which redistributes a
DTensor under the mesh that ``use_sharding_rules`` installed and returns
anything else unchanged, so the single-device code paths are untouched.
"""

from __future__ import annotations

import contextlib
import copy
import math
import re
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)

_state = threading.local()


def _axes() -> Optional[dict]:
    return getattr(_state, "axes", None)


@contextlib.contextmanager
def use_sharding_rules(mesh):
    """Install mesh axes for activation constraints within the block."""
    names = mesh.mesh_dim_names
    axes = {
        "batch": tuple(n for n in ("pod", "data") if n in names) or None,
        "model": "model" if "model" in names else None,
        "mesh": mesh,
    }
    prev = _axes()
    _state.axes = axes
    try:
        yield
    finally:
        _state.axes = prev


def _resolve(token: Optional[str]):
    axes = _axes()
    if token is None or axes is None:
        return None
    if token == "batch":
        return axes["batch"]
    if token == "model":
        return axes["model"]
    raise ValueError(f"unknown logical axis {token!r}")


def _mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or of anything with the
    reference's ``shape`` mapping and ``axis_names`` (a JAX mesh)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def _axis_prod(mesh, entry) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    shape = _mesh_shape(mesh)
    out = 1
    for n in names:
        out *= shape[n]
    return out


def fit_spec(mesh, entries, shape) -> tuple:
    """Drop axis names whose size does not divide the dim (replicate instead).

    Where a logical rule doesn't divide (e.g. 20 or 40 or 56 attention heads
    over model=16), that dim falls back to replication. A tuple entry
    degrades to its longest prefix that divides. Returns the entries (a
    tuple, as ``PartitionSpec`` holds them)."""
    fitted = []
    for d, entry in enumerate(entries):
        if entry is None or d >= len(shape):
            fitted.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        names = tuple(n for n in names if n in _axis_names(mesh))
        while names and shape[d] % _axis_prod(mesh, names) != 0:
            names = names[:-1]
        if not names:
            fitted.append(None)
        elif len(names) == 1:
            fitted.append(names[0])
        else:
            fitted.append(tuple(names))
    return tuple(fitted)


def placements(mesh, spec) -> Tuple[Placement, ...]:
    """A fitted spec as DTensor placements, one per mesh dim. A tuple entry
    such as ("pod", "data") shards its dim over both mesh dims, in the
    tuple's order, which must be the mesh's."""
    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} is not in the order of the "
                             f"mesh axes {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


# --- experiment knobs ------------------------------------------------------
#
# activation layout for the RESIDUAL STREAM [B, S, D] (kind="resid"):
#   "tp"         — D sharded over model (baseline 2D layout)
#   "replicated" — residuals full per device (classic Megatron f/g)
#   "seq"        — S sharded over model (Megatron sequence parallelism)
_ACT_LAYOUTS = ("tp", "replicated", "seq", "mixed")


def set_activation_layout(mode: str) -> None:
    assert mode in _ACT_LAYOUTS, mode
    _state.act_layout = mode


def get_activation_layout() -> str:
    return getattr(_state, "act_layout", "tp")


def set_param_rule_overrides(rules) -> None:
    """Prepend (regex, logical-entries) rules; [] clears. Hillclimb only."""
    _state.rule_overrides = list(rules)


def _rule_overrides():
    return getattr(_state, "rule_overrides", [])


def current_mesh():
    axes = _axes()
    return axes["mesh"] if axes else None


def act_spec(mesh, shape, *logical: Optional[str], kind: str = "act"):
    """The fitted spec ``shard_act`` gives an activation of ``shape``, or
    None where it leaves the activation as it is."""
    tokens = list(logical)
    layout = get_activation_layout()
    if kind == "resid" and len(tokens) == 3:
        if layout == "replicated":
            tokens = [tokens[0], None, None]
        elif layout == "seq":
            tokens = [tokens[0], "model", None]
    elif kind == "blockin":
        # "mixed" layout: residuals stay model-sharded (memory), but block
        # inputs are replicated right AFTER the bf16 cast, so the per-block
        # all-gather moves bf16.
        if layout != "mixed":
            return None
        tokens = [tokens[0]] + [None] * (len(tokens) - 1)
    return fit_spec(mesh, [_resolve(t) for t in tokens], shape)


def shard_act(x: torch.Tensor, *logical: Optional[str],
              kind: str = "act") -> torch.Tensor:
    """Constrain an activation, e.g. shard_act(h, 'batch', None, 'model').

    kind="resid" marks residual-stream constraints [B, S, D]; their layout is
    swappable via set_activation_layout. A plain tensor, or any tensor with
    no mesh installed, is returned unchanged."""
    axes = _axes()
    if axes is None or not isinstance(x, DTensor):
        return x
    mesh = axes["mesh"]
    spec = act_spec(mesh, x.shape, *logical, kind=kind)
    if spec is None:
        return x
    y = x.redistribute(mesh, placements(mesh, spec))
    local = y.to_local()
    if local.is_contiguous():
        return y
    # A redistribution over a dim that a mesh dim does not divide can leave
    # the local shard a view into a padded buffer; DTensor then plans views
    # from the global strides that the local tensor cannot take.
    return DTensor.from_local(local.contiguous(), mesh, y.placements,
                              run_check=False, shape=y.shape,
                              stride=y.stride())


def embed_sharded(table: DTensor, tokens: torch.Tensor, dtype) -> DTensor:
    """``table[tokens]`` in ``dtype`` for a DTensor table, vocab-parallel by
    hand on the local shards: the table keeps its vocab (dim 0) sharding and
    gathers the rest, the tokens keep their batch (dim 0) sharding, each
    rank looks up the rows it holds (zero for the others), and the result is
    a partial sum over the vocab shards, which the caller reduce-scatters
    into the residual layout. Over more than one rank, with enough tokens a
    rank that gathering the table's d_model shards pays (a train step, not a
    decode step), the table is cast to ``dtype`` first, as the reference
    casts it before its lookup: the gather moves ``dtype`` and the
    gradient's reduce-scatter too. Else the lookup is in the table's dtype
    and the cast follows (bit for bit the single device on one rank).
    DTensor's own rules for this lookup fail on a 2D mesh (indexing's
    backward, index_put, in torch 2.11; the embedding op's masked partial
    with a sharded batch, in 2.13)."""
    mesh = table.device_mesh
    vocab = tuple(isinstance(p, Shard) and p.dim == 0 for p in table.placements)
    t_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    if not isinstance(tokens, DTensor):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim,
                                   src_data_rank=None)
    batch = tuple(not v and isinstance(p, Shard) and p.dim == 0
                  for v, p in zip(vocab, tokens.placements))
    tok_pl = tuple(Shard(0) if b else Replicate() for b in batch)
    rows = tokens.numel() // math.prod(
        mesh.size(i) for i, b in enumerate(batch) if b)
    gathered = math.prod(mesh.size(i) for i in sharding_dims(table, 1))
    planned = spread(table) and table.shape[1] <= gathered * rows
    if planned:
        table = cast_local(table, dtype)
    # each batch shard contributes a partial gradient to a gathered table
    grad_pl = tuple(Shard(0) if v else (Partial() if b else Replicate())
                    for v, b in zip(vocab, batch))
    local = table.redistribute(mesh, t_pl).to_local(grad_placements=grad_pl)
    idx = tokens.redistribute(mesh, tok_pl).to_local()
    rel = idx - shard_index(mesh, t_pl, 0) * local.shape[0]
    hit = (rel >= 0) & (rel < local.shape[0])
    y = local[rel.clamp(0, local.shape[0] - 1)] * hit[..., None].to(local.dtype)
    out_pl = tuple(Partial() if v else (Shard(0) if b else Replicate())
                   for v, b in zip(vocab, batch))
    shape = torch.Size((*tokens.shape, table.shape[1]))
    y = DTensor.from_local(y, mesh, out_pl, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    return y if planned else y.to(dtype)


def cast_local(t: DTensor, dtype) -> DTensor:
    """``t.to(dtype)`` cast on each rank's local tensor (differentiable), so
    that the cast never reaches DTensor's dispatch: no rule of a torch
    release decides its layout."""
    if t.dtype == dtype:
        return t
    return DTensor.from_local(t.to_local().to(dtype), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def argmax_sharded(logits: DTensor) -> DTensor:
    """``logits.argmax(-1)`` without gathering the last dim (the vocab,
    sharded evenly by ``unembed``'s layout): each rank's largest logit and
    its index, offset by the rank's first column, are combined by two
    all-reduces over the vocab's mesh dims, the largest value and then the
    smallest index that holds it, as ``argmax`` breaks ties. The result
    keeps the logits' batch (dim 0) sharding."""
    d = logits.ndim - 1
    mesh = logits.device_mesh
    shard = shard_index(mesh, logits.placements, d)
    reduce = mesh_reduce(mesh, sharding_dims(logits, d))

    def local(x):
        val, idx = x.max(dim=-1)
        idx = idx + shard * x.shape[-1]
        best = reduce(val, "max")
        return reduce(torch.where(val == best, idx,
                                  torch.full_like(idx, logits.shape[d])),
                      "min")

    lead = tuple(range(d))
    return on_local_shards(local, logits, (0, d), [(logits, lead + (d,))],
                           [lead])


def shard_index(mesh, placements, dim: int) -> int:
    """This rank's shard of tensor dim ``dim`` under ``placements`` (the mesh
    dims that shard it, in mesh order, as ``placements`` lays them out)."""
    idx = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def sharding_dims(t: torch.Tensor, dim: int) -> Tuple[int, ...]:
    """The mesh dims that shard dim ``dim`` of ``t`` (none for a plain
    tensor)."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def stacked_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``op`` ("max" or "sum") over dim 0 of ``t``: the slices' partials
    stacked on one device, as the tests and the card's checks combine
    them."""
    return t.amax(0) if op == "max" else t.sum(0)


def _all_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    for i in dims:
        t = funcol.all_reduce(t, op, (mesh, i))
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, whose result every rank holds. With ``partial``
    False every rank uses the sum the same way (a replicated result), so its
    gradient is whole on every rank and the backward moves nothing; with
    ``partial`` True each rank uses it on its own shard, so its gradient is
    a partial sum and the backward all-reduces it too."""

    @staticmethod
    def forward(ctx, t, mesh, dims, partial):
        ctx.mesh, ctx.dims, ctx.partial = mesh, dims, partial
        return _all_reduce(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _all_reduce(g, "sum", ctx.mesh, ctx.dims)
        return g, None, None, None


def mesh_reduce(mesh, dims, partial_grad: bool = False):
    """``reduce(t, op)`` across the ranks of the mesh dims ``dims`` (c10d
    functional all-reduces, one per mesh dim, which the dry-run's meter
    counts): "max" and "min" carry no gradient, "sum" carries the result's
    gradient to every rank's input, all-reduced as well where
    ``partial_grad`` says each rank uses the sum on its own shard. What
    ``stacked_reduce`` does over stacked slices on one device."""
    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        if op == "sum":
            return _AllReduceSum.apply(t, mesh, tuple(dims), partial_grad)
        return _all_reduce(t.detach(), op, mesh, dims)
    return reduce


def split_layout(n: int, dim: int, on, partial=(),
                 batch=()) -> Tuple[Placement, ...]:
    """Placements over ``n`` mesh dims: ``Shard(dim)`` on the mesh dims
    ``on``, ``Shard(0)`` on ``batch``, ``Partial()`` on ``partial``,
    ``Replicate()`` elsewhere."""
    return tuple(Shard(dim) if i in on else Shard(0) if i in batch else
                 Partial() if i in partial else Replicate()
                 for i in range(n))


def dividing_dims(mesh, dims, size: int) -> Tuple[int, ...]:
    """``dims`` (mesh dims) where their sizes' product divides ``size``,
    else none: the split a dim of ``size`` can take over them."""
    return tuple(dims) if size % math.prod(mesh.size(i) for i in dims) == 0 \
        else ()


def spread(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor over more than one rank. On one rank
    nothing moves, and the sharded paths take DTensor's plan, whose ops are
    the single device's in its order: bit for bit the plain step (AdamW's
    first steps turn a last-bit gradient change near 0 into a visible
    weight difference; a local plan sums a gradient's terms in another
    order where an input feeds several blocks)."""
    return isinstance(t, DTensor) and t.device_mesh.size() > 1


def zero_gather_pays(x: torch.Tensor, w: torch.Tensor, dim: int = 0) -> bool:
    """Whether a product of ``x`` [..., d] with the weight ``w`` (a DTensor
    whose dim ``dim``, of size d, is contracted) should gather ``w``'s
    shards of that dim (ZeRO-3) rather than keep them in place: with ``n``
    shards the gather moves ``(n - 1) / n * d`` elements of each output
    column, a product against the shards in place leaves partial sums of
    each of the rank's ``rows`` rows to reduce, ``(n - 1) * rows`` a
    column. A train step holds thousands of rows a rank, a decode step a
    few."""
    if not isinstance(w, DTensor):
        return False
    n = math.prod(w.device_mesh.size(i) for i in sharding_dims(w, dim))
    rows = x.numel() // x.shape[-1] // math.prod(
        w.device_mesh.size(i) for i in sharding_dims(x, 0))
    return w.shape[dim] <= n * rows


def local_part(t: DTensor, pl, partial=()) -> torch.Tensor:
    """``t`` redistributed to the placements ``pl``, as its local tensor;
    differentiable, its gradient taken as partial over the mesh dims
    ``partial`` (which ``pl`` replicates), so that the redistribution's
    backward sums it back into ``t``'s layout: a reduce-scatter onto a
    sharded dim, an all-reduce onto a replicated one."""
    grad = tuple(Partial() if i in partial else p for i, p in enumerate(pl))
    return t.redistribute(t.device_mesh, pl).to_local(grad_placements=grad)


def from_local_parts(t: torch.Tensor, mesh, pl, shape) -> DTensor:
    """The DTensor of global ``shape`` whose local tensor on this rank is
    ``t`` under the placements ``pl`` (a Partial entry: a partial sum over
    that mesh dim)."""
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def on_local_shards(fn, like: torch.Tensor, keep, inputs, outputs):
    """``fn`` of the ``inputs``' tensors, run on local tensors where ``like``
    is a DTensor (else on the tensors as they are), for work that is
    independent along some dims (batch rows, heads): the dims ``keep`` of
    ``like`` stay sharded over
    the mesh dims that shard them now, every other mesh dim is replicated.
    Each of ``inputs`` is ``(tensor, dims)``, where ``dims[i]`` names the
    dim of ``like`` that the tensor's dim ``i`` follows (None: no sharding);
    ``outputs`` gives such ``dims`` for each result, which comes back as a
    DTensor (one result, or a tuple). A plain input is taken as the full
    value, the same on every rank. Differentiable. DTensor's own rules fail
    on some of these ops (an in-place scatter into a new tensor) or take
    minutes to propagate (a batched product over a dim two mesh dims
    shard)."""
    if not isinstance(like, DTensor):
        return fn(*[t for t, _ in inputs])
    mesh = like.device_mesh

    def layout(dims, grad=False):
        # an input that does not follow a kept dim is read by every shard
        # of it: its gradient is a partial sum over those mesh dims
        out = []
        for p in like.placements:
            split = isinstance(p, Shard) and p.dim in keep
            out.append(Shard(dims.index(p.dim)) if split and p.dim in dims
                       else Partial() if split and grad else Replicate())
        return tuple(out)

    local = []
    for t, dims in inputs:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(t.redistribute(mesh, layout(tuple(dims))).to_local(
            grad_placements=layout(tuple(dims), grad=True)))
    res = fn(*local)
    single = not isinstance(res, tuple)
    out = []
    for r, dims in zip((res,) if single else res, outputs):
        r = r.contiguous()   # from_local is told contiguous strides
        pl = layout(tuple(dims))
        shape = list(r.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        out.append(DTensor.from_local(r, mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=contiguous_stride(shape)))
    return out[0] if single else tuple(out)


def all_gather_rows(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    """All-gather ``x`` from every rank of ``group`` into ``out``, the
    ranks' tensors concatenated on dim 0 (``all_gather_single`` where the
    release has it, ``all_gather_into_tensor``, its older name, before)."""
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (what
    ``DTensor.from_local`` is told the global tensor has)."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# Parameter partitioning rules
# ---------------------------------------------------------------------------

# Ordered (regex over '/'-joined path, spec builder) — first match wins.
# `spec` entries are logical: "model", "data", or None, matched to the
# *trailing* dims of the array (leading scan/stack dims get None).
_PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / output heads: vocab-parallel, ZeRO on d_model
    (r"(^|/)embed/table$",        ("model", "data")),       # [V, D]
    (r"(^|/)lm_head/kernel$",     ("data", "model")),       # [D, V]
    # attention: Q and O column/row-parallel over heads; KV replicated on
    # model (GQA kv<TP) but ZeRO'd on data
    (r"(^|/)attn/wq$",            ("data", "model", None)),  # [D, H, Dh]
    (r"(^|/)attn/wk$",            ("data", None, None)),     # [D, Hkv, Dh]
    (r"(^|/)attn/wv$",            ("data", None, None)),
    (r"(^|/)attn/wo$",            ("model", None, "data")),  # [H, Dh, D]
    # dense MLP: column then row parallel
    (r"(^|/)mlp/w_(gate|up)$",    ("data", "model")),        # [D, F]
    (r"(^|/)mlp/w_down$",         ("model", "data")),        # [F, D]
    # MoE: experts over model, ZeRO over data on d_model dim
    (r"(^|/)moe/router$",         ("data", None)),           # [D, E]
    (r"(^|/)moe/w_(gate|up)$",    ("model", "data", None)),  # [E, D, F]
    (r"(^|/)moe/w_down$",         ("model", None, "data")),  # [E, F, D]
    # mamba2 / rwkv6 big projections
    (r"(^|/)ssm/w_in$",           ("data", "model")),        # [D, d_inner*...]
    (r"(^|/)ssm/w_out$",          ("model", "data")),        # [d_inner, D]
    (r"(^|/)rwkv/w_(r|k|v|g)$",   ("data", "model")),
    (r"(^|/)rwkv/w_o$",           ("model", "data")),
    # decode caches: batch over data; KV time axis over model (flash-decoding
    # style split-T)
    (r"(^|/)cache/(k|v)$",        ("data", "model", None, None)),  # [B,T,H,Dh]
    (r"(^|/)cache/(xk|xv)$",      ("data", "model", None, None)),  # cross-attn
    (r"(^|/)layers/(k|v|xk|xv)$", ("data", "model", None, None)),  # encdec cache
    (r"(^|/)shared_attn/(k|v)$",  ("data", "model", None, None)),  # zamba2 cache
    (r"(^|/)cache/ssm_state$",    ("data", "model", None, None)),  # [B,H,P,N]
    (r"(^|/)cache/wkv_state$",    ("data", "model", None, None)),  # [B,H,Dh,Dh]
    (r"(^|/)cache/conv_state$",   ("data", None, "model")),        # [B,K-1,C]
    (r"(^|/)cache/shift_state$",  ("data", "model")),              # [B,D]
    # everything small (norms, biases, decay vectors, conv kernels): replicate
    (r".*",                       ()),
]


def param_entries(path: str, ndim: int):
    """Logical axis entries for one param ('/'-joined path + rank)."""
    for pat, logical in list(_rule_overrides()) + _PARAM_RULES:
        if re.search(pat, path):
            pad = ndim - len(logical)
            if pad < 0:
                # rule written for the unstacked rank; stacked arrays only
                # ever ADD leading dims, so negative pad means a rank mismatch
                # from e.g. fused dims — fall back to replication.
                return (None,) * ndim
            return (None,) * pad + tuple(logical)
    return (None,) * ndim


def reference_path(name: str) -> Tuple[str, bool]:
    """(the reference's '/'-joined leaf path, stacked over layers) of a port
    parameter name: ``layers.3.attn.wq`` -> (``layers/attn/wq``, True), as
    ``optim.stacks.leaves`` groups them (likewise ``enc_layers``,
    ``dec_layers``)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1].isdigit():
        return "/".join(parts[:1] + parts[2:]), True
    return "/".join(parts), False


def port_param_entries(name: str, ndim: int):
    """The reference's entries for the leaf a port tensor belongs to, less
    the leading stack dim for a layer's tensor."""
    path, stacked = reference_path(name)
    if stacked:
        return param_entries(path, ndim + 1)[1:]
    return param_entries(path, ndim)


def param_placements(mesh, name: str, shape) -> Tuple[Placement, ...]:
    """Placements of the port tensor ``name`` on ``mesh``, divisibility-
    checked against its shape."""
    spec = fit_spec(mesh, port_param_entries(name, len(shape)), shape)
    return placements(mesh, spec)


def _distribute(t: torch.Tensor, mesh, name: str) -> DTensor:
    # Every rank holds the same tensor (the same seed, or the same
    # checkpoint), so each takes its own shard with no communication. The
    # copy keeps a replicated shard from aliasing the input.
    return distribute_tensor(t.detach().clone(), mesh,
                             param_placements(mesh, name, t.shape),
                             src_data_rank=None)


def replace_params(params: nn.Module, fn) -> nn.Module:
    """A copy of ``params`` (its module structure) whose parameter ``name``
    is ``fn(name, p)``; the input is left as it was."""
    out = copy.deepcopy(params)
    for name, p in params.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(owner), leaf,
                nn.Parameter(fn(name, p), requires_grad=p.requires_grad))
    return out


def distribute_params(params: nn.Module, mesh) -> nn.Module:
    """A copy of ``params`` whose every parameter is a DTensor under its
    rule; the input is left as it was."""
    return replace_params(params, lambda name, p: _distribute(p, mesh, name))


def distribute_named(named: dict, mesh) -> dict:
    """{parameter name: tensor} (the optimizer's state) onto ``mesh``, each
    under its parameter's rule (copies)."""
    return {name: _distribute(t, mesh, name)
            for name, t in named.items()}


def distribute_state(state: dict, mesh) -> dict:
    """The train state (``launch.steps.make_train_state``) with every tensor
    a DTensor under its rule: the reference's ``named_shardings`` and
    ``device_put`` in one. The input state is not changed."""
    opt = {k: distribute_named(v, mesh) for k, v in state["opt"].items()}
    return {"params": distribute_params(state["params"], mesh), "opt": opt,
            "step": state["step"]}


def full_params(params: nn.Module) -> nn.Module:
    """A copy of ``params`` with every DTensor parameter gathered to a full
    tensor (every rank takes part)."""
    return replace_params(params, lambda name, p: _full(p).detach().clone())


def full_state(state: dict) -> dict:
    """The train state with every DTensor gathered to a full tensor (every
    rank takes part); plain tensors are copied."""
    opt = {k: {n: _full(t).clone() for n, t in v.items()}
           for k, v in state["opt"].items()}
    return {"params": full_params(state["params"]), "opt": opt,
            "step": state["step"]}


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def distribute_cache(cache: dict, mesh, prefix: str = "") -> dict:
    """A decode cache (``Model.init_cache``: the reference's tree, stacked
    over layers) with every tensor a DTensor placed by the cache rules of
    its '/'-joined path; every rank holds the same cache, so each takes its
    own shard with no communication."""
    out = {}
    for k, v in cache.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = (distribute_cache(v, mesh, path) if isinstance(v, dict)
                  else distribute_tensor(v, mesh, placements(mesh, fit_spec(
                      mesh, param_entries(path, v.ndim), v.shape)),
                      src_data_rank=None))
    return out


def batch_axes(mesh, b: int):
    """The reference dry-run's ``_batch_axes``: ("pod", "data") where their
    product divides ``b``, else "data" alone where it does, else None."""
    names = _axis_names(mesh)
    axes = tuple(n for n in ("pod", "data") if n in names)
    if axes and b % _axis_prod(mesh, axes) == 0:
        return axes
    if "data" in names and b % _axis_prod(mesh, "data") == 0:
        return ("data",)
    return None


def shard_batch(batch: dict, mesh) -> dict:
    """A global batch (the same on every rank) as DTensors, dim 0 sharded
    over ``batch_axes`` (the reference dry-run's ``batch_shardings``: a
    batch that no batch axis divides stays replicated); DTensors pass
    through."""
    def spec(v):
        return placements(mesh, [batch_axes(mesh, v.shape[0])]
                          + [None] * (v.ndim - 1))

    return {k: v if isinstance(v, DTensor) else distribute_tensor(
                v, mesh, spec(v), src_data_rank=None)
            for k, v in batch.items()}
