"""Multi-pod dry-run of the port: one sharded step of every (arch × shape ×
mesh) cell on meta tensors, and the roofline terms counted from it. The
port of ``src/repro/launch/dryrun.py``, which lowers and compiles each cell
for 512 fake TPU devices; here there is no compiler to ask, so each number
is counted from the step itself (each record's ``method`` says how):

  * PROOF: the train step (train and prefill shapes) or the serve step
    (decode) runs once on the production mesh, over a fake process group of
    256 or 512 ranks in this one process, on meta state that
    ``sharding.distribute_state`` (or ``distribute_params`` and
    ``distribute_cache``) placed. Meta tensors allocate nothing, as
    ``jax.eval_shape`` allocates nothing in the reference. If the step
    completes, the sharding is coherent.
  * Bytes per device: argument and output bytes are the sums of this
    rank's local shard sizes. Temp and peak come from tracking the local
    tensors' storages through the step (``_Meter``: a dispatch mode with
    weakref finalizers). They count allocations, not XLA's buffer
    assignment.
  * FLOPs per device: counted under the local op. The meter lets DTensor
    desugar each op into the local ops this rank runs and counts those with
    torch's flop formulas (``torch.utils.flop_counter``), so a sharded op
    counts its shard and a replicated one counts whole on every rank. The
    ops DTensor runs on FakeTensors only to propagate global shapes are not
    counted.
  * Collective wire bytes per device: the c10d functional collectives and
    the rings' P2P moves that the local step makes, with the reference's
    ring-algorithm factors (``wire_bytes``). On meta tensors a ring's move
    sends nothing and names its bytes to the meter
    (``collective_matmul.meta_moves``), so a config with
    ``mlp_tp_overlap=True`` is costed as the reference costs it.

There is no depth extrapolation (the reference's ``_cost_points``): XLA's
cost analysis counts a scanned ``while`` body once, so the reference lowers
two unrolled depths and extrapolates; eager execution runs, and so counts,
every layer. The cells take the reference's cost configuration
(``_prep_cfg``): decode in bf16 parameters without remat, train and
prefill under the config's own remat (``cfg.remat``: "full" keeps only
each block's inputs for the backward and recomputes the block there, so
the FLOPs count that recompute and the live bytes fall; "dots" keeps the
2-D products' outputs besides), and chunked attention in tiles of 4096 x
8192 (FLOPs do not depend on the tiles).

Run on the CPU, no card needed:

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh pod|multipod|both] [--force] [--sites]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke

Records go to ``build/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import sharding as shd
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import collective_matmul as cm
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh
from repro_torch.launch.steps import (abstract_serve_state,
                                      abstract_train_state, make_serve_step,
                                      make_train_step)
from repro_torch.models.registry import build_model
from repro_torch.optim import OptConfig

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# NVIDIA H100 SXM 80GB data-sheet figures (dense, no sparsity), per card;
# not measured (NVLink cannot be measured on a one-card machine).
PEAK_FLOPS = 989e12        # bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12           # HBM3, B/s
NVLINK_BW = 450e9          # NVLink 4, B/s per direction per GPU

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

METHOD = {
    "proof": "one sharded step on meta tensors over a fake process group "
             "(torch.distributed 'fake' backend), state placed by "
             "repro_torch.sharding",
    "argument_bytes": "sum of this rank's local shard sizes of the step's "
                      "arguments (state or params + cache, and the batch); "
                      "the train step's Python-int step holds none",
    "output_bytes": "sum of the local shard sizes of the step's outputs",
    "temp_bytes": "largest sum of bytes of local tensors allocated by the "
                  "step and alive at one time (storages tracked by a "
                  "dispatch mode with weakref finalizers; allocations, not "
                  "XLA's buffer assignment)",
    "alias_bytes": "outputs held in an argument's storage (updated in "
                   "place)",
    "peak_bytes_est": "argument_bytes + temp_bytes",
    "hlo_flops": "torch.utils.flop_counter formulas over the local ops this "
                 "rank runs (DTensor desugared; shape propagation on "
                 "FakeTensors not counted); every layer runs, no "
                 "extrapolation",
    "hlo_bytes": "inputs read once and outputs written once by every local "
                 "op that is not a view or a collective (eager: no fusion)",
    "collective_wire_bytes": "c10d functional collectives and the rings' "
                             "P2P moves of the local step, times the "
                             "reference's ring factors (wire_bytes)",
    "constants": "H100 SXM 80GB data sheet: 989e12 FLOP/s bf16 dense, "
                 "3.35e12 B/s HBM3, 450e9 B/s NVLink 4 per direction",
}


def wire_bytes(kind: str, size: float, group: int) -> float:
    """Ring-algorithm wire bytes per device of one collective of ``kind``
    whose per-device result holds ``size`` bytes, over ``group`` ranks (the
    reference's ``parse_collectives`` factors). A reduce-scatter's result is
    the scattered shard; a collective-permute (a ring's P2P move) sends its
    buffer once."""
    if kind in ("all-gather", "all-to-all"):
        return size * (group - 1) / group
    if kind == "all-reduce":
        return 2 * size * (group - 1) / group
    if kind == "reduce-scatter":
        return size * (group - 1)
    if kind == "collective-permute":
        return size
    raise ValueError(f"unknown collective {kind!r}")


def _collective_ops() -> dict:
    """{op packet: (kind, index of the group-size or group-name argument)}
    for the collectives the local step can run (the functional ops that
    DTensor's redistributions run, and the P2P send of the rings)."""
    table = {
        "all_gather_into_tensor": ("all-gather", 2),
        "all_gather_into_tensor_coalesced": ("all-gather", 2),
        "all_reduce": ("all-reduce", 2),
        "all_reduce_coalesced": ("all-reduce", 2),
        "reduce_scatter_tensor": ("reduce-scatter", 3),
        "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
        "all_to_all_single": ("all-to-all", 3),
    }
    out = {}
    for name, entry in table.items():
        op = getattr(torch.ops._c10d_functional, name, None)
        if op is not None:
            out[op] = entry
    out[torch.ops.c10d.send] = ("collective-permute", None)
    return out


def _group_size(arg) -> int:
    if isinstance(arg, int):
        return arg
    return dist.distributed_c10d._resolve_process_group(arg).size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _under_fake_mode() -> bool:
    """True while a FakeTensorMode is active: DTensor's sharding
    propagation runs ops on fake global-shape tensors to learn their output
    shapes, and that work is no rank's."""
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


_FRAME = re.compile(r'File "([^"]*)", line \d+, in (\S+)')
# frames that issue collectives for their callers: the site is the caller
_RELAY = ("sharding.py", "launch/dryrun.py")


def _site(frames, relay=_RELAY) -> Optional[str]:
    """``module:function`` of the innermost port frame in ``frames``
    ((file, function) pairs, innermost first) that is not in ``relay``."""
    for path, fn in frames:
        _, pkg, rel = path.replace("\\", "/").rpartition("/repro_torch/")
        if pkg and not rel.endswith(relay):
            return f"{rel}:{fn}"
    return None


def _issuing_site() -> str:
    """Where the collective being counted comes from: the live stack's
    innermost port frame in the forward ("forward"); in the backward, the
    block a remat recompute reruns ("recompute"), else the forward frame
    that recorded the autograd node now running (anomaly mode keeps it:
    "backward")."""
    live = [(f.f_code.co_filename, f.f_code.co_name)
            for f, _ in traceback.walk_stack(None)]
    node = torch._C._current_autograd_node()
    if node is None:
        return f"{_site(live)} forward"
    site = _site(live, _RELAY + ("launch/steps.py",))
    if site is not None:
        return f"{site} recompute"
    tb = "".join(node.metadata.get("traceback_", []))
    return f"{_site(reversed(_FRAME.findall(tb)))} backward"


class _Meter(TorchDispatchMode):
    """Counts what this rank runs inside the block: FLOPs, bytes read and
    written, collective wire bytes by kind, and the bytes of local tensors
    alive (``live``, its high-water mark ``peak``), from zero at entry.
    DTensor ops return ``NotImplemented`` here, so DTensor runs them and
    the meter sees the local ops they become. ``hold`` marks storages that
    existed before (the arguments), so views of them count nothing. With
    ``sites`` the wire bytes are also summed by the port's call site that
    issued them (``by_site``, from ``_issuing_site``; the backward's sites
    need anomaly mode on while the step runs)."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.by_site = {} if sites else None
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0.0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._colls = _collective_ops()

    def hold(self, tensors) -> None:
        for t in tensors:
            self._seen[t.untyped_storage()] = 0

    def __enter__(self):
        cm.meta_moves.append(self._ring_move)
        return super().__enter__()

    def __exit__(self, *exc):
        cm.meta_moves.remove(self._ring_move)
        return super().__exit__(*exc)

    def _ring_move(self, size: int) -> None:
        """A ring's P2P move of ``size`` bytes, made on meta tensors (which
        no backend sends): a collective-permute, as ``c10d.send`` is."""
        self._count("collective-permute",
                    wire_bytes("collective-permute", size, 2))

    def _count(self, kind: str, wire: float) -> None:
        self.coll[kind] += wire
        self.counts[kind] += 1
        if self.by_site is not None:
            site = _issuing_site()
            self.by_site[site] = self.by_site.get(site, 0.0) + wire

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _under_fake_mode():
            return out
        packet = func._overloadpacket
        coll = self._colls.get(packet)
        if coll is not None:
            kind, at = coll
            size = sum(_nbytes(t) for t in tree_leaves(
                out if at is not None else args[0])
                if isinstance(t, torch.Tensor))
            group = 2 if at is None else _group_size(args[at])
            self._count(kind, wire_bytes(kind, size, group))
        elif not func.is_view and func.namespace not in ("_c10d_functional",
                                                         "c10d"):
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, out))
                              if isinstance(t, torch.Tensor))
        self._track(out)
        return out


def _local_tensors(tree):
    """The local tensors of every tensor in ``tree`` (dicts, lists, tuples
    and modules, whose parameters count)."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _local_tensors(t)
    elif isinstance(tree, torch.Tensor):
        yield tree.to_local() if isinstance(tree, DTensor) else tree


# ---------------------------------------------------------------------------
# Model FLOPs (analytic 6·N·D for train, 2·N·D for a decode token)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig, active_only: bool = False) -> float:
    """Parameters of ``cfg``, counted on the meta state (nothing drawn);
    with ``active_only`` an MoE counts its top-k experts of each layer."""
    params = build_model(cfg, "meta").init(torch.Generator())
    total = sum(p.numel() for p in params.parameters())
    if active_only and cfg.moe is not None:
        mc = cfg.moe
        per_expert = 3 * cfg.d_model * mc.d_ff
        total -= cfg.n_layers * per_expert * (mc.n_experts - mc.top_k)
    return float(total)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = count_params(cfg, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def kv_plan_costs(cfg: ModelConfig, shape: ShapeConfig,
                  mesh_shape: tuple) -> Optional[dict]:
    """Attention's k and v projections on a ("data", "model") mesh of
    ``mesh_shape`` whose ``model`` axis cuts the q heads, costed per device
    for one train step at the data-sheet rates, two ways.
    "duplicated" (``models/attention.py::_attention_sharded``): every rank
    projects, from its gathered block input, the kv heads its q heads read,
    so a kv head read by q heads on several ranks is projected on each:
    ``flops`` above one projection of each kv head over the mesh (forward,
    the two backward products, and the remat recompute under "full").
    "all_reduced" (DTensor's plan before it): each rank projects every kv
    head from its d_model shard and all-reduces the partial k and v over
    ``model``, forward and backward (and again in the recompute): ``bytes``
    on the wire. ``s`` is each at its rate (``PEAK_FLOPS``, ``NVLINK_BW``).
    None where ``model`` does not divide the q heads (no rank cuts them)."""
    data, model = mesh_shape
    rows = shape.global_batch // data * shape.seq_len
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if h % model:
        return None     # the q heads stay whole on every rank: no cut
    q_loc, group = h // model, h // kv
    read = max(len({(r * q_loc + j) // group for j in range(q_loc)})
               for r in range(model))
    passes = 3 + (cfg.remat == "full")
    head = 2 * rows * cfg.d_model * hd          # one kv head's product
    flops = cfg.n_layers * passes * 2 * head * (read - kv / model)
    moved = cfg.n_layers * (2 + (cfg.remat == "full")) * 2 * wire_bytes(
        "all-reduce", rows * kv * hd * 2, model)
    return {"duplicated": {"flops": flops, "s": flops / PEAK_FLOPS},
            "all_reduced": {"bytes": moved, "s": moved / NVLINK_BW}}


def mamba2_w_in_costs(cfg: ModelConfig, shape: ShapeConfig,
                      mesh_shape: tuple) -> dict:
    """Mamba-2's w_in [D, in_dim] (columns ``[z | x | B | C | dt]``, cut
    contiguously over ``model`` by the rules, d_model over ``data``) on a
    ("data", "model") mesh of ``mesh_shape`` whose ``model`` axis cuts the
    heads: the forward's wire bytes a device a layer of the two routes to
    each rank's heads' columns (the backward mirrors each). "gather"
    (``models/mamba2.py::_mamba2_sharded``): w_in gathered whole in bf16
    and cut. "move": the rank's contiguous columns gathered over ``data``
    and projected, then the bf16 activations of the columns its heads need
    (their z, x and dt, and B and C) that another rank projected moved to
    it (the largest such share of any rank)."""
    data, model = mesh_shape
    rows = shape.global_batch // data * shape.seq_len
    s, d = cfg.ssm, cfg.d_model
    d_inner = s.expand * d
    h, n = d_inner // s.head_dim, s.state_dim
    in_dim = 2 * d_inner + 2 * n + h
    weight = d * in_dim * 2
    c_loc, h_loc, per = d_inner // model, h // model, in_dim // model
    remote = 0
    for r in range(model):
        need = (set(range(r * c_loc, (r + 1) * c_loc))
                | set(range(d_inner + r * c_loc, d_inner + (r + 1) * c_loc))
                | set(range(2 * d_inner, 2 * d_inner + 2 * n))
                | set(range(2 * d_inner + 2 * n + r * h_loc,
                            2 * d_inner + 2 * n + (r + 1) * h_loc)))
        remote = max(remote, len(need - set(range(r * per, (r + 1) * per))))
    return {"gather": wire_bytes("all-gather", weight, data * model),
            "move": wire_bytes("all-gather", weight // model, data)
            + rows * remote * 2}


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _prep_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """The reference's cost configuration: decode in bf16 parameters with
    no remat (train and prefill keep the config's remat); the default
    chunked-attention tiles coarsened to 4096 x 8192 (FLOPs are
    tiling-invariant, and a long sequence in small tiles is tens of
    thousands of eager ops a layer)."""
    kw = {}
    if shape.kind == "decode":
        kw["param_dtype"] = "bfloat16"
        kw["remat"] = "none"
    if cfg.attn_chunk_q == 512:
        kw["attn_chunk_q"] = 4096
    if cfg.attn_chunk == 1024:
        kw["attn_chunk"] = 8192
    return cfg.replace(**kw)


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 sites: bool = False) -> dict:
    """Run one sharded step of ``cfg`` at ``shape`` on ``mesh`` over meta
    state under the meter; returns {"memory", "per_device", "step_s"} for
    this rank. ``cfg`` is taken as given (``run_cell`` preps it). With
    ``mesh=None`` the same step runs unsharded, in one process. With
    ``sites`` the step runs in anomaly mode and ``per_device`` gains
    ``collective_by_site`` ({"module:function phase": wire bytes}, largest
    first)."""
    model = build_model(cfg, "meta")
    batch, cache_len = model.input_specs(shape)
    if mesh is not None:
        batch = shd.shard_batch(batch, mesh)
    if shape.kind == "decode":
        params, cache = abstract_serve_state(model, shape)
        if mesh is not None:
            params = shd.distribute_params(params, mesh)
            cache = shd.distribute_cache(cache, mesh)
        args = (params, cache, batch["tokens"])
        step = make_serve_step(model, mesh)
        call = lambda: step(*args, cache_len - 1)        # noqa: E731
    else:
        state = abstract_train_state(model)
        if mesh is not None:
            state = shd.distribute_state(state, mesh)
        args = (state, batch)
        step = make_train_step(model, OptConfig(), mesh=mesh)
        call = lambda: step(*args)                       # noqa: E731
    arg_local = list(_local_tensors(args))
    meter = _Meter(sites)
    meter.hold(arg_local)
    anomaly = (torch.autograd.detect_anomaly(check_nan=False) if sites
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with anomaly, meter:
        out = call()
    step_s = time.perf_counter() - t0
    held = {id(t.untyped_storage()) for t in arg_local}
    out_local = list(_local_tensors(out))
    arg_bytes = sum(_nbytes(t) for t in arg_local)
    mem = {
        "argument_bytes": arg_bytes,
        "output_bytes": sum(_nbytes(t) for t in out_local),
        "temp_bytes": meter.peak,
        "alias_bytes": sum(_nbytes(t) for t in out_local
                           if id(t.untyped_storage()) in held),
        "peak_bytes_est": arg_bytes + meter.peak,
    }
    coll = dict(meter.coll)
    per_device = {
        "hlo_flops": float(meter.flops),
        "hlo_bytes": float(meter.bytes),
        "collective_wire_bytes": sum(coll.values()),
        "collective_by_kind": coll,
        "collective_counts": dict(meter.counts),
    }
    if sites:
        per_device["collective_by_site"] = dict(sorted(
            meter.by_site.items(), key=lambda kv: -kv[1]))
    return {"memory": mem, "per_device": per_device, "step_s": step_s}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             force: bool = False, sites: bool = False) -> dict:
    """The record of one cell, from ``ART_DIR`` unless ``force``; the
    default group must be the fake group of the mesh's size. ``sites``:
    see ``analyze_cell``."""
    ART_DIR.mkdir(parents=True, exist_ok=True)
    out_path = ART_DIR / f"{arch}__{shape_name}__{mesh_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": why}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                device="cpu")
    n_chips = mesh.size()
    cost = analyze_cell(_prep_cfg(cfg, shape), shape, mesh, sites=sites)
    mf = model_flops(cfg, shape)
    dev = cost["per_device"]
    terms = {
        "compute_s": dev["hlo_flops"] / PEAK_FLOPS,
        "memory_s": dev["hlo_bytes"] / HBM_BW,
        "collective_s": dev["collective_wire_bytes"] / NVLINK_BW,
    }
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_chips": n_chips,
        "step_s": round(cost["step_s"], 2),
        "memory": cost["memory"],
        "per_device": dev,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (dev["hlo_flops"] * n_chips)
                               if dev["hlo_flops"] else None),
        "roofline_terms_s": terms,
        "dominant": max(terms, key=terms.get),
        "method": METHOD,
    }
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


@contextlib.contextmanager
def fake_group(world_size: int):
    """The default process group as ``world_size`` fake ranks in this one
    process (rank 0's view: collectives move nothing). Only the dry-run
    starts it; it is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# every family's SMOKE train cell: train_4k cut to sequence 128 and batch 8,
# on the reference test's (4, 2) mesh
SMOKE_CELL = ("train_4k", 128, 8)
SMOKE_MESH = (4, 2)


def smoke_train_counts() -> dict:
    """{arch: collective wire bytes a device} of each family's SMOKE train
    cell (``SMOKE_CELL``) on a ``SMOKE_MESH`` ("data", "model") mesh over a
    fake group in this process (none may exist)."""
    name, seq, batch = SMOKE_CELL
    shape = dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)
    out = {}
    with fake_group(math.prod(SMOKE_MESH)):
        mesh = dist.device_mesh.init_device_mesh(
            "cpu", SMOKE_MESH, mesh_dim_names=("data", "model"))
        for arch in ARCH_IDS:
            cost = analyze_cell(get_config(arch, smoke=True), shape, mesh)
            out[arch] = cost["per_device"]["collective_wire_bytes"]
    return out


def _mesh_size(mesh_name: str) -> int:
    return math.prod(PRODUCTION_MESHES[mesh_name == "multipod"][0])


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sites", action="store_true",
                    help="also sum the collective bytes by the call site "
                         "that issued them (anomaly mode: slower)")
    ap.add_argument("--smoke", action="store_true",
                    help="print every family's SMOKE train cell's collective "
                         "wire bytes a device as JSON (SMOKE_CELL on "
                         "SMOKE_MESH) and stop")
    args = ap.parse_args(argv)
    if args.smoke:
        print(json.dumps(smoke_train_counts()), flush=True)
        return 0

    archs = [a for a in ARCH_IDS if a != "relic_tiny"] \
        if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = []
    t_all = time.time()
    for mesh_name in meshes:
        with fake_group(_mesh_size(mesh_name)):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch} × {shape} × {mesh_name}"
                    try:
                        t0 = time.time()
                        rec = run_cell(arch, shape, mesh_name,
                                       force=args.force, sites=args.sites)
                        if "skipped" in rec:
                            print(f"[skip] {tag}: {rec['skipped']}",
                                  flush=True)
                        else:
                            t = rec["roofline_terms_s"]
                            print(
                                f"[ok]   {tag}: dom={rec['dominant']} "
                                f"comp={t['compute_s']:.4f}s "
                                f"mem={t['memory_s']:.4f}s "
                                f"coll={t['collective_s']:.4f}s "
                                f"({time.time() - t0:.0f}s wall)", flush=True)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        failures.append((tag, repr(e)))
                        print(f"[FAIL] {tag}: {e!r}", flush=True)
    print(f"\nwall {time.time() - t_all:.1f} s")
    if failures:
        print(f"{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        return 1
    print("All requested dry-run cells passed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
