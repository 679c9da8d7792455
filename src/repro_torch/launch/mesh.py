"""Mesh builders and process groups: the port of ``src/repro/launch/mesh.py``
on ``torch.distributed``.

A JAX mesh is a view of the devices one process sees; a ``DeviceMesh`` is a
view of the ranks of a process group, so the port adds what JAX gets for
free: ``init_distributed`` starts the default group (from ``torchrun``'s
environment when it is set, else as one rank), and ``spawn`` starts a job of
ranks on this host (the CPU tests and ``repro_torch.elastic_restart`` run
their multi-rank jobs through it, over gloo). The backend follows the
device: NCCL for ``cuda``, gloo for ``cpu``. There is no fallback: a group
that cannot be initialized raises.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.devices import resolve_device

#: Seconds a rank waits for a collective (and for the group to form).
INIT_TIMEOUT_S = 60.0


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device: Any = "cuda", *, store: Optional[dist.Store] = None,
                     rank: int = 0, world_size: int = 1,
                     timeout_s: float = INIT_TIMEOUT_S) -> int:
    """Initialize the default process group on ``device``'s backend; returns
    this process's rank. Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set)
    the group forms from its environment; otherwise from ``store`` with the
    given rank and size, or, with no store, as a single rank over an
    in-process ``HashStore`` (no port, no file). A group that already exists
    is kept. On the card each rank takes device ``LOCAL_RANK`` (or its rank)
    and NCCL initializes at once, so a broken NCCL fails here."""
    device = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    kwargs = {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and store is None:
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        if store is None:
            store, rank, world_size = dist.HashStore(), 0, 1
        kwargs = {"store": store, "rank": rank, "world_size": world_size}
        local = rank
    if device.type == "cuda":
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(_backend(device), timeout=timeout, **kwargs)
    return dist.get_rank()


#: The reference's production meshes: one pod of 16 x 16 chips, or two
#: pods with a leading "pod" axis.
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device: Any = "cuda") -> DeviceMesh:
    """The 16x16 ``("data", "model")`` mesh, or the 2x16x16 one with
    ``"pod"`` first, over the default group, which must hold exactly 256
    (512) ranks. Nothing falls back to a smaller mesh: any other group, or
    none, raises. (The one process that builds these on a single host is
    the dry-run, over a fake group of that many ranks.)"""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != n:
        raise RuntimeError(f"the production mesh {shape} needs a default "
                           f"group of {n} ranks; it holds {have}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Any = "cuda") -> DeviceMesh:
    """Arbitrary mesh over the default group's ranks (tests, examples,
    elastic re-mesh); the group must hold exactly ``prod(shape)`` ranks."""
    device = resolve_device(device)
    init_distributed(device)
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device: Any = "cuda") -> DeviceMesh:
    """Every rank of the job (the ranks ``torchrun`` started, or this one
    process), as a 1-D ``data`` mesh."""
    device = resolve_device(device)
    init_distributed(device)
    return make_mesh((dist.get_world_size(),), ("data",), device)


# ---------------------------------------------------------------------------
# A job of ranks on this host
# ---------------------------------------------------------------------------

def _rank_main(fn, args, rank, world_size, device, store_path, timeout_s,
               results):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world_size)
        init_distributed(device, store=store, rank=rank,
                         world_size=world_size, timeout_s=timeout_s)
        out = fn(*args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the job
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, device: Any = "cpu",
          timeout_s: float = 300.0, init_timeout_s: float = INIT_TIMEOUT_S,
          store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` fresh processes that form one
    group over a ``FileStore`` (no TCP port, so parallel jobs cannot
    collide); returns each rank's result, by rank. ``fn`` must be a
    module-level function (it is pickled by name). The job gets
    ``timeout_s`` in all; when a rank fails or the time runs out every rank
    is killed and ``RuntimeError`` / ``TimeoutError`` is raised with the
    first failure's traceback. Each rank runs one intra-op thread."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_job_", dir=store_dir)
    results = ctx.Queue()
    procs = []
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"   # read by each rank at start
    try:
        for rank in range(world_size):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                fn, args, rank, world_size, str(device),
                os.path.join(tmp, "store"), init_timeout_s, results))
            p.start()
            procs.append(p)
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    try:
        deadline = time.monotonic() + timeout_s
        out: dict = {}
        while len(out) < world_size:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(min(left, 1.0), 0.01))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if left <= 0:
                    raise TimeoutError(f"job of {world_size} ranks did not "
                                       f"finish in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
