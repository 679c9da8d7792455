"""Fault-tolerance walkthrough of the port: the JAX package's
``examples/elastic_restart.py`` as a module of ``repro_torch``. Train on a
healthy mesh, checkpoint asynchronously, "lose" half the data-parallel
capacity, and resume on the shrunken mesh from the same checkpoint — the
elastic-restart path a deployment takes after losing hosts.

The reference forces 8 fake host devices so the mesh shrink (4x2 -> 2x2) is
real; here the meshes are real jobs of gloo ranks on this host's CPU
(``repro_torch.launch.mesh.spawn``): an 8-rank job on ``(4, 2)`` trains
relic_tiny SMOKE and saves, the re-mesh is planned from the heartbeats
(``runtime.plan_elastic_remesh``), and a new 4-rank job on ``(2, 2)``
restores (``checkpoint.elastic_restore``) and trains on. A card machine has
one card, so the demo runs on the CPU, as the reference's does.

Run:  PYTHONPATH=src python -m repro_torch.elastic_restart
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Optional, Tuple

import torch

from repro_torch import sharding as shd
from repro_torch.checkpoint import CheckpointManager, elastic_restore
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.optim import OptConfig
from repro_torch.runtime import HeartbeatTracker, plan_elastic_remesh

AXES = ("data", "model")
JOB_TIMEOUT_S = 300


def train_phase(ckpt: str, mesh_shape: Tuple[int, ...], first: int,
                last: int, restore_step: Optional[int]):
    """One job's part, on every rank: build ``mesh_shape``, start from the
    seed (``restore_step`` None, then save at ``last``) or restore
    ``restore_step`` from ``ckpt``, and train steps ``first`` to ``last``.
    Returns (the final loss, the step it started from, the mesh shape of a
    parameter's DTensor)."""
    mesh = make_mesh(mesh_shape, AXES, "cpu")
    cfg = get_config("relic_tiny", smoke=True)
    model = build_model(cfg, "cpu")
    oc = OptConfig(warmup_steps=2, total_steps=40)
    src = SyntheticLM(DataConfig(seq_len=64, global_batch=8,
                                 vocab_size=cfg.vocab_size))
    step_fn = make_train_step(model, oc, mesh=mesh)
    state = make_train_state(model, torch.Generator().manual_seed(0))
    mgr = CheckpointManager(ckpt, async_=True)   # the Relic assistant
    try:
        if restore_step is None:
            state, at = shd.distribute_state(state, mesh), first
        else:
            state, at = elastic_restore(mgr, state, mesh, step=restore_step)
        for i in range(first, last):
            batch = {k: torch.as_tensor(v) for k, v in src.batch(i).items()}
            state, metrics = step_fn(state, batch)
        if restore_step is None:
            mgr.save(train_state_to_numpy(state), last, block=True)
    finally:
        mgr.close()
    table = state["params"].get_parameter("embed.table")
    return float(metrics["loss"]), at, tuple(table.device_mesh.shape)


def main() -> None:
    ckpt = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        run(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def run(ckpt: str) -> None:
    healthy = (4, 2)
    print(f"[healthy] mesh {dict(zip(AXES, healthy))} (8 gloo ranks)")
    loss, _, _ = spawn(train_phase, 8, ckpt, healthy, 0, 6, None,
                       timeout_s=JOB_TIMEOUT_S)[0]
    print(f"[healthy] step 6 loss {loss:.4f}; checkpoint saved")

    # --- failure: two hosts (half the data axis) stop heartbeating --------
    t = {"now": 0.0}
    hb = HeartbeatTracker(n_hosts=4, timeout_s=30, clock=lambda: t["now"])
    t["now"] = 60.0
    for h in (0, 1):
        hb.beat(h)
    dead = hb.dead()
    print(f"[failure] dead hosts: {dead}")
    plan = plan_elastic_remesh(healthy, AXES, dead, chips_per_host=1,
                               restore_step=6)
    print(f"[plan] {plan.old_shape} -> {plan.new_shape}, "
          f"resume @ {plan.restore_step}")

    # --- elastic restart on the surviving mesh: a new, smaller job --------
    n = plan.new_shape[0] * plan.new_shape[1]
    loss, at, shape = spawn(train_phase, n, ckpt, tuple(plan.new_shape), 6,
                            10, plan.restore_step,
                            timeout_s=JOB_TIMEOUT_S)[0]
    print(f"[restart] restored step {at} onto "
          f"{dict(zip(plan.axes, shape))} ({n} gloo ranks)")
    print(f"[restart] step 10 loss {loss:.4f} — training continued")
    print("elastic restart OK")


if __name__ == "__main__":
    main()
