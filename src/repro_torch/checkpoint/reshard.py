"""Elastic restart: restore a checkpoint onto a different mesh. The port of
``src/repro/checkpoint/reshard.py``.

Losing a pod (or growing one) changes the mesh, but checkpoints store
*global* arrays, so elastic restart is: start the job on the surviving
ranks, build that mesh, and place the restored state on it under the same
partition rules. ``reshard_state`` does the same for live state with no disk
round-trip: DTensor cannot redistribute across meshes, so each tensor is
gathered to its full value and distributed again.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch import sharding as shd
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.convert import train_state_from_tree, train_state_keys


def reshard_state(state: dict, new_mesh) -> dict:
    """Re-place a live train state (plain or distributed) onto
    ``new_mesh`` per the partition rules; every rank of the old mesh takes
    part in gathering it."""
    return shd.distribute_state(shd.full_state(state), new_mesh)


def elastic_restore(mgr: CheckpointManager, template: dict, new_mesh,
                    step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore the latest checkpoint (or ``step``) as a train state laid out
    like the port's ``template`` (plain or distributed, on any mesh) and
    distributed on ``new_mesh``, which may have another shape than the mesh
    that wrote it. Returns (state, step)."""
    tree, at = mgr.restore(train_state_keys(template), step=step,
                           device=new_mesh.device_type)
    return shd.distribute_state(train_state_from_tree(template, tree),
                                new_mesh), at
