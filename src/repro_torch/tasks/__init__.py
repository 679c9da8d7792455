"""The structured tasking façade of the port (TaskScope / TaskHandle /
parallel_for / map_reduce / TaskGraph), a pinned copy of the JAX package's
``tasks/api.py`` over ``repro_torch.core.schedulers``. The paper's benchmark
tasks (``graph``, ``jsonparse``) import JAX there and are queued in
ROADMAP.md."""

from repro_torch.tasks.api import (TaskCancelledError, TaskGraph,  # noqa: F401
                                   TaskGroupError, TaskHandle, TaskScope,
                                   map_reduce, parallel_for)
