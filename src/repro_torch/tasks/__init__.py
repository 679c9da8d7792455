"""The paper's fine-grained benchmark tasks (graph kernels + JSON parsing)
in PyTorch, and the structured tasking façade every workload targets.

``repro_torch.tasks.api`` is a pinned copy of the JAX package's tasking
surface (TaskScope / TaskHandle / parallel_for / map_reduce / TaskGraph)
over ``repro_torch.core.schedulers``; ``graph`` and ``jsonparse`` are torch
ports of the reference's kernels, and ``streams`` gives each task thread
its own CUDA stream.
"""

from repro_torch.tasks import graph, jsonparse  # noqa: F401
from repro_torch.tasks.api import (TaskCancelledError, TaskGraph,  # noqa: F401
                                   TaskGroupError, TaskHandle, TaskScope,
                                   map_reduce, parallel_for)
from repro_torch.tasks.graph import gap_task_graph, run_wavefronts  # noqa: F401
