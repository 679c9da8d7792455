"""``repro_torch.workloads`` — the paper's kernels as first-class workloads.

The port of ``src/repro/workloads``. Each workload is *n* identical
instances of one fine-grained kernel plus an independent oracle, exposing
the same three execution variants through the :mod:`repro_torch.tasks.api`
façade — ``serial()``, ``paired(scope)`` (the paper's two-instance offload,
producer runs one half) and ``chunked(scope, grain)`` (worksharing via
``parallel_for``) — plus ``fused_task()`` (one batched call over the
stacked instances) and ``streamed(substrate)``. See
:mod:`repro_torch.workloads.base` for the protocol; ``chip_smoke.py`` times
the paired-over-serial table on the card.

Registered workloads: the paper's seven (``bc``, ``bfs``, ``cc``, ``pr``,
``sssp``, ``tc``, ``json``) plus two scenario-diverse additions
(``stencil``, ``histogram``).
"""

from repro_torch.workloads.base import (VARIANTS, Workload, WorkloadOracleError,
                                        available_workloads, make_workload,
                                        register_workload, results_agree,
                                        split_instances)

# Importing the workload modules populates the registry.
from repro_torch.workloads import graphs as _graphs          # noqa: F401
from repro_torch.workloads import histogram as _histogram    # noqa: F401
from repro_torch.workloads import jsondoc as _jsondoc        # noqa: F401
from repro_torch.workloads import stencil as _stencil        # noqa: F401

# The subset reproducing the paper's own table (§IV), in paper order.
PAPER_WORKLOADS = ("bc", "bfs", "cc", "pr", "sssp", "tc", "json")

__all__ = [
    "Workload",
    "WorkloadOracleError",
    "VARIANTS",
    "PAPER_WORKLOADS",
    "available_workloads",
    "make_workload",
    "register_workload",
    "results_agree",
    "split_instances",
]
