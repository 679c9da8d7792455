"""The program's regions (its spans, ``repro_torch.runtime.spans``), timed
on a stretch of their own for the ``*_ms.score`` metrics.

The spans stay off in the window and in the traced stretch, so neither
carries their cost. Once the run's other readings are taken, the first of
those readers builds the cell's traffic again on the same seed, warms it
and profiles one more stretch of it with the spans on; each device
operation is given to the innermost span that launched it. A metric is
its spans' busy ms over that stretch a batch (a batch is one
``lm.forward``). A program without spans gives nothing.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, Optional


def table(run) -> Optional[Dict[str, object]]:
    """{span name: (count, busy ms)} of the run's regions stretch, made once
    a run; None for a program without spans."""
    if "_regions" not in vars(run):
        run._regions = _profile(run)
    return run._regions


def _profile(run):
    try:
        from repro_torch.runtime import spans
    except ImportError:     # a program without spans
        return None
    import torch

    on_card = torch.device(run.device).type == "cuda"
    traffic = run.cell.kind_module().Traffic(run)
    traffic.setup()
    out = spans.profile(traffic.stretch, on_card)
    traffic.release()
    del traffic
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rows = "; ".join(f"{n} {r.count} {r.busy_ms!r}" for n, r in out.items())
    print(f"portbench: the program's regions on a stretch of their own "
          f"(span, ranges, busy ms): {rows}", file=sys.stderr)
    return out


def ms_a_batch(run, names) -> Optional[float]:
    """Busy ms a batch of the spans ``names`` (None where none ran)."""
    t = table(run)
    if not t or "lm.forward" not in t or not any(n in t for n in names):
        return None
    return sum(t[n].busy_ms for n in names if n in t) / t["lm.forward"].count
