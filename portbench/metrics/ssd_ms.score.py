"""ssd_ms.score: the card's busy ms a batch in the port's Mamba-2
recurrence, the span ``mamba.ssd`` (``models/mamba2.py::mamba2_block``: dt's
softplus, the decay, the SSD launch and the D skip); timed on the regions
stretch of ``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("mamba.ssd",)


def read(run):
    return regions.ms_a_batch(run, NAMES)
