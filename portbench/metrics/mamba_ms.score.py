"""mamba_ms.score: the card's busy ms a batch in the port's Mamba-2 layers
outside the recurrence: the spans ``mamba.in`` (the in-projection),
``mamba.conv`` (the depthwise conv, its bias and SiLU),
``mamba.gate_norm`` (the gated RMSNorm) and ``mamba.out`` (the
out-projection) of ``models/mamba2.py::mamba2_block``; timed on the
regions stretch of ``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("mamba.in", "mamba.conv", "mamba.gate_norm", "mamba.out")


def read(run):
    return regions.ms_a_batch(run, NAMES)
