"""mlp_ms.score: the card's busy ms a batch in the port's MLPs, the span
``mlp`` (``models/layers.py::mlp``); timed on the regions stretch of
``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("mlp",)


def read(run):
    return regions.ms_a_batch(run, NAMES)
