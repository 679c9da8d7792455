"""norm_ms.score: the card's busy ms a batch in the port's norms, the span
``norm`` (``models/layers.py::norm``: each block's two and the final one);
timed on the regions stretch of ``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("norm",)


def read(run):
    return regions.ms_a_batch(run, NAMES)
