"""other_ms.score: the card's busy ms a batch in the port's forward outside
every named region: the spans ``lm.forward``, ``lm.block`` (the residual
adds) and ``lm.embed``. With the five other ``*_ms.score`` metrics it
tiles each batch's forward and log-likelihood; timed on the regions
stretch of ``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("lm.forward", "lm.block", "lm.embed")


def read(run):
    return regions.ms_a_batch(run, NAMES)
