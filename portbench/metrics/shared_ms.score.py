"""shared_ms.score: the card's busy ms a batch in what the published
Zamba2's shared-block uses add beside attention, norms and the MLP: the
spans ``shared.concat`` (the block's input ``concat(h, embedding)``),
``shared.adapter`` (each use's low-rank adapter on the gate and up
products) and ``shared.link`` (each use's link projection into the Mamba
layer's input) of ``models/zamba2.py``; timed on the regions stretch of
``harness/regions.py``. With the other eight ``*_ms.score`` metrics it
tiles a Zamba2 batch's forward and log-likelihood."""

from portbench.harness import regions

NAMES = ("shared.concat", "shared.adapter", "shared.link")


def read(run):
    return regions.ms_a_batch(run, NAMES)
