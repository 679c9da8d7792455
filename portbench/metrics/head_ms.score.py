"""head_ms.score: the card's busy ms a batch in the port's head: the spans
``lm.head`` (``models/lm.py::_head`` less its final norm: the unembedding
and the f32 logits) and ``lm.log_likelihood``
(``models/layers.py::log_likelihood``); timed on the regions stretch of
``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("lm.head", "lm.log_likelihood")


def read(run):
    return regions.ms_a_batch(run, NAMES)
