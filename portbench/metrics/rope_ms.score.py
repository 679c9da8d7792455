"""rope_ms.score: the card's busy ms a batch in the port's RoPE, the span
``attn.rope`` (q's and k's ``apply_rope`` in
``models/attention.py::self_attention``); timed on the regions stretch of
``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("attn.rope",)


def read(run):
    return regions.ms_a_batch(run, NAMES)
