"""attention_ms.score: the card's busy ms a batch in the port's attention,
RoPE aside: the spans ``attn.qkv``, ``attn.core`` and ``attn.out``
(``models/attention.py``: ``_project_qkv``, ``attention_core``,
``_output``); timed on the regions stretch of ``harness/regions.py``."""

from portbench.harness import regions

NAMES = ("attn.qkv", "attn.core", "attn.out")


def read(run):
    return regions.ms_a_batch(run, NAMES)
