"""The work of causal (or full) softmax attention, as the flash kernel's
bound counts it (copied from ``chip_smoke.py::attention_bound_ms``): the
two products over the (query, key) pairs the mask keeps, 4 * d operations
a pair and head, and q, k, v read once and o written once."""

from __future__ import annotations


def pairs(sq: int, sk: int, causal: bool) -> int:
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def attention_work(b: int, h: int, kv: int, sq: int, sk: int, d: int,
                   causal: bool, elem_bytes: int):
    """(operations, bytes) of one call: q [b, h, sq, d], k/v [b, kv, sk, d]."""
    flops = 4 * b * h * d * pairs(sq, sk, causal)
    nbytes = (2 * b * h * sq * d + 2 * b * kv * sk * d) * elem_bytes
    return flops, nbytes
