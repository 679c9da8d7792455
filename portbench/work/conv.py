"""The work of the Mamba-2 layers' depthwise causal conv with its bias and
SiLU (``csrc/conv.cu``): per output element K products, K adds (the first
onto zero), the bias add where there is one and SiLU's 4 (negation,
exponential, add, division); x read once and the output written once, the
taps and the bias read once."""

from __future__ import annotations


def conv_work(b: int, s: int, c: int, k: int, elem_bytes: int = 2,
              bias: bool = True):
    """(operations, bytes) of one call over x [b, s, c] with w [k, c] and,
    where ``bias``, a bias [c], all of ``elem_bytes`` an element."""
    n = b * s * c
    ops = n * (2 * k + int(bias) + 4)
    nbytes = (2 * n + k * c + int(bias) * c) * elem_bytes
    return ops, nbytes
