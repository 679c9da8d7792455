"""The work of the chunked scalar-decay state-space scan (Mamba-2's SSD),
copied from ``chip_smoke.py::_ssd_work``: per chunk of c steps, C Bᵀ once a
group of heads a batch row (the group's heads share it; one group where
the configuration names none) and, per head, W @ x, C @ stateᵀ and the
state update (the four products), the decay of the c(c+1)/2 kept pairs
(one exponential each) and the rescalings; x, a, each group's b and c
read once and y written once."""

from __future__ import annotations


def chunks(t: int, chunk: int):
    return [min(chunk, t - t0) for t0 in range(0, t, chunk)]


def ssd_work(b: int, h: int, t: int, p: int, n: int, chunk: int,
             x_bytes: int = 4, groups: int = 1):
    """(product operations, other operations, exponentials, bytes) of one
    call: x [b, h, t, p], a [b, h, t] and b/c [b, t, groups, n] in
    float32."""
    prods = rest = exps = 0
    for c in chunks(t, chunk):
        pr = c * (c + 1) // 2
        prods += b * groups * 2 * pr * n + b * h * (2 * pr * p + 4 * c * n * p)
        rest += b * h * (2 * pr + 3 * c * p + 2 * c + 2 * p * n)
        exps += b * h * (pr + 2 * c + 1)
    nbytes = (2 * b * h * t * p * x_bytes + b * h * t * 4
              + 2 * b * t * groups * n * 4)
    return prods, rest, exps, nbytes
