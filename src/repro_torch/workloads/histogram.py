"""Scenario growth beyond the paper: a byte-histogram workload.

The port of ``src/repro/workloads/histogram.py``.

A 256-bin histogram over a 4 KiB pseudo-random byte buffer — the
scatter-add shape (simdjson/DB-filter adjacent) that complements the
matvec-shaped graph kernels and the scan-shaped JSON parse, and another
µs-scale body in the paper's task-size regime. The oracle is
``np.bincount`` on the same bytes.

Like every workload, inherits the skewed power-law cost dimension
(``skew=``/``skew_seed=``) from :class:`repro_torch.workloads.base.Workload`.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.workloads.base import Workload, register_workload, to_numpy

BUF_BYTES = 4096
BINS = 256


def byte_histogram(buf: torch.Tensor) -> torch.Tensor:
    """uint8[..., n] -> int32[..., 256] bin counts: a scatter-add, which
    needs no host read (``torch.bincount`` reads the largest byte back to
    size its output)."""
    idx = buf.to(torch.int64)
    counts = torch.zeros((*buf.shape[:-1], BINS), dtype=torch.int64,
                         device=buf.device)
    return counts.scatter_add_(-1, idx, torch.ones_like(idx)).to(torch.int32)


@functools.lru_cache(maxsize=1)
def _base_buffer() -> np.ndarray:
    rng = np.random.default_rng(23)
    return rng.integers(0, BINS, size=BUF_BYTES).astype(np.uint8)


@register_workload
class ByteHistogramWorkload(Workload):
    name = "histogram"

    def _input(self) -> np.ndarray:
        return _base_buffer()

    def _kernel(self, buf: torch.Tensor) -> torch.Tensor:
        return byte_histogram(buf)

    def check_one(self, result: Any) -> None:
        expected = np.bincount(_base_buffer(), minlength=BINS).astype(np.int32)
        np.testing.assert_array_equal(to_numpy(result), expected)
