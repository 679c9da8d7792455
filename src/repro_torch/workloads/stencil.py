"""Scenario growth beyond the paper: a 2-D Jacobi stencil sweep workload.

The port of ``src/repro/workloads/stencil.py``; the oracle is copied
unchanged.

Eight 5-point Jacobi relaxation sweeps over a 64×64 float32 grid with
Dirichlet (frozen) boundaries — the classic fine-grained HPC loop nest the
worksharing-task line of work (Maroñas et al., 2020) targets, and µs-scale
on this input, matching the paper's 0.4–6.4 µs task-size regime. The
oracle is a NumPy reimplementation of the same sweep.

Like every workload, inherits the skewed power-law cost dimension
(``skew=``/``skew_seed=``) from :class:`repro_torch.workloads.base.Workload`.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.workloads.base import Workload, register_workload, to_numpy

GRID = 64
SWEEPS = 8


def stencil_sweep(grid: torch.Tensor, sweeps: int = SWEEPS) -> torch.Tensor:
    """``sweeps`` Jacobi iterations over the last two dims; the boundary
    ring stays fixed."""
    interior = torch.zeros(grid.shape[-2:], dtype=torch.bool, device=grid.device)
    interior[1:-1, 1:-1] = True
    g = grid
    for _ in range(sweeps):
        avg = 0.25 * (torch.roll(g, 1, -2) + torch.roll(g, -1, -2) +
                      torch.roll(g, 1, -1) + torch.roll(g, -1, -1))
        g = torch.where(interior, avg, g)
    return g


def _np_stencil(grid: np.ndarray, sweeps: int = SWEEPS) -> np.ndarray:
    g = grid.astype(np.float32).copy()
    for _ in range(sweeps):
        avg = 0.25 * (np.roll(g, 1, 0) + np.roll(g, -1, 0) +
                      np.roll(g, 1, 1) + np.roll(g, -1, 1))
        new = g.copy()
        new[1:-1, 1:-1] = avg[1:-1, 1:-1]
        g = new.astype(np.float32)
    return g


@functools.lru_cache(maxsize=1)
def _base_grid() -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.standard_normal((GRID, GRID)).astype(np.float32)


@register_workload
class StencilWorkload(Workload):
    name = "stencil"

    def _input(self) -> np.ndarray:
        return _base_grid()

    def _kernel(self, grid: torch.Tensor) -> torch.Tensor:
        return stencil_sweep(grid)

    def _stream_stages(self, stages=None):
        """Stencil time-steps as a pipeline: the 8 Jacobi sweeps split into
        ``stages`` sweep-groups (default 4, so 2 sweeps per stage), each a
        stage; the per-instance *grids* flow through. While instance 0 is
        in sweep-group 2, instance 1 is in sweep-group 1 — the dependency
        chain a barriered wavefront cannot overlap. Sweep order is
        preserved per grid (linear pipelines are FIFO), so the final grids
        equal the serial 8-sweep result and the standard oracle applies.
        Ignores ``skew`` (the decomposition replaces the repeat knob)."""
        s = 4 if stages is None else stages
        if s < 1 or SWEEPS % s:
            raise ValueError(
                f"stages must divide SWEEPS={SWEEPS}, got {stages}")
        per = SWEEPS // s

        def sweep_group(grid: torch.Tensor) -> torch.Tensor:
            return self._block(lambda: stencil_sweep(grid, sweeps=per))

        items = [self._copy() for _ in range(self.n_instances)]
        self._block(lambda: stencil_sweep(items[0], sweeps=per))  # warm
        return items, [sweep_group] * s

    def check_one(self, result: Any) -> None:
        np.testing.assert_allclose(to_numpy(result), _np_stencil(_base_grid()),
                                   rtol=1e-5, atol=1e-6)
