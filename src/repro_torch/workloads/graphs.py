"""The paper's six GAP graph kernels as registered workloads (§IV-A).

The port of ``src/repro/workloads/graphs.py``; the oracles are copied
unchanged. Every workload runs the torch kernels from
:mod:`repro_torch.tasks.graph` on the
paper's input (the 32-node Kronecker graph), one private copy per instance
— the paper generates two identical graphs so the paired tasks never share
buffers. Oracles are independent pure-NumPy/Python reimplementations
(BFS frontier walk, DFS components, Brandes, Bellman-Ford, power
iteration), never the kernel under test. All six inherit the skewed
power-law cost dimension (``skew=``/``skew_seed=``) from
:class:`repro_torch.workloads.base.Workload` — the irregular-cost profile the
RelicPool rebalancing benchmark (``--only skew``) measures against.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.tasks import graph
from repro_torch.workloads.base import Workload, register_workload, to_numpy

SOURCE = 0  # the paper's single-source kernels all start at node 0


@functools.lru_cache(maxsize=1)
def _base_graph():
    """The shared Kronecker input, built once per process: numpy arrays for
    the oracles, copied to each instance's device by the workloads."""
    adj, w = graph.kronecker_graph(device="cpu")
    return adj.numpy(), w.numpy()


# ------------------------------------------------------- NumPy/Python oracles

def _np_bfs(adj: np.ndarray, source: int) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full(n, -1, np.int32)
    dist[source] = 0
    frontier = [source]
    level = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in np.nonzero(adj[u] > 0)[0]:
                if dist[v] < 0:
                    dist[v] = level + 1
                    nxt.append(int(v))
        frontier = nxt
        level += 1
    return dist


def _np_components(adj: np.ndarray) -> np.ndarray:
    """Min-index label per connected component (what min-label propagation
    converges to)."""
    n = adj.shape[0]
    labels = np.full(n, -1, np.int64)
    for s in range(n):
        if labels[s] >= 0:
            continue
        labels[s] = s
        stack = [s]
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u] > 0)[0]:
                if labels[v] < 0:
                    labels[v] = s
                    stack.append(int(v))
    return labels.astype(np.int32)


def _np_pagerank(adj: np.ndarray, iters: int = 20, d: float = 0.85) -> np.ndarray:
    a = adj.astype(np.float32)
    n = a.shape[0]
    deg = np.maximum(a.sum(axis=1), 1.0).astype(np.float32)
    p = np.full(n, 1.0 / n, np.float32)
    for _ in range(iters):
        p = ((1 - d) / n + d * (a.T @ (p / deg))).astype(np.float32)
    return p


def _np_sssp(w: np.ndarray, source: int) -> np.ndarray:
    wf = w.astype(np.float32)
    n = wf.shape[0]
    dist = np.full(n, np.float32(1e9), np.float32)
    dist[source] = 0.0
    for _ in range(n):
        cand = (dist[:, None] + wf).min(axis=0).astype(np.float32)
        new = np.minimum(dist, cand)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def _np_triangles(adj: np.ndarray) -> float:
    a = adj.astype(np.float32)
    return float((a * (a @ a)).sum() / 6.0)


def _np_betweenness(adj: np.ndarray, source: int) -> np.ndarray:
    """Classic level-synchronous single-source Brandes."""
    n = adj.shape[0]
    dist = _np_bfs(adj, source)
    sigma = np.zeros(n, np.float64)
    sigma[source] = 1.0
    max_level = int(dist.max())
    for lev in range(1, max_level + 1):
        for v in np.nonzero(dist == lev)[0]:
            preds = np.nonzero((adj[v] > 0) & (dist == lev - 1))[0]
            sigma[v] = sigma[preds].sum()
    delta = np.zeros(n, np.float64)
    for lev in range(max_level, 0, -1):
        for v in np.nonzero(dist == lev - 1)[0]:
            for s in np.nonzero((adj[v] > 0) & (dist == lev))[0]:
                delta[v] += sigma[v] / sigma[s] * (1.0 + delta[s])
    delta[source] = 0.0
    return delta.astype(np.float32)


# ----------------------------------------------------------------- workloads

class _GraphWorkload(Workload):
    """Common shape: the base class builds per-instance private copies of
    the (dense) input matrix and the vmap-over-stack fused variant; each
    kernel class only picks its matrix and its kernel call."""

    weighted = False  # instance input: weight matrix instead of adjacency

    def _input(self) -> np.ndarray:
        adj, w = _base_graph()
        return w if self.weighted else adj


@register_workload
class BfsWorkload(_GraphWorkload):
    name = "bfs"

    def _kernel(self, adj):
        return graph.bfs(adj, SOURCE)

    def check_one(self, result):
        adj, _ = _base_graph()
        np.testing.assert_array_equal(to_numpy(result), _np_bfs(adj, SOURCE))


@register_workload
class ConnectedComponentsWorkload(_GraphWorkload):
    name = "cc"

    def _kernel(self, adj):
        return graph.connected_components(adj)

    def check_one(self, result):
        adj, _ = _base_graph()
        np.testing.assert_array_equal(to_numpy(result), _np_components(adj))


@register_workload
class PagerankWorkload(_GraphWorkload):
    name = "pr"

    def _kernel(self, adj):
        return graph.pagerank(adj)

    def check_one(self, result):
        adj, _ = _base_graph()
        out = to_numpy(result)
        np.testing.assert_allclose(out, _np_pagerank(adj), rtol=1e-4, atol=1e-6)
        assert abs(float(out.sum()) - 1.0) < 1e-3, "pagerank mass must be ~1"


@register_workload
class SsspWorkload(_GraphWorkload):
    name = "sssp"
    weighted = True

    def _kernel(self, w):
        return graph.sssp(w, SOURCE)

    def check_one(self, result):
        _, w = _base_graph()
        np.testing.assert_allclose(to_numpy(result), _np_sssp(w, SOURCE),
                                   rtol=1e-5)


@register_workload
class TriangleCountWorkload(_GraphWorkload):
    name = "tc"

    def _kernel(self, adj):
        return graph.triangle_count(adj)

    def check_one(self, result):
        adj, _ = _base_graph()
        np.testing.assert_allclose(float(result), _np_triangles(adj), rtol=1e-5)


@register_workload
class BetweennessWorkload(_GraphWorkload):
    name = "bc"

    def _kernel(self, adj):
        return graph.betweenness_centrality(adj, SOURCE)

    def check_one(self, result):
        adj, _ = _base_graph()
        np.testing.assert_allclose(to_numpy(result),
                                   _np_betweenness(adj, SOURCE),
                                   rtol=1e-3, atol=1e-3)
