"""The paper's fine-grained graph kernels (§IV-A), in PyTorch.

The port of ``src/repro/tasks/graph.py``. GAP-style kernels on the paper's
input: a generated Kronecker graph with 32 nodes and ~157 undirected edges.
At n=32 a dense adjacency matrix is the right representation: every kernel
is a handful of matvecs or matmuls, microsecond-granularity work in the
paper's 0.4-6.4 µs task-size regime.

The reference runs ``jax.lax.while_loop`` to a fixpoint. Reading a
convergence flag on the host every iteration would add a device-to-host
wait per iteration to a task of a few µs, so the port runs the trip counts
the reference already bounds its loops by (``max_iter`` levels, ``n``
rounds) with updates that are idempotent at the fixpoint: once converged,
an iteration changes nothing, so the results are the reference's and a
task issues all its work without waiting until its caller does.

Every kernel takes its graph with any leading batch dimensions
(``adj [..., n, n]``), so the stacked instances of a workload run as one
batched call (the counterpart of the reference's ``jit(vmap)``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tasks.streams import run_blocking

INF = 1e9   # float32-exact; the reference's jnp.float32(1e9)


def kronecker_graph(scale: int = 5, edge_factor: int = 16, seed: int = 10,
                    *, device="cuda"):
    # defaults reproduce the paper's input: 32 nodes, 157 undirected edges
    """Graph500-style Kronecker generator (A,B,C = .57,.19,.19), dedup'd,
    no self-loops, drawn with numpy exactly as the reference draws it.
    Returns (dense adjacency f32 [n,n], edge weights [n,n]) on ``device``."""
    n = 2 ** scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    a, b, c = 0.57, 0.19, 0.19
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > a + b
        dst_bit = (r1 > a + b) & (r2 > c / (c + 0.05)) | \
                  (r1 <= a + b) & (r2 > a / (a + b))
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    mask = src != dst
    src, dst = src[mask], dst[mask]
    adj = np.zeros((n, n), np.float32)
    adj[src, dst] = 1.0
    adj[dst, src] = 1.0
    wrng = np.random.default_rng(seed + 1)
    w = wrng.integers(1, 8, size=(n, n)).astype(np.float32)
    w = np.where(adj > 0, np.maximum(w, w.T), np.float32(1e9))
    np.fill_diagonal(w, 0.0)
    return (torch.as_tensor(adj, device=device),
            torch.as_tensor(w.astype(np.float32), device=device))


def n_edges(adj: torch.Tensor) -> int:
    return int(adj.sum().item() / 2)


# ---------------------------------------------------------------------------
# Kernels. Each is (adj[, w], args) -> tensor on adj's device.
# ---------------------------------------------------------------------------

def _t_matvec(adj, x):
    """adj^T @ x over the last two dims of adj and the last of x."""
    return (x.unsqueeze(-2) @ adj).squeeze(-2)


def _matvec(adj, x):
    """adj @ x over the last two dims of adj and the last of x."""
    return (adj @ x.unsqueeze(-1)).squeeze(-1)


def _at_source(x, source: int, value):
    """A copy of ``x`` with position ``source`` of its last dim set to
    ``value``."""
    x = x.clone()
    x[..., source] = value
    return x


def bfs(adj: torch.Tensor, source: int = 0, max_iter: int = 32) -> torch.Tensor:
    """Level array (distance in hops; -1 unreachable)."""
    n = adj.shape[-1]
    lead = adj.shape[:-2]
    dist = _at_source(torch.full((*lead, n), -1, dtype=torch.int32,
                                 device=adj.device), source, 0)
    frontier = _at_source(torch.zeros((*lead, n), dtype=adj.dtype,
                                      device=adj.device), source, 1.0)
    for level in range(max_iter):   # an empty frontier changes nothing
        nxt = (_t_matvec(adj, frontier) > 0) & (dist < 0)
        dist = torch.where(nxt, level + 1, dist)
        frontier = nxt.to(adj.dtype)
    return dist


def connected_components(adj: torch.Tensor) -> torch.Tensor:
    """Min-label propagation to fixpoint (Shiloach-Vishkin-style): n rounds,
    since after r rounds each label is the least within r hops."""
    n = adj.shape[-1]
    big = float(n + 1)
    labels = torch.arange(n, dtype=torch.float32, device=adj.device)
    labels = labels.expand(*adj.shape[:-1]).contiguous()
    conn = (adj + torch.eye(n, dtype=adj.dtype, device=adj.device)) > 0
    for _ in range(n):
        # min over neighbors (masked min-plus with 0/1 adjacency)
        cand = torch.where(conn, labels.unsqueeze(-2), big).amin(dim=-1)
        labels = torch.minimum(labels, cand)
    return labels.to(torch.int32)


def pagerank(adj: torch.Tensor, iters: int = 20, d: float = 0.85) -> torch.Tensor:
    n = adj.shape[-1]
    deg = torch.clamp(adj.sum(dim=-1), min=1.0)
    p = torch.full(adj.shape[:-1], 1.0 / n, dtype=torch.float32,
                   device=adj.device)
    for _ in range(iters):
        spread = _t_matvec(adj, p / deg)
        p = (1 - d) / n + d * spread
    return p


def sssp(w: torch.Tensor, source: int = 0, max_iter: int = 32) -> torch.Tensor:
    """Bellman-Ford min-plus relaxation to fixpoint: max_iter + 1 rounds, the
    most the reference's loop runs."""
    dist = _at_source(torch.full(w.shape[:-1], INF, dtype=torch.float32,
                                 device=w.device), source, 0.0)
    for _ in range(max_iter + 1):
        cand = (dist.unsqueeze(-1) + w).amin(dim=-2)
        dist = torch.minimum(dist, cand)
    return dist


def triangle_count(adj: torch.Tensor) -> torch.Tensor:
    """#triangles = trace(A^3) / 6 — computed as sum(A * A@A) / 6."""
    return torch.sum(adj * (adj @ adj), dim=(-2, -1)) / 6.0


def betweenness_centrality(adj: torch.Tensor, source: int = 0,
                           max_iter: int = 32) -> torch.Tensor:
    """Single-source Brandes: forward BFS with path counts, backward
    dependency accumulation (dense matvecs per level). The backward sweep
    walks levels max_iter .. 1; the reference walks from one past the
    deepest level, and a level that holds no node adds exact zeros."""
    n = adj.shape[-1]
    lead = adj.shape[:-2]
    zeros = torch.zeros((*lead, n), dtype=torch.float32, device=adj.device)
    dist = _at_source(torch.full((*lead, n), -1, dtype=torch.int32,
                                 device=adj.device), source, 0)
    sigma = _at_source(zeros, source, 1.0)
    frontier = _at_source(zeros, source, 1.0)
    for level in range(max_iter):
        contrib = _t_matvec(adj, sigma * frontier)
        nxt = (_t_matvec(adj, frontier) > 0) & (dist < 0)
        sigma = torch.where(nxt, contrib, sigma)
        dist = torch.where(nxt, level + 1, dist)
        frontier = nxt.to(torch.float32)

    delta = zeros
    for level in range(max_iter, 0, -1):   # descend levels
        on_next = (dist == level).to(torch.float32)
        coeff = torch.where(sigma > 0, (1.0 + delta) / torch.clamp(sigma, min=1e-9),
                            0.0) * on_next
        contrib = _matvec(adj, coeff) * sigma
        on_this = (dist == level - 1).to(torch.float32)
        delta = delta + contrib * on_this
    return _at_source(delta, source, 0.0)


# ---------------------------------------------------------------------------
# Dependency-aware wavefront execution: GAP kernels over the tasking façade.
# ---------------------------------------------------------------------------

def run_wavefronts(tasks, scheduler):
    """Legacy dict-of-tuples front door for wavefront execution.

    ``tasks`` maps name -> ``(fn, deps)``; ``fn`` receives its
    dependencies' results positionally (in ``deps`` order). This shim
    validates the dict (``ValueError`` on unknown dependencies or cycles),
    topo-sorts it into a :class:`repro_torch.tasks.api.TaskGraph`, and
    executes it over ``scheduler`` through a borrowed
    :class:`repro_torch.tasks.api.TaskScope`. The scheduler must already be
    started; it is left running (callers own its lifecycle). Returns
    ``{name: result}``.
    """
    from repro_torch.tasks.api import TaskGraph, TaskScope

    for name, (_, deps) in tasks.items():
        for d in deps:
            if d not in tasks:
                raise ValueError(f"task {name!r} depends on unknown {d!r}")

    g = TaskGraph()
    pending = dict(tasks)
    while pending:
        ready = [n for n, (_, deps) in pending.items()
                 if all(d in g for d in deps)]
        if not ready:
            raise ValueError(f"dependency cycle among {sorted(pending)}")
        for n in ready:
            fn, deps = pending.pop(n)
            g.task(n, fn, deps=tuple(deps))

    from repro_torch.core.schedulers import SchedulerUsageError
    if not getattr(scheduler, "_started", True):
        raise SchedulerUsageError(
            "run_wavefronts() requires a started scheduler "
            "(callers own its lifecycle)")
    scope = TaskScope(scheduler)  # started instance => borrowed, not closed
    try:
        return g.run(scope)
    finally:
        scope.close()


def gap_task_graph(adj: torch.Tensor, w: torch.Tensor, source: int = 0):
    """The paper's GAP kernel suite as a :class:`repro_torch.tasks.api.TaskGraph`.

    Wave 1 runs the five independent kernels; wave 2 runs betweenness
    centrality (gated on ``bfs`` so the graph exercises dependencies) and a
    ``summary`` reduction over every kernel's output. Each task waits for
    its own work on the card (``streams.run_blocking``), so the scheduler
    measures completion, not dispatch. Run it with
    ``gap_task_graph(adj, w).run(scope_or_substrate)``.
    """
    from repro_torch.tasks.api import TaskGraph

    def done(fn, *args):
        return run_blocking(lambda: fn(*args), adj.device)

    def host(x):
        return x.cpu().numpy()

    g = TaskGraph()
    g.task("bfs", lambda: done(bfs, adj, source))
    g.task("cc", lambda: done(connected_components, adj))
    g.task("pagerank", lambda: done(pagerank, adj))
    g.task("sssp", lambda: done(sssp, w, source))
    g.task("tc", lambda: done(triangle_count, adj))
    g.task("bc", lambda _bfs: done(betweenness_centrality, adj, source),
           deps=("bfs",))
    g.task(
        "summary",
        lambda b, c, pr, d, t, bc_: {
            "reached": int((host(b) >= 0).sum()),
            "components": int(len(np.unique(host(c)))),
            "pr_mass": float(host(pr).sum()),
            "finite_paths": int((host(d) < 1e8).sum()),
            "triangles": float(t),
            "max_bc": float(host(bc_).max()),
        },
        deps=("bfs", "cc", "pagerank", "sssp", "tc", "bc"),
    )
    return g
