"""The paper's workloads on the port (``repro_torch.workloads``,
``repro_torch.tasks.graph``, ``repro_torch.tasks.jsonparse``) on the CPU:
every workload, every execution variant and every substrate against its
independent oracle (tests/test_workloads.py on the port), and every kernel
against the JAX package's on the same seeded inputs — exactly for the
integer outputs and for sssp, at the oracle's tolerance for pagerank, bc
and the stencil (``workloads/graphs.py:172``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.tasks import graph as jgraph
from repro.tasks import jsonparse as jjson
from repro.workloads import histogram as jhist
from repro.workloads import stencil as jstencil
from repro_torch.core.schedulers import available_schedulers, make_scheduler
from repro_torch.tasks import graph, jsonparse
from repro_torch.tasks.api import TaskScope
from repro_torch.workloads import (PAPER_WORKLOADS, VARIANTS,
                                   WorkloadOracleError, available_workloads,
                                   make_workload, results_agree,
                                   split_instances)
from repro_torch.workloads import histogram, stencil

ALL = available_workloads()
SUBSTRATES = available_schedulers()
_CACHE = {}
PR_TOL = dict(rtol=1e-4, atol=1e-6)   # workloads/graphs.py:172


def workload(name, n_instances=None, **kw):
    key = (name, n_instances, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = make_workload(name, n_instances=n_instances,
                                    device="cpu", **kw)
    return _CACHE[key]


def test_registry_covers_paper_and_growth():
    assert set(PAPER_WORKLOADS) <= set(ALL)
    assert {"stencil", "histogram"} <= set(ALL)
    assert len(ALL) == 9
    assert VARIANTS == ("serial", "paired", "chunked")
    with pytest.raises(ValueError, match="unknown workload"):
        make_workload("no-such-workload", device="cpu")


def test_make_workload_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_workload("bfs")


# ---------------------------------------------------- variant oracle coverage

@pytest.mark.parametrize("sub", SUBSTRATES)
@pytest.mark.parametrize("name", ALL)
def test_variants_pass_oracle_on_every_substrate(name, sub):
    """serial, paired and chunked on each substrate: each passes the oracle
    and equals serial."""
    w = workload(name)
    serial = w.serial()
    w.check(serial)
    with TaskScope(sub) as scope:
        paired = w.paired(scope)
        chunked = w.chunked(scope, grain=1)
    for got in (paired, chunked):
        w.check(got)
        assert all(results_agree(s, g) for s, g in zip(serial, got))


@pytest.mark.parametrize("name", ALL)
def test_fused_variant_is_one_batched_call_that_passes_oracle(name):
    w = workload(name)
    out = w.fused_task()()
    results = split_instances(out, w.n_instances)
    w.check(results)
    assert all(results_agree(s, f, **PR_TOL) for s, f in zip(w.serial(), results))


@pytest.mark.parametrize("sub", SUBSTRATES)
def test_all_variants_agree_on_every_substrate(sub):
    w = workload("histogram", n_instances=4)
    serial = w.serial()
    with TaskScope(sub) as scope:
        paired = w.paired(scope)
        chunked_fine = w.chunked(scope, grain=1)
        chunked_coarse = w.chunked(scope, grain=2)
    for got in (paired, chunked_fine, chunked_coarse):
        w.check(got)
        assert all(results_agree(s, g) for s, g in zip(serial, got))


def test_more_than_two_instances_chunked():
    w = workload("stencil", n_instances=4)
    with TaskScope("relic") as scope:
        for grain in (1, 2, 4):
            w.check(w.chunked(scope, grain=grain))
        w.check(w.paired(scope))


def test_min_instances_enforced():
    with pytest.raises(ValueError, match=">= 2 instances"):
        make_workload("histogram", n_instances=1, device="cpu")


def test_oracle_actually_rejects():
    w = workload("histogram")
    good = w.serial()
    with pytest.raises(WorkloadOracleError):
        w.check(good[:1])                      # wrong instance count
    bad = [r.numpy().copy() for r in good]
    bad[1][0] += 1                             # instances disagree
    with pytest.raises(WorkloadOracleError):
        w.check(bad)
    corrupt = [r.numpy().copy() + 1 for r in good]   # oracle mismatch
    with pytest.raises(WorkloadOracleError):
        w.check(corrupt)


def test_json_oracle_counts_crosscheck():
    w = workload("json")
    structural, depth, ok = w.serial()[0]
    expected = jsonparse.oracle_counts(jsonparse.WIDGET_JSON)
    assert bool(ok)
    assert int(structural.sum()) == expected["structural"]
    assert int(depth.max()) == expected["max_depth"]
    w.check_one((structural, depth, ok))


def test_task_closures_return_finished_tensors():
    w = workload("bc")
    for task, dispatch in zip(w.tasks, w.dispatches):
        out = task()
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert torch.equal(out, dispatch())


# -------------------------------------------------------------------- skew

def test_skew_repeats_follow_a_seeded_power_law():
    w = workload("histogram", n_instances=8, skew=1.0, skew_seed=0)
    assert sorted(w.repeats, reverse=True) == [8, 4, 3, 2, 2, 1, 1, 1]
    again = make_workload("histogram", n_instances=8, skew=1.0, skew_seed=0,
                          device="cpu")
    assert again.repeats == w.repeats
    other = make_workload("histogram", n_instances=8, skew=1.0, skew_seed=7,
                          device="cpu")
    assert sorted(other.repeats) == sorted(w.repeats)
    assert other.repeats != w.repeats
    with pytest.raises(ValueError, match="positive exponent"):
        make_workload("histogram", n_instances=8, skew=0.0, device="cpu")


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("name", ALL)
def test_skewed_chunked_passes_oracle_at_every_lane_count(name, lanes):
    w = workload(name, n_instances=4, skew=1.0, skew_seed=0)
    assert max(w.repeats) == 4 and min(w.repeats) == 1
    serial = w.serial()
    w.check(serial)
    with TaskScope(make_scheduler("relic-pool", lanes=lanes)) as scope:
        chunked = w.chunked(scope, grain=1)
    w.check(chunked)
    assert all(results_agree(s, c) for s, c in zip(serial, chunked))


def test_skewed_chunked_static_striping_matches_rebalanced():
    w = workload("stencil", n_instances=4, skew=1.0, skew_seed=0)
    serial = w.serial()
    with TaskScope(make_scheduler("relic-pool", lanes=2,
                                  rebalance=False)) as scope:
        chunked = w.chunked(scope, grain=1)
    w.check(chunked)
    assert all(results_agree(s, c) for s, c in zip(serial, chunked))


# ----------------------------------------------------------------- streamed

@pytest.mark.parametrize("name", ["stencil", "json", "bfs"])
@pytest.mark.parametrize("substrate", ["serial", "relic", "chaos"])
def test_streamed_workloads_pass_oracles(name, substrate):
    w = workload(name)
    w.check(w.streamed(substrate))


def test_streamed_matches_serial_variant():
    w = workload("stencil")
    for a, b in zip(w.streamed("relic"), w.serial()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------- the kernels against the JAX ones

def _random_graph(seed, n=24):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.15).astype(np.float32)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0)
    w = rng.integers(1, 8, (n, n)).astype(np.float32)
    w = np.where(a > 0, np.maximum(w, w.T), np.float32(1e9))
    np.fill_diagonal(w, 0)
    return a, w.astype(np.float32)


def _graphs():
    adj, w = graph.kronecker_graph(device="cpu")
    return {"paper": (adj.numpy(), w.numpy()),
            "random3": _random_graph(3), "random11": _random_graph(11)}


GRAPH_KERNELS = [("bfs", "adj", (0,), None), ("connected_components", "adj", (), None),
                 ("pagerank", "adj", (), PR_TOL), ("sssp", "w", (0,), None),
                 ("triangle_count", "adj", (), None),
                 ("betweenness_centrality", "adj", (0,), PR_TOL)]


def test_kronecker_graph_is_the_reference_input():
    adj, w = graph.kronecker_graph(device="cpu")
    jadj, jw = jgraph.kronecker_graph()
    assert adj.dtype == w.dtype == torch.float32
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert graph.n_edges(adj) == jgraph.n_edges(jadj) == 157


@pytest.mark.parametrize("which", ["paper", "random3", "random11"])
@pytest.mark.parametrize("name,arg,extra,tol", GRAPH_KERNELS)
def test_graph_kernel_matches_jax(name, arg, extra, tol, which):
    adj, w = _graphs()[which]
    x = adj if arg == "adj" else w
    want = np.asarray(getattr(jgraph, name)(jnp.asarray(x), *extra))
    got = getattr(graph, name)(torch.from_numpy(x), *extra).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name,arg,extra,tol", GRAPH_KERNELS)
def test_batched_graph_kernel_equals_each_instance(name, arg, extra, tol):
    graphs = _graphs()
    xs = [g[0] if arg == "adj" else g[1] for k, g in graphs.items() if k != "paper"]
    fn = getattr(graph, name)
    stacked = fn(torch.from_numpy(np.stack(xs)), *extra)
    for i, x in enumerate(xs):
        # a batched product may sum in another order than a single one
        got, want = stacked[i].numpy(), fn(torch.from_numpy(x), *extra).numpy()
        if tol is None:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **tol)


@given(st.integers(0, 2**31 - 1))
@settings(deadline=None, max_examples=20)
def test_bfs_property_random_graphs_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 24))
    a = (rng.random((n, n)) < 0.2).astype(np.float32)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0)
    got = graph.bfs(torch.from_numpy(a), 0, max_iter=n + 1).numpy()
    want = np.asarray(jgraph.bfs(jnp.asarray(a), 0, max_iter=n + 1))
    np.testing.assert_array_equal(got, want)


def test_histogram_matches_jax():
    buf = histogram._base_buffer()
    got = histogram.byte_histogram(torch.from_numpy(buf)).numpy()
    want = np.asarray(jhist.byte_histogram(jnp.asarray(buf)))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_stencil_matches_jax():
    grid = stencil._base_grid()
    got = stencil.stencil_sweep(torch.from_numpy(grid)).numpy()
    want = np.asarray(jstencil.stencil_sweep(jnp.asarray(grid)))
    np.testing.assert_allclose(got, want, **PR_TOL)


JSON_DOCS = [
    jsonparse.WIDGET_JSON,
    jsonparse.WIDGET_JSON[:-1],                                   # unbalanced
    json.dumps({"a": 'he said "hi\\" {not a brace}', "b": [1, 2]}),
    json.dumps({"a": "x\\\\\"y\\\\", "b": ["\\\\\\\"q", {"c": "\\\\"}]}),
    '"\\\\\\\\', '{]', 'x\\\\"',
]


@pytest.mark.parametrize("doc", JSON_DOCS)
def test_json_parse_matches_jax(doc):
    got = jsonparse.parse_structural(jsonparse.to_bytes(doc, device="cpu"))
    want = jjson.parse_structural(jjson.to_bytes(doc))
    for g, w_ in zip(got, want):
        assert g.numpy().dtype == np.asarray(w_).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@st.composite
def json_values(draw, depth=0):
    if depth > 2:
        return draw(st.integers(-5, 5))
    return draw(st.one_of(
        st.integers(-100, 100),
        st.booleans(),
        st.text(alphabet=st.characters(codec="ascii",
                                       exclude_characters="\x00"),
                max_size=12),
        st.lists(json_values(depth=depth + 1), max_size=4),
        st.dictionaries(st.text(alphabet="abcdef", min_size=1, max_size=4),
                        json_values(depth=depth + 1), max_size=4),
    ))


@given(json_values())
@settings(deadline=None, max_examples=40)
def test_json_property_matches_jax_and_oracle(value):
    doc = json.dumps(value)
    s, depth, ok = jsonparse.parse_structural(jsonparse.to_bytes(doc, device="cpu"))
    js, jdepth, jok = jjson.parse_structural(jjson.to_bytes(doc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(jdepth))
    want = jsonparse.oracle_counts(doc)
    assert bool(ok) and bool(jok)
    assert int(s.sum()) == want["structural"]


# ----------------------------------------------------- the GAP task graph

@pytest.mark.parametrize("sub", ["serial", "relic", "relic-pool"])
def test_gap_task_graph_summary_matches_jax(sub):
    adj, w = graph.kronecker_graph(device="cpu")
    got = graph.gap_task_graph(adj, w).run(sub)["summary"]
    jadj, jw = jgraph.kronecker_graph()
    want = jgraph.gap_task_graph(jadj, jw).run("serial")["summary"]
    assert set(got) == set(want)
    for k in ("reached", "components", "finite_paths", "triangles"):
        assert got[k] == want[k], k
    for k in ("pr_mass", "max_bc"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_run_wavefronts_orders_and_validates():
    sched = make_scheduler("relic")
    sched.start()
    try:
        out = graph.run_wavefronts({"a": (lambda: 2, ()),
                                    "b": (lambda a: a * 3, ("a",)),
                                    "c": (lambda a, b: a + b, ("a", "b"))}, sched)
        assert out == {"a": 2, "b": 6, "c": 8}
        with pytest.raises(ValueError, match="cycle"):
            graph.run_wavefronts({"a": (lambda b: b, ("b",)),
                                  "b": (lambda a: a, ("a",))}, sched)
        with pytest.raises(ValueError, match="unknown"):
            graph.run_wavefronts({"a": (lambda x: x, ("ghost",))}, sched)
    finally:
        sched.close()
