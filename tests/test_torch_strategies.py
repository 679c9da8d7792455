"""The paper's strategy comparison on the port (``repro_torch.tasks
.strategies``, ``python -m repro_torch.relic_tasks``) held against the JAX
package's ``benchmarks/schedulers.py`` and ``examples/relic_tasks.py`` on
the CPU: the same strategies under one rename, every strategy's results
through the workload's oracle and equal to the reference workload's serial
results, and the example's printed table in the reference's form."""

import functools
import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from benchmarks import run as jrun
from benchmarks import schedulers as jsched
from repro import workloads as jworkloads
from repro_torch import relic_tasks
from repro_torch.tasks import strategies
from repro_torch.workloads import PAPER_WORKLOADS, make_workload

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the port imports no JAX, so its names do not claim to
RENAME = {"cuda_async_stream": "jax_async_stream"}
PORT_NAME = {v: k for k, v in RENAME.items()}
PR_TOL = dict(rtol=1e-4, atol=1e-6)     # tests/test_torch_workloads.py
FLOAT_TOL = {"bc": PR_TOL, "pr": PR_TOL}


@pytest.fixture(autouse=True)
def one_thread():
    """Batched products of the fused row on this torch's CPU thread pool
    take milliseconds each at these sizes; one thread keeps the file fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_strategies_are_the_references_under_one_rename():
    assert [RENAME.get(s, s) for s in strategies.STRATEGIES] == jrun.STRATEGIES
    assert strategies.SUBSTRATE_STRATEGIES == jsched.SUBSTRATE_STRATEGIES
    w = make_workload("tc", device="cpu")
    got = strategies.bench_strategies(*w.tasks, w.fused_task(),
                                      dispatch_a=w.dispatches[0],
                                      dispatch_b=w.dispatches[1],
                                      iters=2, warmup=1, device="cpu")
    want = jsched.bench_strategies(lambda: 0, lambda: 0, lambda: 0,
                                   iters=2, warmup=1)
    assert [RENAME.get(s, s) for s in got] == list(want)
    assert all(t > 0 for t in got.values())


def test_fig4_geomeans_is_the_references_reduction():
    """benchmarks/run.py:117-131: a kernel a strategy slows counts 1.0;
    Relic's gain is over the best framework, serial and fused left out."""
    flat = {s: 100.0 for s in strategies.STRATEGIES}
    results = {"k1": dict(flat, relic_spsc=50.0, locked_queue_spin=80.0,
                          fused_vmap=25.0),
               "k2": dict(flat, relic_spsc=200.0, locked_queue_spin=50.0,
                          fused_vmap=50.0)}
    geo, gain = strategies.fig4_geomeans(results)
    assert tuple(geo) == strategies.STRATEGIES
    assert geo["relic_spsc"] == pytest.approx(2 ** 0.5)
    assert geo["locked_queue_spin"] == pytest.approx(2.5 ** 0.5)
    assert geo["fused_vmap"] == pytest.approx(8 ** 0.5)
    assert geo["serial"] == geo["thread_per_task"] == 1.0
    assert gain == pytest.approx((2 / 2.5) ** 0.5 - 1)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    return [np.asarray(tree)]


@pytest.mark.parametrize("name", PAPER_WORKLOADS)
def test_every_strategy_passes_the_oracle_and_equals_the_reference(name):
    want = jworkloads.make_workload(name).serial()
    w = make_workload(name, device="cpu")
    seen = []
    for strategy, step in strategies.strategy_steps(
            *w.tasks, w.fused_task(), dispatch_a=w.dispatches[0],
            dispatch_b=w.dispatches[1], device="cpu"):
        seen.append(strategy)
        res = step()
        w.check(res)
        assert len(res) == len(want) == 2
        for got_i, want_i in zip(res, want):
            for g, x in zip(_leaves(got_i), _leaves(want_i), strict=True):
                assert g.dtype == x.dtype and g.shape == x.shape, strategy
                if name in FLOAT_TOL:
                    np.testing.assert_allclose(g, x, **FLOAT_TOL[name],
                                               err_msg=strategy)
                else:
                    np.testing.assert_array_equal(g, x, err_msg=strategy)
    assert tuple(seen) == strategies.STRATEGIES


@pytest.mark.parametrize("strategy", strategies.STRATEGIES)
def test_a_failing_task_fails_its_strategy(strategy):
    def fail():
        raise ValueError("task failed")

    def ok():
        return torch.zeros(1)

    for name, step in strategies.strategy_steps(ok, fail, fail, device="cpu"):
        if name == strategy:      # the row's scope is open while it runs
            with pytest.raises(ValueError, match="task failed"):
                step()
            return
    raise AssertionError(f"{strategy} was not yielded")


def _reference_example(monkeypatch, times):
    """``examples/relic_tasks.py``'s ``main``, its strategy times replaced
    by ``times`` ({kernel: {reference strategy: µs}}) and its workloads by
    stand-ins (the printed table's form is what is compared)."""
    spec = importlib.util.spec_from_file_location(
        "reference_relic_tasks", ROOT / "examples" / "relic_tasks.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    order = iter(jworkloads.PAPER_WORKLOADS)

    class Stand:
        tasks = dispatches = (None, None)

        def fused_task(self):
            return None

    monkeypatch.setattr(mod, "make_workload", lambda name: Stand())
    monkeypatch.setattr(mod, "bench_strategies",
                        lambda *a, **k: times[next(order)])
    monkeypatch.setattr(sys, "argv", ["relic_tasks.py", "--iters", "2"])
    return mod.main


def _header(cols):
    return f"{'kernel':<8}" + "".join(f"{c:>22}" for c in cols)


def test_relic_tasks_prints_the_reference_table(monkeypatch, capsys):
    monkeypatch.setattr(relic_tasks, "bench_strategies", functools.partial(
        strategies.bench_strategies, warmup=1))
    res = relic_tasks.main(["--iters", "2", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert tuple(res) == tuple(jworkloads.PAPER_WORKLOADS) == PAPER_WORKLOADS
    assert all(tuple(r) == strategies.STRATEGIES for r in res.values())

    times = {k: {RENAME.get(s, s): t for s, t in r.items()}
             for k, r in res.items()}
    _reference_example(monkeypatch, times)()
    want = capsys.readouterr().out.splitlines()
    n = 1 + len(PAPER_WORKLOADS)
    cols = want[0].split()[1:]
    assert want[0] == _header(cols)
    assert got[0] == _header([PORT_NAME.get(c, c) for c in cols])
    assert got[1:n] == want[1:n]
    assert [line.split()[0] for line in got[1:n]] == list(PAPER_WORKLOADS)
    assert all(len(re.findall(r"us x", line)) == 4 for line in got[1:n])
    assert "CPU" in got[-1]


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_relic_tasks_refuses_cuda_without_a_card(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        relic_tasks.main(["--iters", "2", *argv])
    assert capsys.readouterr().out == ""
