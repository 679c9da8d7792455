"""The six readers of the program's regions (``metrics/*_ms.score.py``,
``harness/regions.py``): on a table of regions each gives its spans' busy
ms a batch, over the ``lm.forward`` ranges; each gives nothing where
nothing ran or the program has no spans; the regions are profiled once a
run, on a stretch of their own, so the window and the traced stretch run
with the spans off; a traced run of the phi3 cell at the SMOKE sizes
reports all six, and they tile the forward and its log-likelihood."""

import sys
import types

import pytest

import repro_torch.runtime
from portbench.harness import regions
from portbench.harness.spec import Metric
from portbench.tests.smoke import SCORE, run_cell, smoke_root
from repro_torch.runtime import spans

METRICS = ("norm_ms.score", "rope_ms.score", "attention_ms.score",
           "mlp_ms.score", "head_ms.score", "other_ms.score")

# name: (ranges, busy ms) over two forwards
TOTALS = {"lm.forward": (2, 10.0), "lm.embed": (2, 4.0),
          "lm.block": (64, 8.0), "norm": (130, 40.0),
          "attn.qkv": (64, 30.0), "attn.rope": (64, 36.0),
          "attn.core": (64, 20.0), "attn.out": (64, 14.0),
          "mlp": (64, 230.0), "lm.head": (2, 8.0),
          "lm.log_likelihood": (2, 3.0), spans.NO_SPAN: (0, 0.5)}
WANT = {"norm_ms.score": 20.0, "rope_ms.score": 18.0,
        "attention_ms.score": 32.0, "mlp_ms.score": 115.0,
        "head_ms.score": 5.5, "other_ms.score": 11.0}


def _run(totals):
    """A run whose regions were profiled already."""
    run = types.SimpleNamespace()
    run._regions = {n: spans.Region(c, b) for n, (c, b) in totals.items()}
    return run


@pytest.mark.parametrize("name", METRICS)
def test_reader_gives_ms_a_batch(name):
    got = Metric(name, "ms").reader().read(_run(TOTALS))
    assert got == pytest.approx(WANT[name])


def test_readers_tile_the_forward_and_log_likelihood():
    run = _run(TOTALS)
    got = sum(Metric(n, "ms").reader().read(run) for n in METRICS)
    spanned = sum(b for n, (_, b) in TOTALS.items() if n != spans.NO_SPAN)
    assert got == pytest.approx(spanned / 2)


@pytest.mark.parametrize("name", METRICS)
def test_reader_gives_nothing_without_records(name, monkeypatch):
    reader = Metric(name, "ms").reader()
    assert reader.read(_run({})) is None
    # spans outside a forward (a decode step) give no batch to divide by
    assert reader.read(_run({"norm": (3, 1.0)})) is None
    # a program without spans: nothing is built, nothing is read
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    monkeypatch.delattr(repro_torch.runtime, "spans")
    assert reader.read(types.SimpleNamespace()) is None


def test_regions_are_profiled_once_a_run(monkeypatch):
    made = []
    monkeypatch.setattr(regions, "_profile",
                        lambda run: made.append(run) or _run(TOTALS)._regions)
    run = types.SimpleNamespace()
    for n in METRICS:
        Metric(n, "ms").reader().read(run)
    assert made == [run]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("smoke_spans"))


def _count_recordings(monkeypatch):
    entered = []
    recording = spans.recording

    def counted():
        entered.append(1)
        return recording()
    monkeypatch.setattr(spans, "recording", counted)
    return entered


def test_an_untraced_run_turns_no_span_on(root, monkeypatch):
    entered = _count_recordings(monkeypatch)
    r = run_cell(root, SCORE, seconds=0.05)
    assert r["correct"] and not set(METRICS) & set(r["metrics"])
    assert entered == []


def test_a_traced_run_reports_all_six(root, monkeypatch, capsys):
    entered = _count_recordings(monkeypatch)
    kept, profile = [], spans.profile
    monkeypatch.setattr(spans, "profile", lambda fn, on_card: kept.append(
        profile(fn, on_card)) or kept[-1])
    r = run_cell(root, SCORE, seconds=0.05, trace=True)
    assert r["correct"], r["checks"]
    assert entered == [1] and len(kept) == 1   # the regions stretch alone
    got = {n: r["metrics"][n]["value"] for n in METRICS}
    assert all(v > 0 for v in got.values()) and r["metrics"]["norm_ms.score"][
        "unit"] == "ms"
    t = kept[0]
    assert t["lm.forward"].count == 8    # the mix's trace_batches
    spanned = sum(x.busy_ms for n, x in t.items() if n != spans.NO_SPAN)
    assert sum(got.values()) == pytest.approx(spanned / 8, rel=1e-9)
    assert "the program's regions on a stretch of their own" in \
        capsys.readouterr().err
