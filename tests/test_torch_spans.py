"""The port's spans (``repro_torch.runtime.spans``) on the CPU, at the
SMOKE sizes: off (the default, under another profiler too) a forward
enters no profiler range and creates no CUDA event; on, every region of
the forward is a range in the profiler's trace, once a layer under the
right parent; the spans change no logit; each operation is given to the
innermost span that launched it."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.models import build_model, layers
from repro_torch.runtime import spans

ARCHS = ["phi3_mini_3p8b", "granite_8b", "arctic_480b", "zamba2_1p2b",
         "rwkv6_1p6b", "paligemma_3b"]


def _model(arch):
    cfg = configs.get_config(arch, smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    return cfg, model, params, toks


def _score(model, params, toks):
    with torch.no_grad():
        logits, _ = model.forward(params, toks[:, :-1])
        return logits, layers.log_likelihood(logits, toks[:, 1:])


def _refuse(*a, **k):
    raise AssertionError("entered with the spans off")


def _ranges(prof, tmp_path):
    """The program's ranges in a profile: [(name, start, end)]."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation" and e["name"] in spans.NAMES]


@pytest.mark.parametrize("arch", ARCHS)
def test_off_enters_no_range_and_makes_no_event(arch, monkeypatch):
    _, model, params, toks = _model(arch)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    _score(model, params, toks)
    assert all(spans.span(n) is spans._OFF for n in spans.NAMES)


def test_another_profile_holds_no_span(tmp_path):
    _, model, params, toks = _model("phi3_mini_3p8b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _score(model, params, toks)
    assert _ranges(prof, tmp_path) == []


def _per_forward(cfg):
    n = cfg.n_layers
    return {"lm.forward": 1, "lm.embed": 1, "lm.block": n, "norm": 2 * n + 1,
            "attn.qkv": n, "attn.rope": n, "attn.core": n, "attn.out": n,
            "mlp": n, "lm.head": 1, "lm.log_likelihood": 1}


PARENTS = {"lm.forward": None, "lm.log_likelihood": None,
           "lm.embed": "lm.forward", "lm.block": "lm.forward",
           "lm.head": "lm.forward", "attn.qkv": "lm.block",
           "attn.rope": "lm.block", "attn.core": "lm.block",
           "attn.out": "lm.block", "mlp": "lm.block",
           "norm": ("lm.block", "lm.head")}


def test_profiled_forward_records_every_span(tmp_path, monkeypatch):
    cfg, model, params, toks = _model("phi3_mini_3p8b")
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            _score(model, params, toks)
    assert not spans._on
    ranges = _ranges(prof, tmp_path)
    counts = {}
    for name, s, e in ranges:
        counts[name] = counts.get(name, 0) + 1
        around = [r for r in ranges if r[1] <= s and e <= r[2]
                  and r != (name, s, e)]
        parent = max(around, key=lambda r: r[1])[0] if around else None
        want = PARENTS[name]
        assert parent in (want if isinstance(want, tuple) else (want,)), name
    assert counts == {k: 2 * v for k, v in _per_forward(cfg).items()}
    heads = [r for r in ranges if r[0] == "lm.head"]
    assert sum(name == "norm" and any(h[1] <= s and e <= h[2] for h in heads)
               for name, s, e in ranges) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_records_its_forward_and_blocks(arch):
    cfg, model, params, toks = _model(arch)
    t = spans.profile(lambda: _score(model, params, toks), on_card=False)
    assert t["lm.forward"].count == 1 and t["lm.log_likelihood"].count == 1
    assert t["lm.block"].count >= cfg.n_layers
    assert t["norm"].count >= cfg.n_layers + 1
    assert t["lm.block"].busy_ms > 0 and t["lm.log_likelihood"].busy_ms > 0


@pytest.mark.parametrize("arch", ["phi3_mini_3p8b", "zamba2_1p2b"])
def test_spans_change_no_logit(arch):
    _, model, params, toks = _model(arch)
    off = _score(model, params, toks)
    with spans.recording():
        on = _score(model, params, toks)
    got = []
    spans.profile(lambda: got.append(_score(model, params, toks)), False)
    for other in (on, got[0]):
        for a, b in zip(off, other):
            assert torch.equal(a, b)


def _range(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def test_self_time_is_time_less_the_childrens():
    """Each kernel goes to the innermost span open at its launch, however
    late it runs on the card: a span's time leaves out its children's."""
    ev = [_range("lm.forward", 0, 100), _range("lm.block", 10, 50),
          _range("mlp", 20, 10), _range("lm.head", 60, 30),
          _range("norm", 60, 5)]   # norm starts with its parent
    launches = {1: 5, 2: 15, 3: 20, 4: 25, 5: 60, 6: 70, 7: 95, 8: 200}
    durs = {1: 1000, 2: 2000, 3: 4000, 4: 8000, 5: 16000, 6: 32000,
            7: 64000, 8: 128000}
    for corr, ts in launches.items():
        ev.append(_launch(corr, ts, cat="cuda_driver" if corr == 4
                          else "cuda_runtime"))
        ev.append(_kernel(corr, 1000 + ts, durs[corr],
                          cat="gpu_memcpy" if corr == 6 else "kernel"))
    ev.append(_kernel(9, 5000, 99.0))            # no launch in the trace
    ev.append(_range("forward", 0, 300))          # not a program span
    t = spans.busy(ev, on_card=True)
    want = {"lm.forward": (1, 1 + 64), "lm.block": (1, 2), "mlp": (1, 4 + 8),
            "lm.head": (1, 32), "norm": (1, 16), spans.NO_SPAN: (0, 128)}
    assert {n: (r.count, r.busy_ms) for n, r in t.items()} == want
    assert sum(r.busy_ms for r in t.values()) == sum(durs.values()) / 1e3


def test_busy_keeps_threads_apart():
    ev = [_range("mlp", 0, 100, tid=1), _range("norm", 0, 100, tid=2),
          _launch(1, 50, tid=1), _kernel(1, 60, 3000),
          _launch(2, 50, tid=2), _kernel(2, 70, 5000),
          _launch(3, 150, tid=2), _kernel(3, 80, 7000)]
    t = spans.busy(ev, on_card=True)
    assert {n: r.busy_ms for n, r in t.items()} == {
        "mlp": 3.0, "norm": 5.0, spans.NO_SPAN: 7.0}


def test_on_the_cpu_the_outermost_ops_are_the_work():
    def op(ts, dur, tid=1):
        return {"cat": "cpu_op", "name": "aten::x", "ts": ts, "dur": dur,
                "tid": tid}
    ev = [_range("norm", 0, 100000), op(10, 20000), op(11, 5000),  # nested
          op(30000, 30000), _range("mlp", 200000, 50000), op(210000, 1000),
          op(300000, 9000), _kernel(1, 10, 5000)]   # a kernel: not the CPU's
    t = spans.busy(ev, on_card=False)
    assert {n: (r.count, r.busy_ms) for n, r in t.items()} == {
        "norm": (1, 50.0), "mlp": (1, 1.0), spans.NO_SPAN: (0, 9.0)}


def test_recording_turns_off_after_an_error():
    with pytest.raises(RuntimeError):
        with spans.recording():
            assert spans.span("norm") is not spans._OFF
            raise RuntimeError
    assert spans.span("norm") is spans._OFF
