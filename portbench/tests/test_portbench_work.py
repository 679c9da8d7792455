"""The yardstick's arithmetic against hand counts: the flash and SSD work
counts and the closed-form model operations at two shapes each, the
device's busy union and the idle gaps by host span on a synthetic trace,
and the percentile the latency metric takes."""

import re
import types

import pytest

from portbench.harness.trace import Trace, reduce_events
from portbench.work.flash import attention_work, pairs
from portbench.work.lm_flops import forward_flops, train_step_flops
from portbench.work.ssd import chunks, ssd_work


@pytest.mark.parametrize("args,flops,nbytes", [
    # q [1,1,2,4], k/v [1,1,2,4] causal: pairs (0,0) (1,0) (1,1) = 3;
    # 4 * d = 16 operations a pair; q and o 2*8, k and v 2*8 elements, bf16
    ((1, 1, 1, 2, 2, 4, True, 2), 48, 64),
    # q [2,4,3,8] over k/v [2,2,5,8], full: 15 pairs a head and row;
    # 4 * 8 * 15 * 2 * 4 = 3840; q and o 2*192, k and v 2*160, f32
    ((2, 4, 2, 3, 5, 8, False, 4), 3840, 2816),
])
def test_attention_work(args, flops, nbytes):
    assert attention_work(*args) == (flops, nbytes)


def test_causal_pairs_past_the_keys():
    assert pairs(4, 2, True) == 1 + 2 + 2 + 2
    assert pairs(3, 3, False) == 9


def test_ssd_work_one_chunk():
    # b=1, h=1, t=2, p=1, n=1, chunk 2: one chunk of c=2, 3 kept pairs.
    # products: C B^T 2*3*1 = 6; per head 2*3*1 + 4*2*1*1 = 14 -> 20
    # rest: 2*3 + 3*2*1 + 2*2 + 2*1*1 = 18; exps: 3 + 4 + 1 = 8
    # bytes: x and y 2*2*4, a 2*4, b and c 2*2*4 -> 16 + 8 + 16
    assert ssd_work(1, 1, 2, 1, 1, 2) == (20, 18, 8, 40)


def test_ssd_work_ragged_chunks():
    # t=3 in chunks of 2: c=2 (3 pairs) and c=1 (1 pair), b=2, h=3, p=2, n=4
    prods = sum(2 * 2 * pr * 4 + 2 * 3 * (2 * pr * 2 + 4 * c * 4 * 2)
                for c, pr in ((2, 3), (1, 1)))
    rest = sum(2 * 3 * (2 * pr + 3 * c * 2 + 2 * c + 2 * 2 * 4)
               for c, pr in ((2, 3), (1, 1)))
    exps = sum(2 * 3 * (pr + 2 * c + 1) for c, pr in ((2, 3), (1, 1)))
    nbytes = 2 * 2 * 3 * 3 * 2 * 4 + 2 * 3 * 3 * 4 + 2 * 2 * 3 * 4 * 4
    assert ssd_work(2, 3, 3, 2, 4, 2) == (prods, rest, exps, nbytes)


def test_ssd_work_at_the_zamba2_fixtures_shape():
    # b=4, h=64, t=4096, p=64, n=64, chunk 128: one group
    want = (25972178944, 405798912, 69738496, 549453824)
    assert ssd_work(4, 64, 4096, 64, 64, 128) == want
    assert ssd_work(4, 64, 4096, 64, 64, 128, groups=1) == want


@pytest.mark.parametrize("args", [(4, 64, 4096, 64, 64, 128),
                                  (2, 3, 3, 2, 4, 2), (1, 1, 2, 1, 1, 2)])
def test_ssd_work_a_second_group(args):
    # one more C B^T a batch row and one more b and c read; per head nothing
    b, _, t, _, n, chunk = args
    one, two = ssd_work(*args), ssd_work(*args, groups=2)
    kept = sum(c * (c + 1) // 2 for c in chunks(t, chunk))
    assert two[0] - one[0] == b * 2 * kept * n
    assert two[1:3] == one[1:3]
    assert two[3] - one[3] == 2 * b * t * n * 4


DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 0, "d_ff": 16, "vocab_size": 10}


def test_dense_forward_flops():
    # a layer's weights: q 8x8, k 8x4, v 8x4, o 8x8, mlp 3 * 8x16 = 576;
    # the head 8x10; 2 rows of 3 tokens; attention 4 * 2 rows * 2 heads *
    # 4 dims * 6 pairs
    tokens = 6
    per_layer = 2 * tokens * 576 + 4 * 2 * 2 * 4 * 6
    want = 2 * per_layer + 2 * tokens * 80
    assert forward_flops(DENSE, 2, 3) == want
    assert train_step_flops(DENSE, 2, 3) == 3 * want


def test_hybrid_forward_flops():
    m = {**DENSE, "family": "hybrid", "n_layers": 3, "attn_every": 2,
         "ssm": {"expand": 2, "head_dim": 4, "state_dim": 2, "chunk": 2}}
    # d_inner 16, 4 heads, w_in 8 x (32 + 4 + 4), w_out 16 x 8; one shared
    # application (3 // 2)
    tokens = 2
    prods, rest, exps, _ = ssd_work(1, 4, 2, 4, 2, 2)
    mamba = 2 * tokens * (8 * 40 + 16 * 8) + prods + rest + exps
    shared = 2 * tokens * 576 + 4 * 1 * 2 * 4 * 3
    assert forward_flops(m, 1, 2) == 3 * mamba + shared + 2 * tokens * 80


def test_hybrid_forward_flops_by_group():
    # a second group of b and c: w_in 2 * state_dim wider, one more C B^T
    m = {**DENSE, "family": "hybrid", "n_layers": 3, "attn_every": 2,
         "ssm": {"expand": 2, "head_dim": 4, "state_dim": 2, "chunk": 2}}
    grouped = {**m, "ssm": {**m["ssm"], "n_groups": 2}}
    tokens = 2
    extra_cbt = ssd_work(1, 4, 2, 4, 2, 2, groups=2)[0] - ssd_work(
        1, 4, 2, 4, 2, 2)[0]
    per_layer = 2 * tokens * 8 * 2 * 2 + extra_cbt
    assert forward_flops(grouped, 1, 2) - forward_flops(m, 1, 2) == 3 * per_layer


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_roofline_reads_the_groups(groups):
    from portbench.harness.spec import Metric, PKG, load_json

    ssm = {"expand": 2, "head_dim": 64, "state_dim": 64, "chunk": 128}
    if groups > 1:
        ssm["n_groups"] = groups
    mix = {"layout": "serve", "batch": 4, "length": 4096}
    traced = types.SimpleNamespace(kernel_time=lambda _: (3, 0.5),
                                   launches=lambda _: {"ssd_tc_kernel": 3})
    cell = types.SimpleNamespace(traffic=mix, model=lambda _: {
        "d_model": 2048, "ssm": ssm})
    run = types.SimpleNamespace(traced=traced, cell=cell)
    prods, rest, exps, nbytes = ssd_work(4, 64, 4096, 64, 64, 128,
                                         groups=groups)
    peaks = load_json(PKG / "peaks.json")
    bound = max((prods + rest + exps) / peaks["flops_per_s"],
                nbytes / peaks["bytes_per_s"])
    got = Metric("ssd_roofline", "%").reader().read(run)
    assert got == pytest.approx(100.0 * 3 * bound / 0.5)


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_union_and_idle_gaps_by_span():
    events = [_ev("forward", "user_annotation", 0, 60),
              _ev("sync", "user_annotation", 60, 40),
              _ev("other", "user_annotation", 0, 100),      # not a benchmark span
              _ev("k1", "kernel", 10, 20), _ev("k2", "kernel", 20, 20),
              _ev("copy", "gpu_memcpy", 70, 10), _ev("k1", "kernel", 95, 20),
              _ev("cpu op", "cpu_op", 0, 100)]
    t = reduce_events(events, {"forward", "sync"})
    assert (t.t0, t.t1) == (0.0, 100.0)
    # busy: [10, 40] + [70, 80] + [95, 100] (clipped) = 45 us
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.window_s == pytest.approx(100e-6)
    # idle: [0,10] and [40,60] under forward (30 us); [60,70], [80,95] under sync
    assert dict(t.idle_gaps()) == pytest.approx({"forward": 30e-6, "sync": 25e-6})
    assert t.kernel_time(re.compile("^k1$")) == (2, pytest.approx(40e-6))
    assert t.launches(re.compile("k[12]")) == {"k1": 2, "k2": 1}
    assert t.device_ops()[0] == ["k1", pytest.approx(40e-6)]


def test_idle_outside_every_span():
    t = Trace([("k", "kernel", 5.0, 10.0)], [("a", 0.0, 4.0), ("b", 8.0, 20.0)],
              0.0, 20.0)
    assert dict(t.idle_gaps()) == pytest.approx(
        {"a": 4e-6, "(no span)": 1e-6, "b": 10e-6})


@pytest.mark.parametrize("n,want_ms", [(20, 19.0), (303, 288.0)])
def test_p95_is_the_nearest_rank(n, want_ms):
    from portbench.harness.spec import Metric

    reader = Metric("score_p95_ms", "ms").reader()
    run = types.SimpleNamespace(window=types.SimpleNamespace(
        latencies_s=[i / 1000 for i in range(n, 0, -1)]))
    assert reader.read(run) == pytest.approx(want_ms)
