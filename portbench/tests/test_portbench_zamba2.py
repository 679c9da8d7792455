"""The published Zamba2's cell, ``zamba2_7b.score_4k``: its work counts and
parameter count pinned at the published shape; a run at the configuration's
``smoke`` size on the CPU that agrees with the float32 reference, and runs
with a fault underneath that do not; and the three readers of its regions
(``ssd_ms.score``, ``mamba_ms.score``, ``shared_ms.score``), which with the
six other ``*_ms.score`` metrics tile a batch's forward and log-likelihood."""

import json
import math
import types

import pytest
import torch

from portbench.harness.spec import PKG, ROOT, Metric, find_cell
from portbench.reference import zamba2 as ref
from portbench.tests.smoke import run_cell, smoke_root
from portbench.work import zamba2_flops
from portbench.work.flash import pairs
from portbench.work.ssd import ssd_work
from repro_torch.runtime import spans

CELL = "zamba2_7b.score_4k"
MODEL = json.loads((PKG / "configs" / "zamba2_7b.json").read_text())["model"]


def test_published_parameter_count():
    shapes = dict(ref.param_shapes(MODEL))
    assert sum(math.prod(s) for s in shapes.values()) == 7_356_749_648
    mamba = sum(math.prod(s) for n, s in shapes.items() if n.startswith("layers.0."))
    block = sum(math.prod(s) for n, s in shapes.items() if n.startswith("shared.0."))
    use = sum(math.prod(s) for n, s in shapes.items() if n.startswith("uses.0."))
    assert (mamba, block, use) == (78_437_456, 333_982_208, 4_128_768 + 12_845_056)


def test_forward_flops_at_the_cells_shape():
    # 22.8 GFLOP a token of products and attention, beside the grouped SSD
    tokens = 4 * 4096
    prods, rest, exps, _ = ssd_work(4, 112, 4096, 64, 64, 256, groups=2)
    assert (prods, rest, exps) == (60_785_950_720, 886_308_864, 239_475_712)
    attn = 4 * 4 * 32 * 224 * pairs(4096, 4096, True)
    weights = (81 * (3584 * 14704 + 7168 * 3584)
               + 13 * (7168 * 3 * 7168 + 7168 * 3584 + 3 * 3584 * 14336
                       + 3584 * 128 + 128 * 28672 + 3584 * 3584)
               + 3584 * 32000)
    want = 2 * tokens * weights + 13 * attn + 81 * (prods + rest + exps)
    assert zamba2_flops.forward_flops(MODEL, 4, 4096) == want == 378_841_388_473_344
    assert (2 * tokens * weights + 13 * attn) / tokens == pytest.approx(22.8e9, rel=0.01)


def test_the_cell_reports_its_metrics():
    cell = find_cell(CELL)
    names = {m.name for m in cell.per_layer}
    assert {"ssd_roofline", "flash_roofline", "mfu.score", "ssd_ms.score",
            "mamba_ms.score", "shared_ms.score", "norm_ms.score"} <= names
    assert {m.name for m in cell.end_to_end} == {
        "score_tokens_per_s", "score_p95_ms", "setup_s"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "zamba2_7b")
    assert entry["reduced"] == [] and cell.config["reduced"] == []


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.manual_seed(0)
    return smoke_root(tmp_path_factory.mktemp("smoke_zamba2"))


def test_run_agrees_with_the_reference(root):
    r = run_cell(root, CELL)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def _alter_one_token(monkeypatch):
    from repro_torch.models import layers

    real = layers.log_likelihood

    def altered(logits, labels):
        ll = real(logits, labels).clone()
        ll[0, ll.shape[1] // 2] += 2.0
        return ll
    monkeypatch.setattr(layers, "log_likelihood", altered)


def _score_half_batch(monkeypatch):
    from repro_torch.models import zamba2

    real = zamba2.zamba2_forward

    def halved(cfg, params, tokens):
        logits, aux = real(cfg, params, tokens[: tokens.shape[0] // 2])
        return logits.repeat(2, 1, 1), aux
    monkeypatch.setattr(zamba2, "zamba2_forward", halved)


@pytest.mark.parametrize("fault", [_alter_one_token, _score_half_batch],
                         ids=["alter_one_token", "score_half_batch"])
def test_a_fault_underneath_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell(root, CELL)
    assert not r["correct"], r["checks"]


# ---- the readers of the Mamba-2 and shared-block regions --------------------

NINE = ("norm_ms.score", "rope_ms.score", "attention_ms.score", "mlp_ms.score",
        "head_ms.score", "other_ms.score", "ssd_ms.score", "mamba_ms.score",
        "shared_ms.score")
# name: (ranges, busy ms) over two forwards of a 3-layer model, one use
TOTALS = {"lm.forward": (2, 2.0), "lm.embed": (2, 1.0), "lm.block": (6, 3.0),
          "norm": (16, 8.0), "attn.qkv": (2, 6.0), "attn.rope": (2, 1.0),
          "attn.core": (2, 4.0), "attn.out": (2, 2.0), "mlp": (4, 10.0),
          "lm.head": (2, 5.0), "lm.log_likelihood": (2, 1.0),
          "mamba.in": (6, 12.0), "mamba.conv": (6, 3.0), "mamba.ssd": (6, 20.0),
          "mamba.gate_norm": (6, 4.0), "mamba.out": (6, 6.0),
          "shared.concat": (2, 0.5), "shared.adapter": (2, 1.5),
          "shared.link": (2, 1.0), spans.NO_SPAN: (0, 0.25)}
WANT = {"ssd_ms.score": 10.0, "mamba_ms.score": 12.5, "shared_ms.score": 1.5}


def _run(totals):
    run = types.SimpleNamespace()
    run._regions = {n: spans.Region(c, b) for n, (c, b) in totals.items()}
    return run


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_ms_a_batch(name):
    assert Metric(name, "ms").reader().read(_run(TOTALS)) == pytest.approx(WANT[name])
    assert Metric(name, "ms").reader().read(_run({})) is None


def test_the_nine_tile_the_forward_and_log_likelihood():
    run = _run(TOTALS)
    got = sum(Metric(n, "ms").reader().read(run) for n in NINE)
    spanned = sum(b for n, (_, b) in TOTALS.items() if n != spans.NO_SPAN)
    assert got == pytest.approx(spanned / 2)
    assert set(spans.NAMES) == set(TOTALS) - {spans.NO_SPAN}
