"""Later changes add cells, configurations and metrics by adding files: in
a copy of the benchmark, a configuration, a cell and a per-layer metric
dropped in as new files (and entries of ``BENCHMARK.json``) are found by
name and read, with no edit to a file the harness already has; so is a
configuration of an architecture the port's pinned registry does not
know, with a config type, init rules and a CPU size of its own."""

import dataclasses
import json
import shutil

import pytest

from portbench.harness import program, weights
from portbench.harness.runner import Run, Window, read_metrics
from portbench.harness.spec import PKG, ROOT, SpecError, find_cell
from portbench.reference import lm
from portbench.tests.smoke import (add_fixture_cells, run_cell, shrink,
                                   smoke_root)
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config

NEW_METRIC = '''"""items_per_s: the window's items over its time."""


def read(run):
    return run.window.items / run.window.seconds
'''


@pytest.fixture()
def copy(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return add_fixture_cells(tmp_path)


def test_a_dropped_in_cell_config_and_metric_are_found(copy):
    pkg = copy / "portbench"
    before = {p.relative_to(copy): p.read_bytes() for p in pkg.rglob("*")
              if p.is_file()}
    cfg = json.loads((pkg / "configs" / "phi3_mini_3p8b.json").read_text())
    cfg["model"]["n_layers"] = 4
    cfg["reduced"] = ["n_layers"]
    (pkg / "configs" / "phi3_four_layers.json").write_text(json.dumps(cfg))
    (pkg / "workloads" / "phi3_four_layers.score_2k.json").write_text(
        json.dumps({"limits": {"ll_gap_max": 0.5, "doc_mean_gap_max": 0.01}}))
    (pkg / "metrics" / "items_per_s.py").write_text(NEW_METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "phi3_four_layers", "source": "x",
                             "file": "portbench/configs/phi3_four_layers.json",
                             "reduced": ["n_layers"], "why": "x"})
    bench["workloads"].append({"name": "phi3_four_layers.score_2k",
                               "config": "phi3_four_layers",
                               "traffic": "score_2k", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("score_"):
            m["workloads"].append("phi3_four_layers.score_2k")
    bench["per_layer"].append({"name": "items_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step",
                               "moves": "score_tokens_per_s"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell("phi3_four_layers.score_2k", root=copy)
    assert cell.model("serve")["n_layers"] == 4
    assert cell.limits["ll_gap_max"] == 0.5
    assert "items_per_s" in {m.name for m in cell.per_layer}
    assert {"score_tokens_per_s", "score_p95_ms", "setup_s"} == {
        m.name for m in cell.end_to_end}
    run = Run(cell, 1, 1.0, True, "cpu", 0.0)
    run.window = Window(0.0, 2.0, 10, 100)
    assert read_metrics(run)["items_per_s"]["value"] == 5.0
    # the metric without a ``workloads`` key reaches every cell that
    # reports the end-to-end metric it moves, and no other
    assert "items_per_s" in {m.name for m in find_cell(
        "zamba2_1p2b.score_4k", root=copy).per_layer}
    assert "items_per_s" not in {m.name for m in find_cell(
        "zamba2_1p2b.train_2k", root=copy).per_layer}
    after = {p.relative_to(copy): p.read_bytes() for p in pkg.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_missing_cell_or_file_is_named(copy):
    with pytest.raises(SpecError, match="no cell"):
        find_cell("nope.score_2k", root=copy)
    (copy / "portbench" / "workloads" / "zamba2_1p2b.score_4k.json").unlink()
    with pytest.raises(SpecError, match="missing"):
        find_cell("zamba2_1p2b.score_4k", root=copy)


def test_every_cell_has_its_files_and_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = find_cell(w["name"])
        assert "setup_s" in {m.name for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(m.reader(), "read"), m.name
        assert set(cell.limits) and cell.kind_module().Traffic
    for c in bench["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]


@dataclasses.dataclass(frozen=True)
class TaggedHybrid(ModelConfig):
    """A configuration type the pinned ``ModelConfig`` lacks: one field
    more, which the port's hybrid ignores and the reference may read."""

    shared_blocks: int = 1


def _files(pkg):
    return {p.relative_to(pkg): p.read_bytes() for p in pkg.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_dropped_in_config_of_an_unlisted_type_runs(tmp_path, monkeypatch):
    root = smoke_root(tmp_path)
    pkg = root / "portbench"
    before = _files(pkg)
    arch, cell = "zamba2_tagged", "zamba2_tagged.score_4k"
    assert arch not in ARCH_IDS
    full = dataclasses.asdict(get_config("zamba2_1p2b"))
    small = dataclasses.asdict(get_config("zamba2_1p2b", smoke=True))
    rules = {"conv_bias": {"normal": 0.1}}
    (pkg / "configs" / f"{arch}.json").write_text(json.dumps({
        "arch": arch, "source": "x", "reduced": [], "why": "x",
        "reference": "lm", "flops": "lm_flops",
        "model": {**full, "type": f"{__name__}:TaggedHybrid",
                  "shared_blocks": 2},
        "smoke": {k: v for k, v in small.items() if full[k] != v},
        "init_rules": rules,
        "serve": {"param_dtype": "bfloat16", "use_kernels": True}}))
    (pkg / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"ll_gap_max": 1.05, "doc_mean_gap_max": 0.007}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": arch, "source": "x",
                             "file": f"portbench/configs/{arch}.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": arch,
                               "traffic": "score_4k", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "zamba2_1p2b.score_4k" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shrink(root)

    built, seen, drawn = [], [], []
    real_config, real_shapes, real_draw = (
        program.model_config, lm.param_shapes, weights.draw)

    def model_config(m):
        built.append(real_config(m))
        return built[-1]

    def param_shapes(m):
        seen.append(m)
        return real_shapes(m)

    def draw(shapes, m, dtype, seed, device, own_rules=None):
        drawn.append(own_rules)
        return real_draw(shapes, m, dtype, seed, device, own_rules)

    monkeypatch.setattr(program, "model_config", model_config)
    monkeypatch.setattr(lm, "param_shapes", param_shapes)
    monkeypatch.setattr(weights, "draw", draw)
    r = run_cell(root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert built and all(type(c) is TaggedHybrid for c in built)
    assert {c.shared_blocks for c in built} == {2}
    assert built[0].d_model == small["d_model"] != full["d_model"]
    assert seen and all(m["shared_blocks"] == 2 for m in seen)
    assert len(drawn) == 2 and drawn == [rules, rules]  # program, reference
    after = _files(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
