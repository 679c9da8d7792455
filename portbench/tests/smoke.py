"""A copy of the benchmark at the port's SMOKE sizes, for the CPU tests:
the same files and cells, each mix cut to a few short documents, and each
configuration's ``model`` section given the size of the file's own
``smoke`` overlay where it has one (its keys replace the section's, a
nested group such as ``ssm`` whole), else replaced by the port's SMOKE
config of the same architecture.

Beside the benchmark's own cells the copy holds the fixture cells below:
the port's Zamba2 hybrid scored through the SSD and trained through the
Relic-prefetched pipeline, so that the hybrid reference, the train kind
and their metric readers stay tested while no cell of ``BENCHMARK.json``
runs them (the port's hybrid is narrower than the published Zamba2, so
no benchmark cell claims it)."""

from __future__ import annotations

import dataclasses
import json
import shutil
import time
from pathlib import Path

from portbench.harness.runner import Run, execute
from portbench.harness.spec import PKG, ROOT, find_cell

CELLS = ("zamba2_1p2b.score_4k", "phi3_mini_3p8b.score_2k", "zamba2_1p2b.train_2k")
SCORE = "phi3_mini_3p8b.score_2k"

# The fixture: the hybrid's configuration file (its ``model`` section is
# the port's SMOKE config, or its pinned one in ``add_fixture_cells``), two
# cells with their check limits, and the entries of the metrics that only
# they report.
HYBRID = {"arch": "zamba2_1p2b", "source": "https://arxiv.org/abs/2411.15242",
          "reduced": [], "why": "the port's Zamba2 hybrid (test fixture)",
          "reference": "lm", "flops": "lm_flops",
          "serve": {"param_dtype": "bfloat16", "use_kernels": True},
          "train": {}}
FIXTURE_CELLS = {
    "zamba2_1p2b.score_4k": {"ll_gap_max": 1.05, "doc_mean_gap_max": 0.007},
    "zamba2_1p2b.train_2k": {"batches_off": 0, "loss_gap": 0.016,
                             "change_gap": 0.11},
}
TRAIN_METRICS = {
    "end_to_end": [{"name": "train_tokens_per_s", "unit": "tokens/s",
                    "better": "higher", "bound": 0.2, "source": "host_clock",
                    "workloads": ["zamba2_1p2b.train_2k"]}],
    "per_layer": [
        {"name": "train.batch_wait_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "train driver",
         "moves": "train_tokens_per_s", "workloads": ["zamba2_1p2b.train_2k"]},
        {"name": "mfu.train", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "model step",
         "moves": "train_tokens_per_s", "workloads": ["zamba2_1p2b.train_2k"]},
        {"name": "device_idle.train", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "train_tokens_per_s", "workloads": ["zamba2_1p2b.train_2k"]},
        {"name": "ssd_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels",
         "moves": "score_tokens_per_s", "workloads": ["zamba2_1p2b.score_4k"]},
    ],
}
MIXES = {"score_4k": {"batch": 2, "length": 256},
         "score_2k": {"batch": 2, "length": 256},
         "train_2k": {"batch": 4, "length": 32, "ref_rows": 2}}


def _edit(path: Path, fn) -> None:
    doc = json.loads(path.read_text())
    fn(doc)
    path.write_text(json.dumps(doc))


def add_fixture_cells(root: Path) -> Path:
    """Add the fixture's configuration, cells, limits and metric entries to
    the copy of the benchmark at ``root``."""
    from repro_torch.configs import get_config

    pkg = root / "portbench"
    cfg = {**HYBRID, "model": dataclasses.asdict(get_config(HYBRID["arch"]))}
    (pkg / "configs" / "zamba2_1p2b.json").write_text(json.dumps(cfg))
    for cell, limits in FIXTURE_CELLS.items():
        (pkg / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))

    def extend(bench):
        bench["configs"].append({
            "name": HYBRID["arch"], "source": HYBRID["source"],
            "file": "portbench/configs/zamba2_1p2b.json", "reduced": [],
            "why": HYBRID["why"]})
        for cell in FIXTURE_CELLS:
            bench["workloads"].append({"name": cell, "config": HYBRID["arch"],
                                       "traffic": cell.split(".")[1],
                                       "chips": 1, "why": "test fixture"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if SCORE in m.get("workloads", ()):
                m["workloads"].append("zamba2_1p2b.score_4k")
        for key, entries in TRAIN_METRICS.items():
            bench[key] += entries
    _edit(root / "BENCHMARK.json", extend)
    return root


def smoke_model(doc: dict) -> dict:
    """The ``model`` section of configuration ``doc`` at its CPU size."""
    from repro_torch.configs import get_config

    if "smoke" in doc:
        return {**doc["model"], **doc["smoke"]}
    return dataclasses.asdict(get_config(doc["arch"], smoke=True))


def smoke_root(tmp: Path) -> Path:
    shutil.copytree(PKG, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return shrink(add_fixture_cells(tmp))


def shrink(root: Path) -> Path:
    """Cut every configuration and mix of the copy at ``root`` to its CPU
    size; files already cut stay byte for byte as they are."""
    for p in (root / "portbench" / "configs").glob("*.json"):
        _edit(p, lambda d: d.update(model=smoke_model(d)))
    for name, upd in MIXES.items():
        _edit(root / "portbench" / "traffic" / f"{name}.json",
              lambda d: d.update(upd))
    return root


def run_cell(root: Path, cell: str, seed: int = 2**31 + 11,
             seconds: float = 0.3, trace: bool = False) -> dict:
    """One run on the CPU (no card look), its result with the check."""
    run = Run(find_cell(cell, root=root), seed, seconds, trace, "cpu",
              time.perf_counter())
    return execute(run)
