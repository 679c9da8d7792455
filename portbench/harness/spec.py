"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, each naming
a configuration and a traffic mix. Everything that belongs to one of them
is a file of its own, found by that name, so that a later change adds a
cell, a configuration, a mix or a metric by adding files:

- ``configs/<config>.json``: the configuration as it is run. Three keys
  let it describe an architecture the port's pinned ``ModelConfig`` cannot:
  ``model.type``, ``"<module>:<qualname>"`` of a subclass of
  ``ModelConfig`` (not from the JAX package) that the harness builds the
  program's configuration from (``program.model_config``); a top-level
  ``init_rules``, rules for the kinds of parameter ``init_rules.json``
  lacks, never for one it has (``weights.rules_for``); and a top-level
  ``smoke``, the CPU tests' overlay on the ``model`` section
  (``tests/smoke.py``);
- ``traffic/<traffic>.json``: the mix's parameters and its ``kind``;
- ``kinds/<kind>.py``: the one general driver of that kind of traffic;
- ``workloads/<cell>.json``: the cell's check limits, with the readings
  they were set from;
- ``metrics/<metric>.py``: the reader of one metric;
- ``reference/<name>.py`` and ``work/<name>.py``: the plain reference and
  the closed-form work counts a configuration names.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Optional

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


class SpecError(Exception):
    """A cell, file or entry the run needs is missing or malformed."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import the Python file ``path`` under a name of its own (file names
    may hold dots: ``metrics/mfu.score.py``)."""
    if not path.is_file():
        raise SpecError(f"missing {path}")
    name = f"portbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str

    def reader(self, pkg: Path = PKG) -> ModuleType:
        return load_module(pkg / "metrics" / f"{self.name}.py", "metric")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    pkg: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def kind_module(self) -> ModuleType:
        return importlib.import_module(f"portbench.kinds.{self.kind}")

    def reference(self) -> ModuleType:
        return importlib.import_module(
            f"portbench.reference.{self.config['reference']}")

    def work(self) -> ModuleType:
        """The configuration's closed-form model operations."""
        return importlib.import_module(f"portbench.work.{self.config['flops']}")

    @property
    def init_rules(self) -> dict:
        """The configuration's own init rules (``weights.rules_for``)."""
        return self.config.get("init_rules", {})

    def model(self, layout: str) -> dict:
        """The ``model`` section with the layout's settings laid over it
        (``serve``: the serving layout; ``train``: as configured)."""
        return {**self.config["model"], **self.config.get(layout, {})}


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def find_cell(name: str, root: Path = ROOT, pkg: Optional[Path] = None) -> Cell:
    pkg = pkg or root / "portbench"
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json")
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"]
           if _applies(m, name, set())]
    reported = {m.name for m in e2e}
    per_layer = [Metric(m["name"], m["unit"]) for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(pkg / "configs" / f"{entry['config']}.json"),
        traffic=load_json(pkg / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(pkg / "workloads" / f"{name}.json")["limits"],
        end_to_end=e2e, per_layer=per_layer, pkg=pkg)
