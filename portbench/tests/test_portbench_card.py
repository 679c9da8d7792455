"""On the card, at each cell's own size: the program's numbers lie under
the cell's limits and the control's and each planted fault's put one over
(``calibrate.py``, one seed). Skips where there is no card; the readings
the limits were set from are in each ``workloads/<cell>.json``."""

import json

import pytest

from portbench import calibrate
from portbench.harness.spec import ROOT, find_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_own_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card: python -m pytest -m card portbench")
    c = find_cell(cell)
    fn = calibrate.score_seed if c.kind == "score" else calibrate.train_seed
    rec = fn(c, 2**31 + 2024, True)
    over = {k: [n for n, lim in c.limits.items() if n in v and v[n] > lim]
            for k, v in rec.items() if isinstance(v, dict)}
    assert over.pop("program") == []
    assert over and all(over.values()), over
