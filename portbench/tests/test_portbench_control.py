"""The check's control and faults at the port's SMOKE sizes on the CPU,
through the same code that reads them on the card at the cells' own sizes
(``calibrate.py``): the program's numbers lie under each cell's limits,
and the control (scoring: the reference in fp8; training: the program's
bf16-weight path) and every planted fault put some number over its
limit."""

import pytest

from portbench import calibrate
from portbench.harness.spec import find_cell
from portbench.tests.smoke import CELLS, smoke_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("smoke"))


def _over(numbers: dict, limits: dict) -> list:
    return [n for n, lim in limits.items() if n in numbers and numbers[n] > lim]


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(root, cell):
    c = find_cell(cell, root=root)
    fn = calibrate.score_seed if c.kind == "score" else calibrate.train_seed
    rec = fn(c, 2**31 + 101, True, device="cpu")
    assert not _over(rec.pop("program"), c.limits)
    for key in ("seed", "reference_s"):
        rec.pop(key, None)
    assert rec and set(rec) >= {"control", "half_batch"}
    for name, numbers in rec.items():
        assert _over(numbers, c.limits), (name, numbers)
