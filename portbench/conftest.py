"""pytest settings of the benchmark's own tests: the marker of tests that
need the card (they decide inside the test whether one is there, and skip
here with the reason)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (os.path.join(ROOT, "src"), ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture(autouse=True)
def _few_threads():
    """The tests run beside other workers: each takes at most 2 threads."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)
