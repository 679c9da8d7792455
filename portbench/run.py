"""The benchmark's command:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It measures the PyTorch/CUDA port
(``src/repro_torch``) on one cell of ``BENCHMARK.json`` and prints one JSON
result as the last line of standard output (``harness/runner.py``)."""

import time

T_START = time.perf_counter()   # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
