"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command,
``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by ``BENCHMARK.json`` and the data files beside
this package (configurations, traffic mixes, cells' limits, metric
readers). See ``harness/runner.py``."""
