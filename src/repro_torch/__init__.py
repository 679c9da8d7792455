"""repro_torch: the PyTorch/CUDA port of the Relic framework (``src/repro``)
for one NVIDIA H100. Module names follow the JAX package's; see README.md and
ROADMAP.md for what is ported."""

__version__ = "0.1.0"
