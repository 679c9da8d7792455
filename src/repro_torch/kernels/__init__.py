"""Hand-written Hopper kernels of the port, each with a wrapper in ``ops``,
a plain-torch version beside it and an independent oracle in ``ref``:

  flash_attention — GQA causal/full streaming attention (CUDA C++, sm_90a)

The JAX package's other Pallas kernels are queued in ROADMAP.md.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
