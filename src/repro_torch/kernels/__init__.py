"""Hand-written Hopper kernels of the port, each with a wrapper in ``ops``,
a plain-torch version beside it and an independent oracle in ``ref``:

  relic_matmul       — the paper's pipeline as a tiled matmul (CUDA C++, sm_90a)
  relic_matmul_gated — its fused act(x@Wg)*(x@Wu) form (same source)
  flash_attention    — GQA causal/full streaming attention (CUDA C++, sm_90a)
  wkv6               — RWKV-6 chunked WKV recurrence (CUDA C++, sm_90a)
  ssd                — Mamba-2 chunked SSD recurrence (CUDA C++, sm_90a)

Every Pallas kernel of the JAX package has its counterpart here.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
