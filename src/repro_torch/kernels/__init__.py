"""Hand-written Hopper kernels of the port, each with a wrapper in ``ops``,
a plain-torch version beside it and an independent oracle in ``ref``:

  relic_matmul       — the paper's pipeline as a tiled matmul (CUDA C++, sm_90a:
                       TMA ring + wgmma for bf16 that TMA can describe,
                       mma.sync for other bf16, FMA tiled by shape for f32)
  relic_matmul_gated — its fused act(x@Wg)*(x@Wu) form (mma.sync / FMA)
  flash_attention    — GQA causal/full streaming attention (CUDA C++, sm_90a:
                       wgmma + TMA for bf16 head_dim 64, 96, 128 or 256,
                       CUDA-core kernel else)
  wkv6               — RWKV-6 chunked WKV recurrence (CUDA C++, sm_90a)
  ssd                — Mamba-2 chunked SSD recurrence (CUDA C++, sm_90a:
                       3xTF32 mma.sync for f32 with P = N = 64, CUDA cores else)
  rope               — RoPE of q and k in one pass (CUDA C++, sm_90a; no
                       Pallas counterpart, XLA fuses the reference's; its
                       plain version is models/layers.py::apply_rope)
  conv               — the Mamba-2 layers' causal conv, bias and SiLU in one
                       pass (CUDA C++, sm_90a; no Pallas counterpart, XLA
                       fuses the reference's; its plain version is
                       models/mamba2.py::_causal_conv)

Every Pallas kernel of the JAX package has its counterpart here.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
