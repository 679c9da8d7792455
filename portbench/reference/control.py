"""The control of the benchmark's check: the reference computed one
precision below what the configuration states. Scoring serves bfloat16
weights with bfloat16 products, so its control runs every projection of the
reference in fp8 (e4m3, one scale a tensor, the scale taken from the
tensor's largest magnitude), the step a later change would be tempted to
take. A check that the control passes is too loose to catch that step.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in float32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return fp8(x) @ fp8(w)
