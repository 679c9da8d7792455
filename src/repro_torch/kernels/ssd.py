"""Mamba-2 SSD chunked recurrence as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd.py`` (``_ssd_kernel``
/ ``ssd_bhtp``). Layout: x [B, H, T, P], a (log decay, <= 0) [B, H, T], b/c
[B, T, N] shared across heads (``ops.py`` transposes x and a from the
model's [B, T, H, ...]).

On the H100 this function is bound by operations at the model's shapes: at
B=8, H=64, T=256, P=N=64 in f32 it needs about 4 GFLOP against 69 MB of
input and output. The kernel in ``csrc/ssd.cu`` keeps the TPU kernel's
chunked form: the [P, N] state lives on chip for the whole sequence (in
shared memory, one CTA per (b, h), the chunk axis a loop inside the CTA),
and the decay ``exp(la_t - la_s)`` is taken only for s <= t, where its
exponent is <= 0 (the TPU kernel exponentiates the whole [C, C] difference
and hides the overflow with a select). Its math is f32 on the CUDA cores;
moving the products to wgmma is later work. A ragged last chunk is masked
in the kernel, so every T launches.

``ssd_bhtp`` launches the kernel for a CUDA tensor and takes the plain
version, ``ssd_plain`` (the oracle ``ref.ssd_ref``), for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref as ssd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # kernel launches since the caller last set this to 0


def _check(x, a, b, c):
    if x.dim() != 4:
        raise ValueError(f"x{tuple(x.shape)} is not [B, H, T, P]")
    bb, h, t, p = x.shape
    if tuple(a.shape) != (bb, h, t):
        raise ValueError(f"a{tuple(a.shape)} is not [{bb}, {h}, {t}]")
    if b.dim() != 3 or b.shape != c.shape or tuple(b.shape[:2]) != (bb, t):
        raise ValueError(f"b{tuple(b.shape)} / c{tuple(c.shape)} are not "
                         f"[{bb}, {t}, N]")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd takes x in float32 or bfloat16, got {x.dtype}")
    if p % 4 or b.shape[2] % 4:
        raise ValueError(f"head size {p} and state size {b.shape[2]} must be "
                         f"multiples of 4")
    if min(bb, h, t) == 0:
        raise ValueError("empty ssd input")


def ssd_cuda(x, a, b, c, *, chunk: int = 128):
    """Launch the CUDA kernel; all tensors on the card."""
    global launches
    if not all(t.is_cuda for t in (x, a, b, c)):
        raise ValueError("ssd_cuda takes CUDA tensors")
    _check(x, a, b, c)
    if chunk <= 0:
        raise ValueError(f"chunk {chunk} must be positive")
    x = x.contiguous()
    a, b, c = (t.float().contiguous() for t in (a, b, c))
    bb, h, t, p = x.shape
    out = torch.empty_like(x)
    fn = _build.load("ssd").ssd_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 out.data_ptr(), _DTYPES[x.dtype], bb, h, t, p, b.shape[2],
                 chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed (error {err})")
    launches += 1
    return out


def ssd_bhtp(x, a, b, c, *, chunk: int = 128):
    """x [B,H,T,P] -> [B,H,T,P] in x's dtype: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.is_cuda:
        return ssd_cuda(x, a, b, c, chunk=chunk)
    _check(x, a, b, c)
    return ssd_plain(x, a, b, c)
