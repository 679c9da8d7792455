"""RWKV-6 WKV chunked recurrence as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/wkv6.py`` (``_wkv_kernel``
/ ``wkv6_bhtk``). Layout: r, k, v, logw [B, H, T, K], u [H, K] (``ops.py``
transposes from the model's [B, T, H, K]).

On the H100 this function is bound by operations at the model's shapes: at
B=8, H=32, T=192, K=64 in bf16 it needs about 1.9 GFLOP of f32 work (0.10 G
of it exponentials) against 38 MB of input and output. The kernel in
``csrc/wkv6.cu`` keeps the TPU kernel's chunked form: the [K, K] state lives
on chip for the whole sequence (in shared memory, one CTA per (b, h), the
chunk axis a loop inside the CTA) and the pairwise decay exponent is built
per (t, s, k) and clamped at 0, never factored (``exp(-la)`` overflows f32
within a chunk under strong decays). Its math is f32 on the CUDA cores;
moving the products to wgmma is later work. A ragged last chunk is masked
in the kernel, so every T launches.

``wkv6_bhtk`` launches the kernel for a CUDA tensor and takes the plain
version, ``wkv6_plain`` (the oracle ``ref.wkv6_ref``), for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv6_ref as wkv6_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # kernel launches since the caller last set this to 0


def _check(r, k, v, logw, u):
    _build.refuse_grad("wkv6", r, k, v, logw, u)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} logw{tuple(logw.shape)}")
    b, h, t, kk = r.shape
    if tuple(u.shape) != (h, kk):
        raise ValueError(f"u{tuple(u.shape)} is not [{h}, {kk}]")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6 takes r/k/v in float32 or bfloat16, got "
                         f"{r.dtype}/{k.dtype}/{v.dtype}")
    if kk % 4:
        raise ValueError(f"head size {kk} is not a multiple of 4")
    if min(b, h, t) == 0:
        raise ValueError("empty wkv6 input")


def wkv6_cuda(r, k, v, logw, u, *, chunk: int = 64):
    """Launch the CUDA kernel; all tensors on the card."""
    global launches
    if not all(x.is_cuda for x in (r, k, v, logw, u)):
        raise ValueError("wkv6_cuda takes CUDA tensors")
    _check(r, k, v, logw, u)
    if chunk <= 0:
        raise ValueError(f"chunk {chunk} must be positive")
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    logw = logw.float().contiguous()
    u = u.float().contiguous()
    b, h, t, kk = r.shape
    out = torch.empty_like(r)
    fn = _build.load("wkv6").wkv6_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), out.data_ptr(), _DTYPES[r.dtype], b, h, t, kk,
                 chunk, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (error {err})")
    launches += 1
    return out


def wkv6_bhtk(r, k, v, logw, u, *, chunk: int = 64):
    """[B,H,T,K] -> [B,H,T,K] in r's dtype: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if r.is_cuda:
        return wkv6_cuda(r, k, v, logw, u, chunk=chunk)
    _check(r, k, v, logw, u)
    return wkv6_plain(r, k, v, logw, u)
