"""Flash attention (GQA, optional causal) as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_fa_kernel`` / ``flash_attention_bhsd``). Layout: [B, H, S, D]
(``ops.py`` transposes from the model's [B, S, H, D]).

On the H100, causal attention at the model's widths is bound by operations:
at B=4, S=2048, H=12, Hkv=4, D=64 it needs about 26 GFLOP against 34 MB of
input and output, far above the card's 295 FLOP/byte ridge in bf16. The
kernel in ``csrc/flash_attention.cu`` keeps the TPU kernel's structure (the
online softmax (m, l, acc) in f32, never writing the S x S scores to device
memory, and never loading kv tiles wholly above the causal diagonal) but
does its math in f32 on the CUDA cores; moving the two products onto wgmma
is the work that brings it toward the tensor-core bound.

``flash_attention_bhsd`` launches the kernel for a CUDA tensor and takes the
plain version, ``flash_attention_plain`` (the oracle ``ref.attention_ref``),
for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # kernel launches since the caller last set this to 0


def _check(q, k, v):
    _build.refuse_grad("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if min(b, h, sq, k.shape[2]) == 0:
        raise ValueError("empty attention input")


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch the CUDA kernel; q [B,H,Sq,D], k/v [B,Hkv,Sk,D] on the card."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.fa_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, h, hkv, sq, sk, d, d ** -0.5,
                 int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (error {err})")
    launches += 1
    return out


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """[B,H,Sq,D] x [B,Hkv,Sk,D] -> [B,H,Sq,D]: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    _check(q, k, v)
    return flash_attention_plain(q, k, v, causal=causal)
