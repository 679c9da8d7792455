"""RWKV-6 WKV chunked recurrence as hand-written Hopper kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/wkv6.py`` (``_wkv_kernel``
/ ``wkv6_bhtk``). Layout: r, k, v, logw [B, H, T, K], as views of any
strides (``ops.py`` hands over the model's [B, T, H, K] transposed, with no
copy), u [H, K].

On the H100 this function is bound by operations at the model's shapes: at
B=8, H=32, T=192, K=64 in bf16 it needs about 1.9 GFLOP of f32 work (0.10 G
of it exponentials) against 38 MB of input and output. Both kernels in
``csrc/wkv6.cu`` keep the TPU kernel's chunked form: the [K, K] state lives
on chip for the whole sequence, the chunk axis is a loop inside the CTA,
and no exponent they take is above 0 (``exp(-la)`` overflows f32 within a
chunk under strong decays). Two designs, chosen by a predicate on the
inputs (``tc_eligible``), never by a fallback on failure:

- K = 64, f32 or bf16 (every call of rwkv6): the tensor-core design. The
  decays between sub-chunks of 16 steps are factored into the operands
  (both factors' exponents are <= 0), so those scores are a plain product;
  inside the diagonal 16 x 16 blocks the decay of a pair is a running
  product of the step decays exp(lw) <= 1, so no exponential is taken per
  (t, s, channel). Every product runs on the tensor cores in 3xTF32
  (``mma.sync``) with the state in f32 registers; the next chunk loads by
  cp.async while this one computes; the cumulative decay is a shuffle scan.
  It reads r, k, v, logw and writes the output in the caller's layout
  (``tc_layout`` copies only what cp.async cannot read). Its chunk of 32
  steps is its own: the function does not depend on the chunk length;
- every other K: the first design, one CTA per (b, h), f32 on the CUDA
  cores, over contiguous copies; a K that is no multiple of 4 runs on a
  copy zero-padded to one (zero channels of r, k, v and logw add nothing),
  and the output is sliced back.

A ragged last chunk is masked in both, so every T launches.

``wkv6_bhtk`` launches a kernel for a CUDA tensor and takes the plain
version, ``wkv6_plain`` (the oracle ``ref.wkv6_ref``), for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cp_async_rows
from repro_torch.kernels.ref import wkv6_ref as wkv6_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_K = 64   # the head size of the tensor-core design

launches = 0      # kernel launches (both designs) since the caller last set this to 0
tc_launches = 0   # of which the tensor-core design's


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
    if min(b, h, t, kk) == 0:
        raise ValueError("empty wkv6 input")


def tc_eligible(r) -> bool:
    """The dispatch predicate of ``wkv6_cuda``: K = 64 (f32 or bf16, by
    ``_check``) goes to the tensor-core design; every other K to the first
    design."""
    return r.shape[3] == TC_K


def tc_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the tensor-core design can read it as it lies, else a dense
    copy, which it can."""
    return t if cp_async_rows(t) else t.clone(memory_format=torch.contiguous_format)


def _launch_tc(r, k, v, logw, u):
    global launches, tc_launches
    r, k, v, logw = (tc_layout(x) for x in (r, k, v, logw.float()))
    u = u.float().contiguous()
    out = torch.empty_like(r)   # r's layout when r is dense, else contiguous
    b, h, t, kk = r.shape
    strides = (ctypes.c_longlong * 15)(*(st for x in (r, k, v, logw, out)
                                         for st in x.stride()[:3]))
    fn = _build.entry("wkv6", "wkv6_tc_forward", [ctypes.c_void_p] * 7
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with _build.on_device(r):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
                 _DTYPES[r.dtype], b, h, t, kk, _build.stream(r))
    if err != 0:
        raise RuntimeError(f"wkv6 (tensor-core design) launch failed (error {err})")
    launches += 1
    tc_launches += 1
    return out


def _launch_first(r, k, v, logw, u, chunk):
    global launches
    kk = r.shape[3]
    r, k, v = (_build.pad4(x.contiguous()) for x in (r, k, v))
    logw = _build.pad4(logw.float().contiguous())
    u = _build.pad4(u.float().contiguous())
    b, h, t, kp = r.shape
    out = torch.empty_like(r)
    fn = _build.entry("wkv6", "wkv6_forward", [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with _build.on_device(r):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), out.data_ptr(), _DTYPES[r.dtype], b, h, t, kp,
                 chunk, _build.stream(r))
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (error {err})")
    launches += 1
    return out[..., :kk]


def wkv6_cuda(r, k, v, logw, u, *, chunk: int = 64):
    """Launch a CUDA kernel; all tensors on the card. The tensor-core design
    where ``tc_eligible`` holds (its chunk is its own), else the first
    design at ``chunk``."""
    if not all(x.is_cuda for x in (r, k, v, logw, u)):
        raise ValueError("wkv6_cuda takes CUDA tensors")
    _check(r, k, v, logw, u)
    if chunk <= 0:
        raise ValueError(f"chunk {chunk} must be positive")
    if tc_eligible(r):
        return _launch_tc(r, k, v, logw, u)
    return _launch_first(r, k, v, logw, u, chunk)


def wkv6_bhtk(r, k, v, logw, u, *, chunk: int = 64):
    """[B,H,T,K] -> [B,H,T,K] in r's dtype: a kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if r.is_cuda:
        return wkv6_cuda(r, k, v, logw, u, chunk=chunk)
    _check(r, k, v, logw, u)
    return wkv6_plain(r, k, v, logw, u)
