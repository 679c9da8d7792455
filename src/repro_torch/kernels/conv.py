"""The Mamba-2 layers' depthwise causal conv, its bias and SiLU as one
hand-written Hopper kernel.

Replaces no TPU kernel: the JAX package leaves the conv to XLA, which fuses
it. Eager PyTorch runs ``models/mamba2.py::_causal_conv`` as about ten
kernels a call over the whole activation; ``csrc/conv.cu`` reads x once,
where it lies (the in-projection's xBC columns, a strided view), and writes
the output once. It is bound by bytes: at zamba2_7b's [4, 4096, 7424] in
bf16 it moves 486.5 MB a call.

The kernel runs ``_causal_conv``'s operations in their order, each rounded
on its own, so its result is ``_causal_conv``'s bit for bit in f32 and
bf16.

``causal_conv_silu`` launches the kernel for CUDA tensors and takes the
plain version, ``causal_conv_silu_plain`` (``_causal_conv`` without a
state), for CPU tensors. CUDA tensors the kernel cannot take are refused
before any launch, never handed to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 4   # taps: the kernel's instances
VEC = 8     # bytes a thread of the kernel loads and stores at once

launches = 0   # kernel launches since the caller last set this to 0


def _given(x, w, bias):
    return (x, w) if bias is None else (x, w, bias)


def _check(x, w, bias):
    _build.refuse_grad("causal_conv_silu", *_given(x, w, bias))
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] < 1 \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"x{tuple(x.shape)} / w{tuple(w.shape)} are not "
                         "[B, S, C] / [K, C]")
    if bias is not None and tuple(bias.shape) != (x.shape[2],):
        raise ValueError(f"bias{tuple(bias.shape)} is not [{x.shape[2]}]")


def _card_refusal(x, w, bias):
    """What of the kernel's conditions beyond ``_check`` the tensors miss,
    or None: x, w and bias all f32 or all bf16, at most MAX_K taps, nothing
    empty, x's channels contiguous, w and bias contiguous, C, x's other
    strides and every base at multiples of VEC bytes."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or (bias is not None and bias.dtype != x.dtype):
        return "x, w and bias all float32 or all bfloat16"
    if w.shape[0] > MAX_K:
        return f"at most {MAX_K} taps"
    if x.numel() == 0:
        return "no empty input"
    es = x.element_size()
    if x.stride(2) != 1 or not w.is_contiguous() \
            or not (bias is None or bias.is_contiguous()) \
            or any(t.data_ptr() % VEC for t in _given(x, w, bias)) \
            or any(n * es % VEC for n in (x.shape[2], x.stride(0), x.stride(1))):
        return (f"{VEC}-byte access: x's channels contiguous, w and bias "
                f"contiguous, C, x's strides and the bases at multiples of "
                f"{VEC} bytes")
    return None


def causal_conv_silu_plain(x, w, bias=None):
    """``_causal_conv`` with no state, its output alone: the kernel's plain
    version."""
    from repro_torch.models.mamba2 import _causal_conv  # deferred: mamba2 imports this package

    return _causal_conv(x, w, None, bias)[0]


def causal_conv_silu_cuda(x, w, bias=None):
    """Launch the kernel; x, w and bias on the card. Refuses CPU tensors
    first, then what ``_check`` and ``_card_refusal`` refuse, all before
    any launch. Returns a contiguous [B, S, C] tensor in x's dtype."""
    global launches
    if not all(t.is_cuda for t in _given(x, w, bias)):
        raise ValueError("causal_conv_silu_cuda takes CUDA tensors")
    _check(x, w, bias)
    why = _card_refusal(x, w, bias)
    if why is not None:
        raise ValueError(f"causal_conv_silu takes {why}")
    b, s, c = x.shape
    out = torch.empty((b, s, c), dtype=x.dtype, device=x.device)
    fn = _build.entry("conv", "causal_conv_silu_forward",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    with _build.on_device(x):
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], b, s, c, w.shape[0], x.stride(0),
                 x.stride(1), _build.stream(x))
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed (error {err})")
    launches += 1
    return out


def causal_conv_silu(x, w, bias=None):
    """SiLU of the depthwise causal conv of x [B, S, C] with w [K, C] and
    its bias [C] (or none): a kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return causal_conv_silu_cuda(x, w, bias)
    _check(x, w, bias)
    return causal_conv_silu_plain(x, w, bias)
