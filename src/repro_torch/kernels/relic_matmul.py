"""relic_matmul (the paper's SPSC producer/consumer pipeline written as a
tiled matmul) and its fused gated form, as hand-written Hopper kernels.

Replaces the Pallas TPU kernels ``src/repro/kernels/relic_matmul.py``:
``_mm_kernel`` / ``relic_matmul`` computes ``x @ y`` and ``_gated_kernel`` /
``relic_matmul_gated`` computes ``act(x @ w_gate) * (x @ w_up)``, both with
f32 accumulators flushed to ``out_dtype`` (default x's dtype). Layout: x
[M, K], weights [K, N], row-major.

On the H100 the function is bound by operations at relic_tiny's MLP shape:
[2048, 768] @ [768, 2048] in bf16 is 6.44 GFLOP against 14.7 MB (x and w
read once, the output written once), 0.0065 ms on the tensor cores at 989
TFLOP/s against 0.0044 ms at 3.35 TB/s; the gated form does twice the
operations (0.013 ms) against 17.8 MB. In f32 the same product takes at
least 0.096 ms on the CUDA cores (67 TFLOP/s). The kernels in
``csrc/relic_matmul.cu`` keep the TPU kernels' f32 accumulator tile (here in
registers, one CTA per output tile, K a loop inside it) and the gated
kernel's flush, which applies the activation with no intermediate in device
memory. bf16 runs on the tensor cores through ``mma.sync``; f32 is IEEE FMA
on the CUDA cores, never TF32. TMA, a multi-stage ring and wgmma are later
work.

``bm``/``bn``/``bk`` are the TPU kernel's VMEM block sizes. The wrappers take
them so that call sites read as the reference's, and ignore them: the CUDA
kernels tile by their own sizes (128 x 128, K by 32 in bf16 and 16 in f32;
the gated form 128 x 64 per weight) and mask ragged edges, so every shape
launches. The reference sends a shape its blocks do not tile to
``ref.matmul_ref``, which computes the same function.

``relic_matmul`` / ``relic_matmul_gated`` launch the kernel for CUDA tensors
and take the plain versions (the oracles ``ref.matmul_ref`` /
``ref.matmul_gated_ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_gated_ref as relic_matmul_gated_plain
from repro_torch.kernels.ref import matmul_ref as relic_matmul_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {"silu": 1, "gelu": 2}   # any other name: the gate unactivated

launches = 0         # relic_matmul launches since the caller last set it to 0
gated_launches = 0   # relic_matmul_gated launches, likewise


def _check(name, x, weights, out_dtype):
    _build.refuse_grad(name, x, *weights)
    w = weights[0]
    if x.dim() != 2 or any(t.dim() != 2 or t.shape != w.shape for t in weights):
        raise ValueError(f"{name}: x{tuple(x.shape)} and weights "
                         f"{[tuple(t.shape) for t in weights]} are not [M, K] "
                         f"and [K, N]")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x{tuple(x.shape)} @ w{tuple(w.shape)}: the "
                         f"inner dimensions differ")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in weights):
        raise ValueError(f"{name} takes x and weights of one type, float32 or "
                         f"bfloat16; got {x.dtype} and "
                         f"{[t.dtype for t in weights]}")
    if out_dtype not in (None, *_DTYPES):
        raise ValueError(f"{name}: out_dtype {out_dtype} is not float32 or "
                         f"bfloat16")
    if any(t.device != x.device for t in weights):
        raise ValueError(f"{name}: inputs on more than one device")
    if min(x.shape[0], x.shape[1], w.shape[1]) == 0:
        raise ValueError(f"{name}: empty input")


def _launch(entry, x, weights, out_dtype, *extra):
    """Call a C entry of csrc/relic_matmul.cu on contiguous CUDA tensors."""
    if not (x.is_cuda and all(t.is_cuda for t in weights)):
        raise ValueError(f"{entry} takes CUDA tensors")
    x = x.contiguous()
    weights = [t.contiguous() for t in weights]
    m, k = x.shape
    n = weights[0].shape[1]
    out_dtype = out_dtype or x.dtype
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = getattr(_build.load("relic_matmul"), entry)
    fn.argtypes = ([ctypes.c_void_p] * (len(weights) + 2)
                   + [ctypes.c_int] * (5 + len(extra)) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
                 _DTYPES[x.dtype], int(out_dtype == torch.bfloat16), m, n, k,
                 *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed (error {err})")
    return out


def relic_matmul_cuda(x, y, *, out_dtype=None):
    """Launch the CUDA kernel: x [M,K] @ y [K,N] on the card."""
    global launches
    _check("relic_matmul", x, [y], out_dtype)
    out = _launch("relic_matmul_forward", x, [y], out_dtype)
    launches += 1
    return out


def relic_matmul_gated_cuda(x, w_gate, w_up, *, act="silu", out_dtype=None):
    """Launch the CUDA kernel: act(x @ w_gate) * (x @ w_up) on the card."""
    global gated_launches
    _check("relic_matmul_gated", x, [w_gate, w_up], out_dtype)
    out = _launch("relic_matmul_gated_forward", x, [w_gate, w_up], out_dtype,
                  ACTS.get(act, 0))
    gated_launches += 1
    return out


def relic_matmul(x, y, *, bm=256, bn=256, bk=512, out_dtype=None):
    """[M,K] @ [K,N] -> [M,N] in ``out_dtype`` (default x's): the kernel for
    CUDA tensors, the plain version for CPU tensors. ``bm``/``bn``/``bk`` are
    the reference's TPU tile sizes, accepted and unused."""
    del bm, bn, bk
    if x.is_cuda:
        return relic_matmul_cuda(x, y, out_dtype=out_dtype)
    _check("relic_matmul", x, [y], out_dtype)
    return relic_matmul_plain(x, y, out_dtype)


def relic_matmul_gated(x, w_gate, w_up, *, act="silu", bm=256, bn=256, bk=512,
                       out_dtype=None):
    """act(x @ w_gate) * (x @ w_up) -> [M,N]: the kernel for CUDA tensors, the
    plain version for CPU tensors. ``act``: ``silu``, ``gelu`` (tanh form),
    any other name leaves the gate unactivated."""
    del bm, bn, bk
    if x.is_cuda:
        return relic_matmul_gated_cuda(x, w_gate, w_up, act=act,
                                       out_dtype=out_dtype)
    _check("relic_matmul_gated", x, [w_gate, w_up], out_dtype)
    return relic_matmul_gated_plain(x, w_gate, w_up, act, out_dtype)
