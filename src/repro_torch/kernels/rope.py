"""RoPE of q and k (split-half rotary position embedding) as one
hand-written Hopper kernel.

Replaces no TPU kernel: the JAX package leaves ``apply_rope`` to XLA, which
fuses it. Eager PyTorch runs ``models/layers.py::apply_rope`` as about 18
kernels a call, in f32 on strided halves; ``csrc/rope.cu`` rotates q and k
of one layer in a single launch that reads and writes each byte once. It is
bound by bytes: at phi3_mini_3p8b's [4, 2048, 32 + 32, 96] in bf16 it moves
201 MB a call.

The kernel runs apply_rope's own operations in their order, each rounded on
its own, with the same frequencies (``rope_freqs``, computed once per head
size, theta and device and kept), so its result is apply_rope's bit for
bit in f32 and bf16.

``rope`` launches the kernel for CUDA tensors and takes the plain version,
``rope_plain`` (``apply_rope`` on each tensor), for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import apply_rope, rope_freqs

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 12288   # cos and sin of one token's frequencies fill 48 KB of shared memory

launches = 0   # kernel launches since the caller last set this to 0

_freqs: dict = {}   # (head_dim, theta, device) -> rope_freqs(...)


def _check(q, k, positions):
    _build.refuse_grad("rope", q, k)
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"q{tuple(q.shape)} / k{tuple(k.shape)} are not "
                         "[B, S, H, D] / [B, S, Kv, D]")
    b, s = q.shape[:2]
    if positions.dim() != 2 or positions.shape[1] != s \
            or positions.shape[0] not in (1, b):
        raise ValueError(f"positions{tuple(positions.shape)} are not [1, {s}] "
                         f"or [{b}, {s}]")


def rope_plain(q, k, positions, theta):
    """``apply_rope`` on q and on k, the kernel's plain version."""
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def _freq(d: int, theta: float, device) -> torch.Tensor:
    key = (d, float(theta), device)
    f = _freqs.get(key)
    if f is None:
        f = _freqs[key] = rope_freqs(d, theta, device)
    return f


def _check_card(q, k, positions):
    """What the kernel takes beyond ``_check``: q and k both f32 or both
    bf16, an even head size up to MAX_HEAD_DIM, integer positions, q and k
    contiguous [B, S, H, D], nothing empty."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise ValueError(f"rope takes q and k both float32 or both bfloat16, "
                         f"got {q.dtype} and {k.dtype}")
    b, s, h, d = q.shape
    if d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"rope takes an even head size up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if positions.dtype.is_floating_point or positions.dtype == torch.bool:
        raise ValueError(f"rope takes integer positions, got {positions.dtype}")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError("rope takes q and k contiguous in [B, S, H, D]")
    if min(b, s, h, k.shape[2]) == 0:
        raise ValueError("empty rope input")


def rope_cuda(q, k, positions, theta):
    """Launch the kernel; q, k and positions on the card. Refuses CPU
    tensors first, then what ``_check`` and ``_check_card`` refuse, all
    before any launch."""
    global launches
    if not all(t.is_cuda for t in (q, k, positions)):
        raise ValueError("rope_cuda takes CUDA tensors")
    _check(q, k, positions)
    _check_card(q, k, positions)
    b, s, h, d = q.shape
    pos = positions.to(torch.int64).contiguous()
    freq = _freq(d, theta, q.device)
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    fn = _build.entry("rope", "rope_forward", [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with _build.on_device(q):
        err = fn(q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                 pos.data_ptr(), freq.data_ptr(), _DTYPES[q.dtype], b, s,
                 pos.shape[0], h, k.shape[2], d, _build.stream(q))
    if err != 0:
        raise RuntimeError(f"rope kernel launch failed (error {err})")
    launches += 1
    return qo, ko


def rope(q, k, positions, theta):
    """q [B, S, H, D] and k [B, S, Kv, D] rotated at ``positions`` [1, S]
    or [B, S]: a kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return rope_cuda(q, k, positions, theta)
    _check(q, k, positions)
    return rope_plain(q, k, positions, theta)
