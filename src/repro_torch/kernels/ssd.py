"""Mamba-2 SSD chunked recurrence as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd.py`` (``_ssd_kernel``
/ ``ssd_bhtp``). Layout: x [B, H, T, P], a (log decay, <= 0) [B, H, T], b/c
[B, T, N] shared across heads, or [B, T, G, N] in G groups of H / G heads,
head h reading group h // (H / G) (the published Zamba2's ``mamba_ngroups``;
``ops.py`` transposes x and a from the model's [B, T, H, ...]).

On the H100 this function is bound by operations at the model's shapes: at
B=8, H=64, T=256, P=N=64 in f32 it needs about 4 GFLOP against 69 MB of
input and output. Both kernels in ``csrc/ssd.cu`` keep the TPU kernel's
chunked form: the [P, N] state lives on chip for the whole sequence, the
chunk axis is a loop inside the CTA, and the decay ``exp(la_t - la_s)`` is
taken only for s <= t, where its exponent is <= 0 (the TPU kernel
exponentiates the whole [C, C] difference and hides the overflow with a
select). Two designs, chosen by a predicate on the inputs
(``tc_eligible``), never by a fallback on failure:

- f32 with P = N = 64 (every call of zamba2): the tensor-core design. One
  CTA per batch row and pair of heads computes each chunk's C·Bᵀ once for
  both; the next chunk loads by cp.async while this one computes; the
  products run on the tensor cores in 3xTF32 (``mma.sync``), with the state
  in f32 registers. It reads x, a and y in the caller's layout (the model's
  [B, T, H, ...] as handed over by ``ops.ssd``), with no copy. With groups
  the pair must lie in one group (H / G even: 56 in Zamba2-7B), and the CTA
  reads its group's b and c;
- everything else (bf16 x, other P and N, an odd H / G): the first design,
  one CTA per (b, h), f32 on the CUDA cores, over contiguous copies; a P or
  N that is no multiple of 4 runs on copies zero-padded to one (zero
  columns of x, b and c add nothing), and the output is sliced back; with
  groups, one launch a group on its heads.

A ragged last chunk is masked in both, so every T launches.

``ssd_bhtp`` launches a kernel for a CUDA tensor and takes the plain
version, ``ssd_plain`` (the oracle ``ref.ssd_ref``), for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cp_async_rows
from repro_torch.kernels.ref import group_heads, ssd_ref as ssd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_P = TC_N = 64   # the head and state size of the tensor-core design

launches = 0      # kernel launches (both designs) since the caller last set this to 0
tc_launches = 0   # of which the tensor-core design's


def _check(x, a, b, c):
    _build.refuse_grad("ssd", x, a, b, c)
    if x.dim() != 4:
        raise ValueError(f"x{tuple(x.shape)} is not [B, H, T, P]")
    bb, h, t, p = x.shape
    if tuple(a.shape) != (bb, h, t):
        raise ValueError(f"a{tuple(a.shape)} is not [{bb}, {h}, {t}]")
    if (b.dim() not in (3, 4) or b.shape != c.shape
            or tuple(b.shape[:2]) != (bb, t) or h % groups(b)):
        raise ValueError(f"b{tuple(b.shape)} / c{tuple(c.shape)} are not "
                         f"[{bb}, {t}, N] or [{bb}, {t}, G, N] with G "
                         f"dividing {h} heads")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd takes x in float32 or bfloat16, got {x.dtype}")
    if min(bb, h, t, p, b.shape[-1], groups(b)) == 0:
        raise ValueError("empty ssd input")


def groups(b) -> int:
    """G of b [B, T, G, N]; 1 for b [B, T, N]."""
    return b.shape[2] if b.dim() == 4 else 1


def tc_eligible(x, b) -> bool:
    """The dispatch predicate of ``ssd_cuda``: f32 x with P = 64 and a
    state size of 64, whose head pairs each lie in one group, goes to the
    tensor-core design; everything else to the first design. (a, b and c
    are f32 by then: the wrapper casts them.)"""
    g = groups(b)
    return (x.dtype == torch.float32 and x.shape[3] == TC_P
            and b.shape[-1] == TC_N and (g == 1 or x.shape[1] // g % 2 == 0))


def tc_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the tensor-core design can read it as it lies (x: see
    ``cp_async_rows``; b and c: contiguous with a 16-byte aligned base),
    else a dense copy, which is."""
    readable = (cp_async_rows(t) if t.dim() == 4
                else t.is_contiguous() and t.data_ptr() % 16 == 0)
    return t if readable else t.clone(memory_format=torch.contiguous_format)


def _launch_tc(x, a, b, c):
    global launches, tc_launches
    n, g = b.shape[-1], groups(b)   # b and c [B, T, G * N] for the copy check
    x, b, c = tc_layout(x), tc_layout(b.flatten(2)), tc_layout(c.flatten(2))
    out = torch.empty_like(x)   # x's layout when x is dense, else contiguous
    bb, h, t, p = x.shape
    strides = (ctypes.c_longlong * 9)(*x.stride()[:3], *out.stride()[:3],
                                      *a.stride())
    fn = _build.entry("ssd", "ssd_tc_forward", [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with _build.on_device(x):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 out.data_ptr(), ctypes.addressof(strides), bb, h, t, p, n, g,
                 _build.stream(x))
    if err != 0:
        raise RuntimeError(f"ssd (tensor-core design) launch failed (error {err})")
    launches += 1
    tc_launches += 1
    return out


def _launch_first(x, a, b, c, chunk):
    global launches
    if b.dim() == 4:   # one launch a group, on its heads
        return torch.cat([_launch_first(xg, ag, bg, cg, chunk) for bg, cg, xg, ag
                          in group_heads(b, c, (x, 1), (a, 1))], dim=1)
    p_true = x.shape[3]
    x = _build.pad4(x.contiguous())
    a, b, c = a.contiguous(), _build.pad4(b.contiguous()), _build.pad4(c.contiguous())
    bb, h, t, p = x.shape
    out = torch.empty_like(x)
    fn = _build.entry("ssd", "ssd_forward", [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with _build.on_device(x):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 out.data_ptr(), _DTYPES[x.dtype], bb, h, t, p, b.shape[2],
                 chunk, _build.stream(x))
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed (error {err})")
    launches += 1
    return out[..., :p_true]


def ssd_cuda(x, a, b, c, *, chunk: int = 128):
    """Launch a CUDA kernel; all tensors on the card. The tensor-core design
    where ``tc_eligible`` holds (its chunk is its own), else the first
    design at ``chunk``."""
    if not all(t.is_cuda for t in (x, a, b, c)):
        raise ValueError("ssd_cuda takes CUDA tensors")
    _check(x, a, b, c)
    if chunk <= 0:
        raise ValueError(f"chunk {chunk} must be positive")
    a, b, c = a.float(), b.float(), c.float()
    if tc_eligible(x, b):
        return _launch_tc(x, a, b, c)
    return _launch_first(x, a, b, c, chunk)


def ssd_bhtp(x, a, b, c, *, chunk: int = 128):
    """x [B,H,T,P] -> [B,H,T,P] in x's dtype: a kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.is_cuda:
        return ssd_cuda(x, a, b, c, chunk=chunk)
    _check(x, a, b, c)
    return ssd_plain(x, a, b, c)
