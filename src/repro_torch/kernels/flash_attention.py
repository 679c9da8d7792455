"""Flash attention (GQA, optional causal) as hand-written Hopper kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_fa_kernel`` / ``flash_attention_bhsd``). Layout: [B, H, S, D], as views
of any strides (``ops.py`` hands over the model's [B, S, H, D] transposed,
with no copy).

On the H100, causal attention at the model's widths is bound by operations:
at B=4, S=2048, H=12, Hkv=4, D=64 it needs about 26 GFLOP against 34 MB of
input and output, far above the card's 295 FLOP/byte ridge in bf16. Two
designs share the work, chosen by a predicate on the inputs
(``wgmma_eligible``), never by a fallback on failure:

- ``csrc/flash_attention_wgmma.cu`` (bf16, head_dim 64, every tensor
  describable by a TMA map; every call of the models): both products on
  the tensor cores through wgmma, K and V fed by TMA into an mbarrier ring
  by a producer warp, tensor maps over the caller's own strides, so no
  layout copy is made;
- ``csrc/flash_attention.cu`` (f32, every other head_dim, and layouts TMA
  cannot describe): the CUDA-core kernel, f32 on the CUDA cores, over
  contiguous copies. It has instances at head_dim 16, 32, 64, 96, 128 and
  256; any other head_dim up to 256 runs the next one up, with the columns
  past it zero-filled on chip. Above 256 it runs the head dimension in
  slabs of 128 columns (each CTA one slab of output columns, the scores
  summed slab by slab), so the card takes every head_dim the reference
  takes.

Both keep the TPU kernel's structure: the online softmax (m, l, acc) in f32,
never writing the S x S scores to device memory, and never loading kv tiles
wholly above the causal diagonal.

``flash_attention_bhsd`` launches a kernel for a CUDA tensor and takes the
plain version, ``flash_attention_plain`` (the oracle ``ref.attention_ref``),
for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

WGMMA_HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_STRIDE_BYTES = 1 << 40   # a TMA map's byte strides stay below 2^40

launches = 0         # kernel launches (both designs) since the caller last set this to 0
wgmma_launches = 0   # of which the wgmma design's


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
    if min(b, h, sq, k.shape[2]) == 0:
        raise ValueError("empty attention input")


def _require_cuda(name, *tensors):
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors")


def tma_describable(t: torch.Tensor) -> bool:
    """Whether a TMA map can describe ``t`` as it lies: last dim contiguous,
    every other stride (of a dim longer than 1) a positive multiple of 16
    bytes below 2^40, and the base 16-byte aligned."""
    strides = t.stride()
    if strides[-1] != 1 or t.data_ptr() % 16:
        return False
    es = t.element_size()
    return all(0 < st * es < _MAX_STRIDE_BYTES and st * es % 16 == 0
               for n, st in zip(t.shape[:-1], strides[:-1]) if n > 1)


def wgmma_eligible(q, k, v) -> bool:
    """The dispatch predicate: bf16 with head_dim 64 whose three tensors a
    TMA map can describe goes to the wgmma design; everything else to the
    CUDA-core kernel. (Dtypes of k and v equal q's, by ``_check``.)"""
    return (q.dtype == torch.bfloat16 and q.shape[-1] == WGMMA_HEAD_DIM
            and all(tma_describable(t) for t in (q, k, v)))


def tma_geometry(t: torch.Tensor) -> list[int]:
    """The 4-D map of a [B, H, S, D] view: dims (D, H, S, B), innermost
    first, then the byte strides of H, S and B, taken from the tensor. A
    dim of length 1 is never stepped, so its stride, which PyTorch leaves
    free, is given as one row (D elements) to keep it legal."""
    b, h, s, d = t.shape
    sb, sh, ss, _ = t.stride()
    es = t.element_size()
    return [d, h, s, b, *(st * es if n > 1 else d * es
                          for n, st in ((h, sh), (s, ss), (b, sb)))]


def _launch_wgmma(q, k, v, causal):
    global launches, wgmma_launches
    out = torch.empty_like(q)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    geom = (ctypes.c_int64 * 28)(*tma_geometry(q), *tma_geometry(k),
                                 *tma_geometry(v), *tma_geometry(out))
    fn = _build.entry("flash_attention_wgmma", "fa_wgmma_forward",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with _build.on_device(q):
        stream = _build.stream(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(geom), b, h, hkv, sq, sk, d ** -0.5,
                 int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention (wgmma) launch failed (error {err})")
    launches += 1
    wgmma_launches += 1
    return out


def flash_attention_wgmma(q, k, v, *, causal: bool = True):
    """Launch the wgmma design; q [B,H,Sq,64], k/v [B,Hkv,Sk,64] bf16 on the
    card in any TMA-describable layout. The output has q's strides (the
    caller's layout) when q is dense."""
    _require_cuda("flash_attention_wgmma", q, k, v)
    _check(q, k, v)
    if not wgmma_eligible(q, k, v):
        raise ValueError("flash_attention_wgmma takes bf16, head_dim 64, in "
                         "layouts a TMA map can describe")
    return _launch_wgmma(q, k, v, causal)


def _launch_fma(q, k, v, causal):
    global launches
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", "fa_forward", [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p])
    with _build.on_device(q):
        stream = _build.stream(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, h, hkv, sq, sk, d, d ** -0.5,
                 int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (error {err})")
    launches += 1
    return out


def flash_attention_fma(q, k, v, *, causal: bool = True):
    """Launch the CUDA-core kernel (f32 math on the CUDA cores; f32 or
    bf16, any head_dim) on contiguous copies of the inputs."""
    _require_cuda("flash_attention_fma", q, k, v)
    _check(q, k, v)
    return _launch_fma(q, k, v, causal)


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """q [B,H,Sq,D], k/v [B,Hkv,Sk,D] on the card: the wgmma design where
    ``wgmma_eligible`` holds, else the CUDA-core kernel."""
    _require_cuda("flash_attention_cuda", q, k, v)
    _check(q, k, v)
    if wgmma_eligible(q, k, v):
        return _launch_wgmma(q, k, v, causal)
    return _launch_fma(q, k, v, causal)


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """[B,H,Sq,D] x [B,Hkv,Sk,D] -> [B,H,Sq,D]: a kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    _check(q, k, v)
    return flash_attention_plain(q, k, v, causal=causal)
