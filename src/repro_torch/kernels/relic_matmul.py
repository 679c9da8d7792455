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
least 0.096 ms on the CUDA cores (67 TFLOP/s). Every kernel keeps the TPU
kernels' f32 accumulator tile in registers, one output tile at a time with
K a loop inside it, and masks ragged edges, so every shape launches.
``relic_matmul`` has three designs, chosen by predicates on the inputs,
never by a fallback on failure:

- bf16 whose x and w a TMA map can describe (``wgmma_eligible``: contiguous,
  16-byte aligned, K and N multiples of 8): ``csrc/relic_matmul_wgmma.cu``,
  the paper's SPSC pipeline on Hopper: a TMA producer keeps a 4-stage
  mbarrier ring full and two wgmma warpgroups consume it, persistent over
  128 x 128 or 128 x 256 output tiles (``wgmma_tile_n``, by shape);
- other bf16: ``csrc/relic_matmul.cu``'s ``mma.sync`` kernel;
- f32: IEEE FMA on the CUDA cores, never TF32, in ``csrc/relic_matmul.cu``,
  with a tile chosen by shape (``f32_tile``) so a small product still fills
  the card, and a cp.async ring over K.

``relic_matmul_gated`` has the same three routes, chosen by the same
predicate on x and each weight: bf16 that TMA can describe runs the gated
form of ``csrc/relic_matmul_wgmma.cu`` (each ring stage holds the x tile and
a tile of each weight; two accumulators; 128 or 64 columns per weight by
``wgmma_tile_n`` over ``GATED_WGMMA_TILES_N``); other bf16 the ``mma.sync``
kernel and f32 the FMA kernel of ``csrc/relic_matmul.cu``. Every route
applies the activation at the flush, with no intermediate in device
memory.

``bm``/``bn``/``bk`` are the TPU kernel's VMEM block sizes. The wrappers take
them so that call sites read as the reference's, and ignore them: the CUDA
kernels tile by their own sizes. The reference sends a shape its blocks do
not tile to ``ref.matmul_ref``, which computes the same function.

``relic_matmul`` / ``relic_matmul_gated`` launch a kernel for CUDA tensors
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
# The f32 tiles of csrc/relic_matmul.cu, largest first: (rows, columns).
F32_TILES = ((128, 128), (64, 128), (32, 32), (16, 32))
WGMMA_TILE_M = 128
WGMMA_TILES_N = (256, 128)   # output columns per tile of the wgmma design
GATED_WGMMA_TILES_N = (128, 64)   # ... of its gated form, per weight

launches = 0         # relic_matmul launches (every design) since the caller last set it to 0
wgmma_launches = 0   # of which the wgmma design's
gated_launches = 0   # relic_matmul_gated launches, likewise
gated_wgmma_launches = 0   # of which the wgmma design's


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


def wgmma_eligible(x, w) -> bool:
    """The dispatch predicate of ``relic_matmul_cuda``: bf16 that a TMA map
    can describe (both contiguous, bases 16-byte aligned, K and N multiples
    of 8 so that every row stride is a multiple of 16 bytes) goes to the
    wgmma design; everything else to the ``mma.sync`` or f32 kernel."""
    return (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and x.shape[1] % 8 == 0 and w.shape[1] % 8 == 0
            and x.is_contiguous() and w.is_contiguous()
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_tile_n(m: int, n: int, n_sm: int, widths=WGMMA_TILES_N) -> int:
    """Output columns per tile of the wgmma design for an [m, n] output on
    ``n_sm`` SMs, from ``widths`` (widest first; the gated form's are
    ``GATED_WGMMA_TILES_N``): the width that needs the fewest rounds of the
    persistent CTAs, each round weighted by its tile's width (its time), the
    wider on a tie (so a product of one round takes the narrower tile, which
    computes fewer padded columns). relic_tiny's down product [2048, 768]
    gets 128 (96 tiles, one round) where 256 would leave 84 of 132 SMs
    idle."""
    def cost(bn):
        return _ceil(_ceil(m, WGMMA_TILE_M) * _ceil(n, bn), n_sm) * bn
    return min(widths, key=cost)   # min keeps the first (widest) on a tie


def f32_tile(m: int, n: int, n_sm: int) -> int:
    """Index into ``F32_TILES`` for an [m, n] f32 output on ``n_sm`` SMs: the
    largest tile that still gives every SM a CTA, else the smallest, so a
    small product spreads over as many SMs as the tiles allow."""
    for i, (bm, bn) in enumerate(F32_TILES):
        if _ceil(m, bm) * _ceil(n, bn) >= n_sm:
            return i
    return len(F32_TILES) - 1


_N_SM: dict[int, int] = {}


def sm_count(device) -> int:
    """The number of SMs of a CUDA device, read once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _N_SM[idx]


def _launch(source, entry, argtypes, x, weights, out_dtype, *ints):
    """Call a C entry on contiguous CUDA tensors (the caller's, or copies):
    the pointers of x, the weights and a new [M, N] output in ``out_dtype``,
    then ``ints`` and the stream."""
    if not (x.is_cuda and all(t.is_cuda for t in weights)):
        raise ValueError(f"{entry} takes CUDA tensors")
    if not (x.is_contiguous() and all(t.is_contiguous() for t in weights)):
        x = x.contiguous()
        weights = [t.contiguous() for t in weights]
    out = torch.empty((x.shape[0], weights[0].shape[1]), dtype=out_dtype,
                      device=x.device)
    fn = _build.entry(source, entry, argtypes)
    with _build.on_device(x):
        err = fn(x.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
                 *ints, _build.stream(x))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed (error {err})")
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int


def relic_matmul_cuda(x, y, *, out_dtype=None):
    """Launch a CUDA kernel: x [M,K] @ y [K,N] on the card; the wgmma design
    where ``wgmma_eligible`` holds, else the ``mma.sync`` (bf16) or the
    FMA (f32) kernel."""
    global launches, wgmma_launches
    _check("relic_matmul", x, [y], out_dtype)
    if not (x.is_cuda and y.is_cuda):
        raise ValueError("relic_matmul_cuda takes CUDA tensors")
    (m, k), n = x.shape, y.shape[1]
    od = out_dtype or x.dtype
    n_sm = sm_count(x.device)
    if wgmma_eligible(x, y):
        out = _launch("relic_matmul_wgmma", "relic_matmul_wgmma_forward",
                      [_P] * 3 + [_I] * 5 + [_P], x, [y], od,
                      int(od == torch.bfloat16), m, n, k, wgmma_tile_n(m, n, n_sm))
        wgmma_launches += 1
    else:
        out = _launch("relic_matmul", "relic_matmul_forward",
                      [_P] * 3 + [_I] * 6 + [_P], x, [y], od, _DTYPES[x.dtype],
                      int(od == torch.bfloat16), m, n, k, f32_tile(m, n, n_sm))
    launches += 1
    return out


def relic_matmul_gated_cuda(x, w_gate, w_up, *, act="silu", out_dtype=None):
    """Launch a CUDA kernel: act(x @ w_gate) * (x @ w_up) on the card; the
    wgmma design where ``wgmma_eligible`` holds for x with each weight, else
    the ``mma.sync`` (bf16) or the FMA (f32) kernel."""
    global gated_launches, gated_wgmma_launches
    _check("relic_matmul_gated", x, [w_gate, w_up], out_dtype)
    if not (x.is_cuda and w_gate.is_cuda and w_up.is_cuda):
        raise ValueError("relic_matmul_gated_cuda takes CUDA tensors")
    (m, k), n = x.shape, w_gate.shape[1]
    od = out_dtype or x.dtype
    if wgmma_eligible(x, w_gate) and wgmma_eligible(x, w_up):
        bn = wgmma_tile_n(m, n, sm_count(x.device), GATED_WGMMA_TILES_N)
        out = _launch("relic_matmul_wgmma", "relic_matmul_gated_wgmma_forward",
                      [_P] * 4 + [_I] * 6 + [_P], x, [w_gate, w_up], od,
                      int(od == torch.bfloat16), m, n, k, bn, ACTS.get(act, 0))
        gated_wgmma_launches += 1
    else:
        out = _launch("relic_matmul", "relic_matmul_gated_forward",
                      [_P] * 4 + [_I] * 6 + [_P], x, [w_gate, w_up], od,
                      _DTYPES[x.dtype], int(od == torch.bfloat16), m, n, k,
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
