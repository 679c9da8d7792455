"""Gradient compression with error feedback: the JAX package's
``optim/compression.py`` on tensors.

int8 block-quantized gradients (EF-SGD style): the quantization residual is
carried to the next step, so the scheme is unbiased in the long run. The
arithmetic is the reference's to the bit: blocks of 256, scale = max|x| /
127, levels ``round(x / max(scale, 1e-12))`` (a division, not a product
with the reciprocal; ``torch.round`` rounds half to even as ``jnp.round``
does), clipped to ±127.

Gradients and the residual are dicts keyed by the parameters' names, as
``optim.adamw`` keeps its state; each is quantized as the reference's leaf
it belongs to (the layers of a stack together, ``optim.stacks.leaves``), so
the blocks of 256 are the reference's: a layer whose size is a multiple of
256 is its own blocks and is quantized alone; only the other stacks (small
vectors, whose blocks cross layer boundaries) are stacked first.
``compressed_psum`` is the reference's all-reduce of int8 levels on a
``torch.distributed`` group.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.sharding import all_gather_rows
from repro_torch.optim.stacks import gather, leaves, scatter

BLOCK = 256


def _pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % multiple)), n


def quantize(x: torch.Tensor, block: int = BLOCK):
    """-> (q int8 [nb, block], scale f32 [nb, 1], orig_size). Blockwise
    symmetric max-scaling."""
    flat, n = _pad_to(x.float(), block)
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int, shape,
               dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)


def compress_with_feedback(grads: Dict[str, torch.Tensor],
                           residual: Dict[str, torch.Tensor]):
    """EF step: g' = Q(g + r); r' = (g + r) - g'. Returns (g', r')."""
    out, res = {}, {}
    for _, stacked, names in leaves(grads):
        if stacked and grads[names[0]].numel() % BLOCK == 0:
            groups = [(False, [name]) for name in names]
        else:
            groups = [(stacked, names)]
        for whole, group in groups:
            g = gather(grads, whole, group)
            gf = g.float() + gather(residual, whole, group)
            q, s, n = quantize(gf)
            gq = dequantize(q, s, n, g.shape)
            out.update(scatter(gq.to(g.dtype), whole, group))
            res.update(scatter(gf - gq, whole, group))
    return out, res


def init_residual(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """f32 zeros of each parameter's shape, by its name."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.named_parameters()}


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Quantize -> all-gather the int8 levels and the block scales ->
    rescale and sum locally in f32, over ``group``.

    Each member contributes int8 levels against its own block scale; the sum
    of the dequantized members is exact with respect to the quantized
    contributions (the quantization error itself is absorbed by the caller's
    error feedback). Wire bytes a member: 1 a element plus the scales, where
    an f32 all-reduce moves 4. The levels stay int8 on the wire."""
    q, scale, n = quantize(x)
    p = dist.get_world_size(group)
    qs = q.new_empty((p * q.shape[0], q.shape[1]))
    ss = scale.new_empty((p * scale.shape[0], 1))
    all_gather_rows(qs, q, group)        # int8
    all_gather_rows(ss, scale, group)    # f32
    total = torch.sum(qs.float().reshape(p, *q.shape)
                      * ss.reshape(p, *scale.shape), dim=0)
    return total.reshape(-1)[:n].reshape(x.shape).to(x.dtype)
