"""Public wrappers for the port's kernels, in the model's layout.

A CUDA tensor goes to the hand-written kernel (which launches or raises); a
CPU tensor goes to the kernel's plain version. Every kernel tiles and masks
its ragged edges itself, so no shape predicate sends a CUDA tensor
elsewhere (the reference sends shapes its TPU tiles do not divide to its
oracles). No wrapper takes a gradient: each raises when autograd would
record the call.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.relic_matmul import relic_matmul, relic_matmul_gated
from repro_torch.kernels.ssd import ssd_bhtp
from repro_torch.kernels.wkv6 import wkv6_bhtk


def matmul(x, y, *, bm=256, bn=256, bk=512):
    """[M,K] @ [K,N] in x's dtype; ``bm``/``bn``/``bk`` as the reference's."""
    return relic_matmul(x, y, bm=bm, bn=bn, bk=bk)


def matmul_gated(x, w_gate, w_up, *, act="silu", bm=256, bn=256, bk=512):
    """act(x @ w_gate) * (x @ w_up) in x's dtype."""
    return relic_matmul_gated(x, w_gate, w_up, act=act, bm=bm, bn=bn, bk=bk)


def flash_attention(q, k, v, *, causal=True):
    """Model layout [B,S,H,D] in/out; GQA via kv-head grouping."""
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


def wkv6(r, k, v, logw, u, *, chunk=64):
    """Model layout [B,T,H,K] in/out; u [H,K]."""
    o = wkv6_bhtk(*(x.transpose(1, 2) for x in (r, k, v, logw)), u,
                  chunk=chunk)
    return o.transpose(1, 2)


def ssd(x, a, b, c, *, chunk=128):
    """x [B,T,H,P]; a [B,T,H]; b/c [B,T,N] in model layout."""
    o = ssd_bhtp(x.transpose(1, 2), a.transpose(1, 2), b, c, chunk=chunk)
    return o.transpose(1, 2)
