"""Public wrappers for the port's kernels, in the model's layout.

A CUDA tensor goes to the hand-written kernel (which launches or raises); a
CPU tensor goes to the kernel's plain version. Every kernel tiles and masks
its ragged edges itself, so no shape predicate sends a CUDA tensor
elsewhere (the reference sends shapes its TPU tiles do not divide to its
oracles). No wrapper takes a gradient: each raises when autograd would
record the call, and none takes a DTensor: the C entries read one device's
memory, so a sharded forward with the kernels raises (a distributed state
trains and runs on the plain paths, ``use_kernels=False``).
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor

from repro_torch.kernels.conv import causal_conv_silu as _causal_conv_silu
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.relic_matmul import relic_matmul, relic_matmul_gated
from repro_torch.kernels.rope import rope as _rope
from repro_torch.kernels.ssd import ssd_bhtp
from repro_torch.kernels.wkv6 import wkv6_bhtk


def _refuse_dtensor(name: str, *tensors) -> None:
    if any(isinstance(t, DTensor) for t in tensors):
        raise RuntimeError(f"{name} takes no DTensor: a sharded forward runs "
                           "the plain paths (use_kernels=False)")


def matmul(x, y, *, bm=256, bn=256, bk=512):
    """[M,K] @ [K,N] in x's dtype; ``bm``/``bn``/``bk`` as the reference's."""
    _refuse_dtensor("matmul", x, y)
    return relic_matmul(x, y, bm=bm, bn=bn, bk=bk)


def matmul_gated(x, w_gate, w_up, *, act="silu", bm=256, bn=256, bk=512):
    """act(x @ w_gate) * (x @ w_up) in x's dtype."""
    _refuse_dtensor("matmul_gated", x, w_gate, w_up)
    return relic_matmul_gated(x, w_gate, w_up, act=act, bm=bm, bn=bn, bk=bk)


def flash_attention(q, k, v, *, causal=True, scale=None):
    """Model layout [B,S,H,D] in/out; GQA via kv-head grouping; softmax
    scale ``D ** -0.5`` unless given. The transposes are views: the wgmma
    design reads and writes the model's layout through its tensor maps,
    with no copy."""
    _refuse_dtensor("flash_attention", q, k, v)
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, scale=scale)
    return o.transpose(1, 2)


def rope(q, k, positions, theta):
    """q [B,S,H,D] and k [B,S,Kv,D] rotated (split-half RoPE) at
    ``positions`` [1,S] or [B,S], one launch for both: (q_rot, k_rot)."""
    _refuse_dtensor("rope", q, k, positions)
    return _rope(q, k, positions, theta)


def causal_conv_silu(x, w, bias=None):
    """SiLU of the depthwise causal conv (and its bias) of x [B,S,C] with w
    [K,C], one launch: a contiguous [B,S,C] in x's dtype. x may be a view
    whose rows are strided, as the in-projection's xBC columns are."""
    _refuse_dtensor("causal_conv_silu", x, w, bias)
    return _causal_conv_silu(x, w, bias)


def wkv6(r, k, v, logw, u, *, chunk=64):
    """Model layout [B,T,H,K] in/out; u [H,K]."""
    _refuse_dtensor("wkv6", r, k, v, logw, u)
    o = wkv6_bhtk(*(x.transpose(1, 2) for x in (r, k, v, logw)), u,
                  chunk=chunk)
    return o.transpose(1, 2)


def ssd(x, a, b, c, *, chunk=128):
    """x [B,T,H,P]; a [B,T,H]; b/c [B,T,N], or [B,T,G,N] in G groups, in
    model layout."""
    _refuse_dtensor("ssd", x, a, b, c)
    o = ssd_bhtp(x.transpose(1, 2), a.transpose(1, 2), b, c, chunk=chunk)
    return o.transpose(1, 2)
