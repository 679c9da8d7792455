"""Plain-torch oracles for the port's kernels (independent implementations —
no code shared with the kernels or the model fast paths)."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True):
    """q: [B,H,Sq,D]; k/v: [B,Hkv,Sk,D] (GQA by head repeat). q is scaled in
    f32 before the dot, as the flash-attention kernel does; scores masked at
    -1e30, f32 softmax and accumulation, out in q's dtype."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (d ** -0.5), k.float())
    if causal:
        sk = k.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)
