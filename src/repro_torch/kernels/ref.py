"""Plain-torch oracles for the port's kernels (independent implementations —
no code shared with the kernels or the model fast paths, but for
``group_heads``, the split of a grouped SSD's heads by group that the
oracle, the model's chunked SSD and the kernel's first design each use)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul_ref(x, y, out_dtype=None):
    """x [M,K] @ y [K,N] with both cast to f32; out in ``out_dtype`` or x's
    dtype."""
    return (x.float() @ y.float()).to(out_dtype or x.dtype)


def matmul_gated_ref(x, w_gate, w_up, act: str = "silu", out_dtype=None):
    """act(x @ w_gate) * (x @ w_up) in f32. ``silu``, or ``gelu`` in its tanh
    form (jax.nn.gelu's default); any other name leaves the gate
    unactivated, as the reference does."""
    xf = x.float()
    g = xf @ w_gate.float()
    if act == "silu":
        g = g * torch.sigmoid(g)
    elif act == "gelu":
        g = F.gelu(g, approximate="tanh")
    return (g * (xf @ w_up.float())).to(out_dtype or x.dtype)


def attention_ref(q, k, v, *, causal=True, scale=None):
    """q: [B,H,Sq,D]; k/v: [B,Hkv,Sk,D] (GQA by head repeat). q is scaled in
    f32 before the dot (by ``scale``, ``D ** -0.5`` unless given), as the
    flash-attention kernel does; scores masked at -1e30, f32 softmax and
    accumulation, out in q's dtype."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        sk = k.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def wkv6_ref(r, k, v, logw, u):
    """Naive per-step RWKV-6 recurrence in f32. r/k/v/logw [B,H,T,K]; u
    [H,K]; out in r's dtype."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    b, h, t, kk = rf.shape
    state = torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(t):
        rt, kt, vt, lwt = rf[:, :, i], kf[:, :, i], vf[:, :, i], wf[:, :, i]
        kv = torch.einsum("bhi,bhj->bhij", kt, vt)
        outs.append(torch.einsum("bhi,bhij->bhj", rt,
                                 state + uf[None, :, :, None] * kv))
        state = state * torch.exp(lwt)[..., None] + kv
    return torch.stack(outs, dim=2).to(r.dtype)


def group_heads(b, c, *per_head):
    """For each group of b and c [B, T, G, N] (head h of H reads group
    h // (H / G)): (b_g, c_g, *the group's heads of each (tensor, heads dim)
    in ``per_head``), as views."""
    g = b.shape[2]
    for i in range(g):
        yield (b[:, :, i], c[:, :, i],
               *(t.narrow(d, i * (t.shape[d] // g), t.shape[d] // g)
                 for t, d in per_head))


def ssd_ref(x, a, b, c):
    """Naive per-step Mamba-2 SSD in f32. x [B,H,T,P]; a [B,H,T]; b/c
    [B,T,N] shared across heads, or [B,T,G,N] in G groups (head h reads
    group h // (H / G), each group's heads a call of their own); out in x's
    dtype."""
    if b.dim() == 4:
        return torch.cat([ssd_ref(xg, ag, bg, cg) for bg, cg, xg, ag
                          in group_heads(b, c, (x, 1), (a, 1))], dim=1)
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    bb, h, t, p = xf.shape
    n = bf.shape[-1]
    state = torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        state = state * torch.exp(af[:, :, i])[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, :, i], bf[:, i])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, i]))
    return torch.stack(ys, dim=2).to(x.dtype)
