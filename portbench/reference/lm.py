"""Plain float32 reference of the decoder-only language models the benchmark
runs: the dense block (RMSNorm, RoPE attention, gated MLP) and the Zamba2
hybrid (Mamba-2 blocks in groups of ``attn_every``, each group followed by
one shared attention block, then the tail blocks).

It follows the port's arithmetic as a plain function of the configuration
file's ``model`` section and a dict of weights by parameter name: no kernel,
no cache, no batching tricks, every product in float32 with TF32 off
(``float32_exact``). It imports nothing of the program. The departures of
the port from the published models are the configuration files' ``assumed``
notes; this reference follows the port.

``matmul`` is the one place a projection is computed. The control of the
benchmark's check swaps it for a lower precision (``control.fp8_matmul``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def float32_exact():
    """Float32 products without TF32, restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def _check_supported(m: dict) -> None:
    unsupported = {"qk_norm": False, "attn_logit_softcap": 0.0, "moe": None,
                   "enc_layers": 0, "frontend": None, "tie_embeddings": False,
                   "gated_mlp": True}
    for key, plain in unsupported.items():
        if m[key] != plain:
            raise NotImplementedError(f"reference lm: {key}={m[key]!r}")
    if m["family"] not in ("dense", "hybrid"):
        raise NotImplementedError(f"reference lm: family {m['family']!r}")


def _head_dim(m: dict) -> int:
    return m["head_dim"] or m["d_model"] // m["n_heads"]


def _ssm_dims(m: dict) -> Tuple[int, int, int]:
    s = m["ssm"]
    d_inner = s["expand"] * m["d_model"]
    heads = d_inner // s["head_dim"]
    return d_inner, heads, d_inner + 2 * s["state_dim"]


def _attn_block_shapes(m: dict, prefix: str) -> List[Tuple[str, tuple]]:
    d, h, kv, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       _head_dim(m), m["d_ff"])
    return [(f"{prefix}ln1.scale", (d,)),
            (f"{prefix}attn.wq", (d, h, hd)), (f"{prefix}attn.wk", (d, kv, hd)),
            (f"{prefix}attn.wv", (d, kv, hd)), (f"{prefix}attn.wo", (h, hd, d)),
            (f"{prefix}ln2.scale", (d,)),
            (f"{prefix}mlp.w_up", (d, f)), (f"{prefix}mlp.w_down", (f, d)),
            (f"{prefix}mlp.w_gate", (d, f))]


def param_shapes(m: dict) -> List[Tuple[str, tuple]]:
    """Every parameter of the model, by name, in drawing order."""
    _check_supported(m)
    d, v = m["d_model"], m["vocab_size"]
    out = [("embed.table", (v, d))]
    for i in range(m["n_layers"]):
        if m["family"] == "dense":
            out += _attn_block_shapes(m, f"layers.{i}.")
        else:
            s = m["ssm"]
            d_inner, heads, conv_dim = _ssm_dims(m)
            in_dim = 2 * d_inner + 2 * s["state_dim"] + heads
            out += [(f"layers.{i}.ln.scale", (d,)),
                    (f"layers.{i}.ssm.w_in", (d, in_dim)),
                    (f"layers.{i}.ssm.w_out", (d_inner, d)),
                    (f"layers.{i}.ssm.conv", (s["conv_kernel"], conv_dim)),
                    (f"layers.{i}.ssm.A_log", (heads,)),
                    (f"layers.{i}.ssm.D", (heads,)),
                    (f"layers.{i}.ssm.dt_bias", (heads,)),
                    (f"layers.{i}.ssm.norm_scale", (d_inner,))]
    out += [("final_norm.scale", (d,)), ("lm_head.kernel", (d, v))]
    if m["family"] == "hybrid" and m["attn_every"]:
        out += _attn_block_shapes(m, "shared_attn.")
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _norm(m: dict, w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    if m["norm"] != "rmsnorm":
        raise NotImplementedError(f"reference lm: norm {m['norm']!r}")
    return rms_norm(x, w[name])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x [B, S, H, Dh] at positions 0..S-1."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v) -> torch.Tensor:
    """Softmax attention, causal, kv heads shared by groups of q heads:
    q [B, S, H, Dh], k/v [B, S, Kv, Dh] -> [B, S, H, Dh]; scores in float32
    materialised whole."""
    h, kv = q.shape[2], k.shape[2]
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    n = q.shape[1]
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def attention_block(m: dict, w: Weights, prefix: str, x: torch.Tensor,
                    mm: MatMul) -> torch.Tensor:
    b, s, d = x.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], _head_dim(m)
    xn = _norm(m, w, f"{prefix}ln1.scale", x)
    q = mm(xn, w[f"{prefix}attn.wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = mm(xn, w[f"{prefix}attn.wk"].reshape(d, kv * hd)).view(b, s, kv, hd)
    v = mm(xn, w[f"{prefix}attn.wv"].reshape(d, kv * hd)).view(b, s, kv, hd)
    if m["use_rope"]:
        q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    o = causal_attention(q, k, v).reshape(b, s, h * hd)
    x = x + mm(o, w[f"{prefix}attn.wo"].reshape(h * hd, d))
    xn = _norm(m, w, f"{prefix}ln2.scale", x)
    if m["act"] != "silu":
        raise NotImplementedError(f"reference lm: act {m['act']!r}")
    hid = F.silu(mm(xn, w[f"{prefix}mlp.w_gate"])) * mm(xn, w[f"{prefix}mlp.w_up"])
    return x + mm(hid, w[f"{prefix}mlp.w_down"])


def ssd(x, a, b, c, chunk: int) -> torch.Tensor:
    """The scalar-decay state-space scan y_t = sum_{s<=t} exp(A_t - A_s)
    (c_t . b_s) x_s, A the running sum of ``a``, from a zero state, in its
    exact chunked form: every chunk's own part at once, then the states
    carried from chunk to chunk. x [B,T,H,P], a [B,T,H], b/c [B,T,N] ->
    y [B,T,H,P] float32."""
    bb, t, h, p = x.shape
    n = b.shape[-1]
    pad = -t % chunk
    x, a, b, c = (F.pad(v.float(), (0, 0) * (v.dim() - 2) + (0, pad))
                  for v in (x, a, b, c))
    nc = (t + pad) // chunk
    x = x.view(bb, nc, chunk, h, p)
    b, c = b.view(bb, nc, chunk, n), c.view(bb, nc, chunk, n)
    la = torch.cumsum(a.view(bb, nc, chunk, h), dim=2)         # [B,nc,C,H]
    keep = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]          # [B,nc,C,C,H]
    # the exponent is <= 0 where kept; the rest is selected away before
    # exp, so no inf meets a zero in the backward
    decay = torch.exp(torch.where(keep[:, :, None], diff,
                                  torch.full_like(diff, -float("inf"))))
    scores = torch.einsum("bctn,bcsn->bcts", c, b)[..., None] * decay
    y = torch.einsum("bctsh,bcshp->bcthp", scores, x)
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(la[:, :, -1:, :] - la)                   # [B,nc,C,H]
    own = torch.einsum("bcshp,bcsn,bcsh->bchpn", x, b, to_end)
    # the state entering each chunk, carried across the chunks
    states, state = [], x.new_zeros((bb, h, p, n))
    for k in range(nc):
        states.append(state)
        state = state * torch.exp(la[:, k, -1])[..., None, None] + own[:, k]
    entering = torch.stack(states, dim=1)                       # [B,nc,H,P,N]
    y = y + torch.einsum("bctn,bchpn,bcth->bcthp", c, entering, torch.exp(la))
    return y.reshape(bb, nc * chunk, h, p)[:, :t]


def mamba2_block(m: dict, w: Weights, prefix: str, x: torch.Tensor,
                 mm: MatMul) -> torch.Tensor:
    s = m["ssm"]
    n, hp, k = s["state_dim"], s["head_dim"], s["conv_kernel"]
    d_inner, heads, _ = _ssm_dims(m)
    xn = _norm(m, w, f"{prefix}ln.scale", x)
    z, xi, bi, ci, dt_raw = torch.split(
        mm(xn, w[f"{prefix}ssm.w_in"]), [d_inner, d_inner, n, n, heads], dim=-1)
    conv_w = w[f"{prefix}ssm.conv"].float()
    u = torch.cat([xi, bi, ci], dim=-1)
    up = F.pad(u, (0, 0, k - 1, 0))
    conv = sum(up[:, i:i + u.shape[1]] * conv_w[i] for i in range(k))
    xi, bi, ci = torch.split(F.silu(conv), [d_inner, n, n], dim=-1)
    dt = F.softplus(dt_raw + w[f"{prefix}ssm.dt_bias"].float())
    a = -torch.exp(w[f"{prefix}ssm.A_log"].float()) * dt
    xh = xi.reshape(*xi.shape[:-1], heads, hp)
    y = ssd(xh * dt[..., None], a, bi, ci, s["chunk"])
    y = y + w[f"{prefix}ssm.D"].float()[:, None] * xh
    y = y.reshape(*x.shape[:-1], d_inner) * F.silu(z)
    y = rms_norm(y, w[f"{prefix}ssm.norm_scale"])
    return x + mm(y, w[f"{prefix}ssm.w_out"])


def forward(m: dict, w: Weights, tokens: torch.Tensor,
            mm: MatMul = matmul) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] float32."""
    _check_supported(m)
    x = w["embed.table"][tokens.long()].float()
    if m["family"] == "dense":
        for i in range(m["n_layers"]):
            x = attention_block(m, w, f"layers.{i}.", x, mm)
    else:
        every = m["attn_every"]
        for i in range(m["n_layers"]):
            x = mamba2_block(m, w, f"layers.{i}.", x, mm)
            if every and (i + 1) % every == 0:
                x = attention_block(m, w, "shared_attn.", x, mm)
    x = _norm(m, w, "final_norm.scale", x)
    return mm(x, w["lm_head.kernel"])


def log_likelihood(m: dict, w: Weights, tokens: torch.Tensor,
                   labels: torch.Tensor, mm: MatMul = matmul) -> torch.Tensor:
    """Per-token ``log_softmax(logits)[label]`` [B, S] float32."""
    logp = torch.log_softmax(forward(m, w, tokens, mm), dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]

