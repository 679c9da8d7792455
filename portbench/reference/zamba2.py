"""Plain float32 reference of the published Zamba2 (Zyphra's Zamba2-7B-Instruct,
https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json; the
layer equations of ``transformers``' ``modeling_zamba2.py``), as a plain
function of the configuration file's ``model`` section and a dict of
weights by parameter name. No kernel, no cache, no batching tricks: every
product in float32 with TF32 off (``float32_exact``, from ``lm``), through
``matmul``, which the control of the benchmark's check swaps for a lower
precision (``control.fp8_matmul``). It imports nothing of the program.

With e the embedding and h = e, layer i of ``n_layers``:

    i the u-th of hybrid_layer_ids:  t = SharedBlock[u mod num_mem_blocks](h, e, u)
                                     h = h + Mamba_i(RMSNorm_i(h + Link_u(t)))
    any other layer:                 h = h + Mamba_i(RMSNorm_i(h))
    logits = RMSNorm_f(h) @ E^T

SharedBlock_b(h, e, u) = MLP_b,u(RMSNorm(Attn_b(RMSNorm(concat(h, e))))),
no residual: causal RoPE attention at softmax scale (head_dim / 2) ** -0.5,
out-projected to d_model; MLP gelu_erf(g) * p @ Wd with [g, p] = y @ [Wg,
Wu] + (y @ A_u) @ B_u. Mamba_i: [z, xBC, dt] = x @ W_in; xBC =
silu(causal depthwise conv(xBC) + bias) = [x, B (G x N), C (G x N)]; dt =
softplus(dt + dt_bias); A = -exp(A_log); y = SSD(x dt, A dt, B and C of
head h's group h // (H / G)) + D x; y = RMSNorm per group of d_inner / G
channels of (y * silu(z)); y @ W_out. Every RMSNorm at ``norm_eps``.

Departures from the published model, all of them also the program's:

- the weights are random from the seed (the benchmark's init rules), not
  the released checkpoint, and the output head is the tied embedding (the
  published config leaves ``tie_word_embeddings`` at its default, tied);
- the shared MLP's gate and up projections, published as one
  [d_model, 2 d_ff] matrix, are held as two matrices (the same products);
  the adapter's [rank, 2 d_ff] output keeps the published order, the gate's
  columns first;
- the SSD is the exact chunked scan of ``lm.ssd`` (one call per group of
  heads), at the published ``chunk_size``; its result does not depend on
  the chunk;
- dt is not clamped (``time_step_limit`` null: the range (0, inf)), and
  every position's logits are computed (``num_logits_to_keep`` is for
  generation).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.lm import float32_exact, matmul, rope, ssd

Weights = Dict[str, torch.Tensor]

__all__ = ["float32_exact", "matmul", "param_shapes", "forward",
           "log_likelihood"]


def _dims(m: dict) -> Tuple[int, int, int, int]:
    """(d_inner, heads, groups, conv width)."""
    s = m["ssm"]
    d_inner = s["expand"] * m["d_model"]
    groups = s["n_groups"]
    return d_inner, d_inner // s["head_dim"], groups, d_inner + 2 * groups * s["state_dim"]


def param_shapes(m: dict) -> List[Tuple[str, tuple]]:
    """Every parameter of the model, by name, in drawing order."""
    d, f, r, v = m["d_model"], m["d_ff"], m["adapter_rank"], m["vocab_size"]
    wide = 2 * d   # concat(h, embedding): the published attention_hidden_size
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    s = m["ssm"]
    d_inner, heads, _, conv = _dims(m)
    out = [("embed.table", (v, d))]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln.scale", (d,)),
                (p + "ssm.w_in", (d, d_inner + conv + heads)),
                (p + "ssm.w_out", (d_inner, d)),
                (p + "ssm.conv", (s["conv_kernel"], conv)),
                (p + "ssm.conv_bias", (conv,)),
                (p + "ssm.A_log", (heads,)), (p + "ssm.D", (heads,)),
                (p + "ssm.dt_bias", (heads,)),
                (p + "ssm.norm_scale", (d_inner,))]
    for b in range(m["num_mem_blocks"]):
        p = f"shared.{b}."
        out += [(p + "ln1.scale", (wide,)),
                (p + "attn.wq", (wide, h, hd)), (p + "attn.wk", (wide, kv, hd)),
                (p + "attn.wv", (wide, kv, hd)), (p + "attn.wo", (h, hd, d)),
                (p + "ln2.scale", (d,)),
                (p + "mlp.w_gate", (d, f)), (p + "mlp.w_up", (d, f)),
                (p + "mlp.w_down", (f, d))]
    for u in range(len(m["hybrid_layer_ids"])):
        p = f"uses.{u}."
        out += [(p + "adapter_in", (d, r)), (p + "adapter_out", (r, 2 * f)),
                (p + "link", (d, d))]
    return out + [("final_norm.scale", (d,))]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             groups: int = 1) -> torch.Tensor:
    """RMSNorm over each of ``groups`` equal groups of the last dim."""
    x = x.float()
    g = x.view(*x.shape[:-1], groups, -1)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + eps)
    return g.reshape(x.shape) * scale.float()


def attention(m: dict, w: Weights, p: str, x: torch.Tensor, mm) -> torch.Tensor:
    """Causal RoPE attention of the shared block, softmax scale
    (head_dim / 2) ** -0.5, kv heads shared by groups of q heads; the scores
    in float32, materialised whole."""
    b, s, wide = x.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(x, w[p + "attn.wq"].reshape(wide, h * hd)).view(b, s, h, hd)
    k = mm(x, w[p + "attn.wk"].reshape(wide, kv * hd)).view(b, s, kv, hd)
    v = mm(x, w[p + "attn.wv"].reshape(wide, kv * hd)).view(b, s, kv, hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    k, v = k.repeat_interleave(h // kv, dim=2), v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd / 2) ** -0.5
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return mm(o.reshape(b, s, h * hd), w[p + "attn.wo"].reshape(h * hd, -1))


def shared_block(m: dict, w: Weights, b: int, u: int, h: torch.Tensor,
                 e: torch.Tensor, mm) -> torch.Tensor:
    p, f, eps = f"shared.{b}.", m["d_ff"], m["norm_eps"]
    x = rms_norm(torch.cat([h, e], dim=-1), w[p + "ln1.scale"], eps)
    y = rms_norm(attention(m, w, p, x, mm), w[p + "ln2.scale"], eps)
    ad = mm(mm(y, w[f"uses.{u}.adapter_in"]), w[f"uses.{u}.adapter_out"])
    g = mm(y, w[p + "mlp.w_gate"]) + ad[..., :f]
    up = mm(y, w[p + "mlp.w_up"]) + ad[..., f:]
    return mm(F.gelu(g) * up, w[p + "mlp.w_down"])


def mamba2(m: dict, w: Weights, p: str, x: torch.Tensor, mm) -> torch.Tensor:
    s = m["ssm"]
    n, hp, k = s["state_dim"], s["head_dim"], s["conv_kernel"]
    d_inner, heads, groups, _ = _dims(m)
    z, xbc, dt_raw = torch.split(mm(x, w[p + "ssm.w_in"]),
                                 [d_inner, d_inner + 2 * groups * n, heads], dim=-1)
    conv_w = w[p + "ssm.conv"].float()
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, i:i + xbc.shape[1]] * conv_w[i] for i in range(k))
    xi, bi, ci = torch.split(F.silu(conv + w[p + "ssm.conv_bias"].float()),
                             [d_inner, groups * n, groups * n], dim=-1)
    dt = F.softplus(dt_raw + w[p + "ssm.dt_bias"].float())
    a = -torch.exp(w[p + "ssm.A_log"].float()) * dt
    xh = xi.reshape(*xi.shape[:-1], heads, hp)
    xdt = xh * dt[..., None]
    hg = heads // groups
    y = torch.cat([ssd(xdt[:, :, j * hg:(j + 1) * hg], a[:, :, j * hg:(j + 1) * hg],
                       bi[..., j * n:(j + 1) * n], ci[..., j * n:(j + 1) * n],
                       s["chunk"]) for j in range(groups)], dim=2)
    y = y + w[p + "ssm.D"].float()[:, None] * xh
    y = y.reshape(*x.shape[:-1], d_inner) * F.silu(z)
    y = rms_norm(y, w[p + "ssm.norm_scale"], m["norm_eps"], groups)
    return mm(y, w[p + "ssm.w_out"])


def forward(m: dict, w: Weights, tokens: torch.Tensor,
            mm=matmul) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] float32."""
    eps, blocks = m["norm_eps"], m["num_mem_blocks"]
    uses = {i: u for u, i in enumerate(m["hybrid_layer_ids"])}
    e = w["embed.table"][tokens.long()].float()
    h = e
    for i in range(m["n_layers"]):
        x = h
        if i in uses:
            u = uses[i]
            t = shared_block(m, w, u % blocks, u, h, e, mm)
            x = h + mm(t, w[f"uses.{u}.link"])
        h = h + mamba2(m, w, f"layers.{i}.",
                       rms_norm(x, w[f"layers.{i}.ln.scale"], eps), mm)
    h = rms_norm(h, w["final_norm.scale"], eps)
    return mm(h, w["embed.table"].T)


def log_likelihood(m: dict, w: Weights, tokens: torch.Tensor,
                   labels: torch.Tensor, mm=matmul) -> torch.Tensor:
    """Per-token ``log_softmax(logits)[label]`` [B, S] float32."""
    logp = torch.log_softmax(forward(m, w, tokens, mm), dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]
