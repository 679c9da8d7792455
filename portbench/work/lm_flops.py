"""Closed-form model operations of a decoder-only forward (dense and the
Zamba2 hybrid) over ``batch`` sequences of ``length`` tokens: 2 operations
a weight a token for every projection (the embedding lookup is none), the
attention products over the pairs the causal mask keeps, and the chunked
SSD's work. Norms, activations and the convolution are not counted. A
train step is 3 forwards (the backward twice the forward); recomputation
under remat is not counted, so the share is of model, not hardware,
operations."""

from __future__ import annotations

from portbench.work.flash import pairs
from portbench.work.ssd import ssd_work


def _attn_block_weights(m: dict) -> int:
    d, f = m["d_model"], m["d_ff"]
    hd = m["head_dim"] or d // m["n_heads"]
    return d * (m["n_heads"] + 2 * m["n_kv_heads"]) * hd + m["n_heads"] * hd * d + 3 * d * f


def forward_flops(m: dict, batch: int, length: int) -> int:
    d = m["d_model"]
    hd = m["head_dim"] or d // m["n_heads"]
    tokens = batch * length
    attn = 4 * batch * m["n_heads"] * hd * pairs(length, length, True)
    if m["family"] == "dense":
        return m["n_layers"] * (2 * tokens * _attn_block_weights(m) + attn) \
            + 2 * tokens * d * m["vocab_size"]
    if m["family"] != "hybrid":
        raise NotImplementedError(m["family"])
    s = m["ssm"]
    d_inner = s["expand"] * d
    heads = d_inner // s["head_dim"]
    groups = s.get("n_groups", 1)
    in_dim = 2 * d_inner + 2 * groups * s["state_dim"] + heads
    prods, rest, exps, _ = ssd_work(batch, heads, length, s["head_dim"],
                                    s["state_dim"], s["chunk"], groups=groups)
    mamba = 2 * tokens * (d * in_dim + d_inner * d) + prods + rest + exps
    shared = m["n_layers"] // m["attn_every"] if m["attn_every"] else 0
    return (m["n_layers"] * mamba
            + shared * (2 * tokens * _attn_block_weights(m) + attn)
            + 2 * tokens * d * m["vocab_size"])


def train_step_flops(m: dict, batch: int, length: int) -> int:
    return 3 * forward_flops(m, batch, length)
