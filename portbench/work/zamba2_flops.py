"""Closed-form model operations of the published Zamba2's forward
(``reference/zamba2.py``) over ``batch`` sequences of ``length`` tokens, in
the form of ``lm_flops.py``: 2 operations a weight a token for every
product (the Mamba layers' in- and out-projections; each use of a shared
block's q, k, v, out, gate, up and down products, its adapter and its
link; the tied output head; the embedding lookup is none), the attention
products over the pairs the causal mask keeps at each use, and the
chunked SSD's work with B and C in groups (``ssd.ssd_work``). Norms,
activations and the convolution are not counted."""

from __future__ import annotations

from portbench.work.flash import pairs
from portbench.work.ssd import ssd_work


def _use_weights(m: dict) -> int:
    """The weights one use of a shared block multiplies a token by: the
    block's own and the use's adapter and link."""
    d, f, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    wide = 2 * d   # concat(h, embedding)
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return (wide * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
            + d * r + r * 2 * f + d * d)


def forward_flops(m: dict, batch: int, length: int) -> int:
    d, s = m["d_model"], m["ssm"]
    tokens = batch * length
    d_inner = s["expand"] * d
    heads = d_inner // s["head_dim"]
    groups = s["n_groups"]
    in_dim = 2 * d_inner + 2 * groups * s["state_dim"] + heads
    prods, rest, exps, _ = ssd_work(batch, heads, length, s["head_dim"],
                                    s["state_dim"], s["chunk"], groups=groups)
    mamba = 2 * tokens * (d * in_dim + d_inner * d) + prods + rest + exps
    attn = 4 * batch * m["n_heads"] * m["head_dim"] * pairs(length, length, True)
    uses = len(m["hybrid_layer_ids"])
    return (m["n_layers"] * mamba + uses * (2 * tokens * _use_weights(m) + attn)
            + 2 * tokens * d * m["vocab_size"])
