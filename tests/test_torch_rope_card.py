"""The RoPE kernel (``repro_torch.kernels.rope``, ``csrc/rope.cu``) on the
card: bit for bit ``apply_rope`` on every case, in f32 and bf16, one launch
a call; what it refuses, before any launch; and one launch a layer in a
phi3_mini_3p8b forward at full width and depth. Skips where there is no
card; run on the card: ``python -m pytest -m card tests/test_torch_rope_card.py``.

``CASES`` are the CPU tests' cases too (``tests/test_torch_kernels.py``),
so this file imports no JAX."""

import pytest
import torch

from repro_torch.kernels import ops, rope
from repro_torch.models.layers import apply_rope

B, S, THETA = 2, 17, 10_000.0
HEADS = {"mha": (4, 4), "gqa": (8, 2), "mqa": (8, 1)}
# (head_dim, heads, positions): S tokens at positions [1, S] shared by the
# rows or [B, S] of their own, and a decode step (S = 1) at position 8191.
CASES = [(d, heads, pos) for d in (64, 96, 128, 256) for heads in HEADS
         for pos in ("shared", "rows", "decode")]


def case_inputs(d, heads, pos, dtype, device="cpu"):
    """Seeded q [B, S, H, d], k [B, S, Kv, d] and positions of one case."""
    h, kv = HEADS[heads]
    s = 1 if pos == "decode" else S
    g = torch.Generator().manual_seed(d * 100 + h * 10 + kv)
    q = torch.randn((B, s, h, d), generator=g).to(dtype)
    k = torch.randn((B, s, kv, d), generator=g).to(dtype)
    if pos == "shared":
        p = torch.arange(s)[None, :]
    elif pos == "rows":
        p = torch.arange(s)[None, :] + torch.tensor([[3], [1000]])
    else:
        p = torch.full((B, 1), 8191)
    return q.to(device), k.to(device), p.to(device)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card: python -m pytest -m "
                    "card tests/test_torch_rope_card.py")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,pos", CASES)
def test_kernel_is_apply_rope_bit_for_bit(card, d, heads, pos, dtype):
    q, k, p = case_inputs(d, heads, pos, dtype, card)
    before = rope.launches
    got_q, got_k = ops.rope(q, k, p, THETA)
    torch.cuda.synchronize()
    assert rope.launches == before + 1
    assert got_q.dtype == dtype and got_k.dtype == dtype
    assert torch.equal(got_q, apply_rope(q, p, THETA))
    assert torch.equal(got_k, apply_rope(k, p, THETA))


@pytest.mark.card
@pytest.mark.parametrize("bad", ["odd_d", "float16", "not_contiguous"])
def test_kernel_refuses_before_any_launch(card, bad):
    q, k, p = case_inputs(64, "gqa", "shared", torch.bfloat16, card)
    if bad == "odd_d":
        q, k = q[..., :63].contiguous(), k[..., :63].contiguous()
    elif bad == "float16":
        q, k = q.half(), k.half()
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = rope.launches
    with pytest.raises(ValueError):
        rope.rope_cuda(q, k, p, THETA)
    assert rope.launches == before


@pytest.mark.card
def test_phi3_forward_launches_once_a_layer(card):
    from torch import nn

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("phi3_mini_3p8b").replace(param_dtype="bfloat16",
                                               use_kernels=True)
    params = build_model(cfg, "meta").init(torch.Generator())
    g = torch.Generator(device=card).manual_seed(0)
    for name, p in list(params.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        params.get_submodule(mod)[leaf] = nn.Parameter(
            0.02 * torch.randn(p.shape, generator=g, device=card,
                               dtype=p.dtype), requires_grad=False)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    before = rope.launches
    with torch.no_grad():
        logits, _ = build_model(cfg, card).forward(params, toks)
    torch.cuda.synchronize()
    assert rope.launches - before == cfg.n_layers == 32
    assert torch.isfinite(logits).all()
