"""The published Zamba2's kernel paths on the card: flash attention at
head_dim 224 (the wgmma design's instance) against its plain version at
Zamba2's softmax scale, causal and not; the grouped tensor-core SSD against
its oracle at the cell's shape, and bit for bit against a call per group;
and one forward of Zamba2-7B-Instruct at its published width and depth,
its launches counted (ssd, conv, flash and RoPE). Skips where there is no
card; run on the card: ``PYTHONPATH=src python -m pytest -m card
tests/test_torch_zamba2_card.py``.

This file imports no JAX."""

import json
from pathlib import Path

import pytest
import torch

from card_holds import card  # noqa: F401
from repro_torch.kernels import conv
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rope
from repro_torch.kernels import ssd as ssd_k

ROOT = Path(__file__).resolve().parents[1]
SCALE = 112 ** -0.5      # (224 / 2) ** -0.5
TOL = 2e-2               # bf16: tests/test_kernels.py:70-71
KTOL = 1e-3              # f32 on 3xTF32: tests/test_kernels.py:108-111


def _qkv(card, b, h, kv, s, d=224, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn((b, s, n, d), generator=gen, device=card).to(torch.bfloat16)
            for n in (h, kv, kv)]


@pytest.mark.card
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kv,s", [(1, 8, 2, 300), (2, 8, 8, 1000),
                                      (4, 32, 32, 4096)])
def test_flash_224_is_the_plain_version(card, b, h, kv, s, causal):
    q, k, v = _qkv(card, b, h, kv, s)
    before = (fa.launches, fa.wgmma_launches)
    got = ops.flash_attention(q, k, v, causal=causal, scale=SCALE)
    torch.cuda.synchronize()
    assert (fa.launches, fa.wgmma_launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=causal,
                                    scale=SCALE).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)
    default = ops.flash_attention(q, k, v, causal=causal)
    assert (default.float() - got.float()).abs().max().item() > TOL


def _ssd_inputs(card, b=4, t=4096, h=112, g=2, seed=1):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((b, t, h, 64), generator=gen, device=card)
    a = -torch.rand((b, t, h), generator=gen, device=card) * 0.5
    bm = torch.randn((b, t, g, 64), generator=gen, device=card) * 0.3
    cm = torch.randn((b, t, g, 64), generator=gen, device=card) * 0.3
    return x, a, bm, cm


@pytest.mark.card
def test_grouped_ssd_tensor_cores_match_the_oracle(card):
    x, a, bm, cm = _ssd_inputs(card)
    before = (ssd_k.launches, ssd_k.tc_launches)
    got = ops.ssd(x, a, bm, cm, chunk=256)
    torch.cuda.synchronize()
    assert (ssd_k.launches, ssd_k.tc_launches) == (before[0] + 1, before[1] + 1)
    want = kref.ssd_ref(x.transpose(1, 2), a.transpose(1, 2), bm, cm).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=KTOL, atol=KTOL)
    # each head pair reads its own group: the same bits as a call per group
    for g in range(2):
        hs = slice(56 * g, 56 * (g + 1))
        one = ops.ssd(x[:, :, hs], a[:, :, hs], bm[:, :, g], cm[:, :, g], chunk=256)
        assert torch.equal(one, got[:, :, hs]), g


@pytest.mark.card
def test_odd_heads_a_group_run_the_first_design_a_group_at_a_time(card):
    x, a, bm, cm = _ssd_inputs(card, b=1, t=300, h=6, g=2)
    assert not ssd_k.tc_eligible(x.transpose(1, 2), bm)
    before = (ssd_k.launches, ssd_k.tc_launches)
    got = ops.ssd(x, a, bm, cm, chunk=64)
    torch.cuda.synchronize()
    assert (ssd_k.launches, ssd_k.tc_launches) == (before[0] + 2, before[1])
    want = kref.ssd_ref(x.transpose(1, 2), a.transpose(1, 2), bm, cm).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=KTOL, atol=KTOL)


@pytest.mark.card
def test_published_forward_launches_each_kernel_as_counted(card):
    from portbench.harness import program
    from portbench.reference import zamba2 as ref

    doc = json.loads((ROOT / "portbench" / "configs" / "zamba2_7b.json").read_text())
    m = {**doc["model"], **doc["serve"]}
    model, params, flat, _ = program.build(m, ref, 2**31 + 7, card, False,
                                           doc["init_rules"])
    toks = torch.randint(0, m["vocab_size"], (2, 1024), device=card,
                         generator=torch.Generator(device=card).manual_seed(2))
    fa.launches = fa.wgmma_launches = 0
    ssd_k.launches = ssd_k.tc_launches = 0
    rope.launches = conv.launches = 0
    with torch.no_grad():
        logits, _ = model.forward(params, toks)
    torch.cuda.synchronize()
    assert (ssd_k.tc_launches, ssd_k.launches) == (81, 81)
    assert (fa.wgmma_launches, fa.launches) == (13, 13)   # none on the CUDA cores
    assert rope.launches == 13
    assert conv.launches == m["n_layers"] == 81   # one a Mamba layer
    assert logits.shape == (2, 1024, 32000) and torch.isfinite(logits).all()
    del model, params, flat, logits
    torch.cuda.empty_cache()
