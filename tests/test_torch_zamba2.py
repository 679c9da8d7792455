"""The published Zamba2 in the port (``models/zamba2.py``), on the CPU at the
configuration's ``smoke`` size: its forward against the benchmark's plain
float32 reference (``portbench/reference/zamba2.py``) on the same seeded
weights, tight enough that each of seven wrong variants of the model fails
it; decode through the cache against the forward; the grouped SSD's plain
versions against per-group calls and, at one group, bit for bit against
their ungrouped form; the softmax scale through the attention paths; the
config type and the parameter structure at the published size."""

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from portbench.harness import program
from portbench.reference import zamba2 as ref
from repro_torch.kernels import ops, ref as kref
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import build_model
from repro_torch.models import mamba2 as m2
from repro_torch.models import zamba2 as z

DOC = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                  / "zamba2_7b.json").read_text())
SEED = 2**31 + 5
T = 128   # two of the smoke size's 64-step SSD chunks
# Both sides compute in float32 on the CPU, in other orders (the SSD's
# chunks, the attention's scale before or after the product): the logits
# agree to 2.3e-6 (0 on the plain paths) through the 5 smoke layers. 1e-4
# leaves 40x room for that and lies 4.7x under the nearest wrong variant's
# gap (tanh GELU, 4.7e-4; the others 0.048 to 0.92).
TOL = 1e-4


def _section(kernels: bool) -> dict:
    return {**DOC["model"], **DOC["smoke"], "param_dtype": "float32",
            "compute_dtype": "float32", "use_kernels": kernels}


def _tokens(m, n=T, rows=2):
    return torch.randint(0, m["vocab_size"], (rows, n),
                         generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def want():
    m = _section(False)
    _, w = program.reference_weights(m, ref, SEED, "cpu", DOC["init_rules"])
    with torch.no_grad(), ref.float32_exact():
        return ref.forward(m, w, _tokens(m))


def _port(kernels: bool):
    m = _section(kernels)
    model, params, _, _ = program.build(m, ref, SEED, "cpu", False,
                                        DOC["init_rules"])
    return model, params, _tokens(m)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_forward_is_the_reference(want, kernels):
    model, params, toks = _port(kernels)
    assert type(model.cfg) is z.Zamba2Config and model.cfg.ssm_groups == 2
    with torch.no_grad():
        got, aux = model.forward(params, toks)
    assert float(aux) == 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


_real_mamba_layer = z._mamba_layer
_real_conv = m2._conv


def _one_group(cfg, p, xbc, groups, cd, conv_state=None):
    """The conv's split with group 0's B and C for every head."""
    xi, bi, ci, st = _real_conv(cfg, p, xbc, groups, cd, conv_state)
    return xi, bi[..., 0, :], ci[..., 0, :], st


def _no_bias(cfg, p, xbc, groups, cd, conv_state=None):
    """The conv without its bias."""
    return _real_conv(cfg, {k: v for k, v in p.items() if k != "conv_bias"},
                      xbc, groups, cd, conv_state)


WRONG = {
    "tanh_gelu": ("_gelu", lambda x: F.gelu(x, approximate="tanh"), {}),
    "scale_d": ("_softmax_scale", lambda cfg: cfg.resolved_head_dim ** -0.5, {}),
    "link_in_residual": ("_mamba_layer", lambda cfg, lp, h, x, cache=None:
                         _real_mamba_layer(cfg, lp, x, x, cache), {}),
    "blocks_not_alternating": (None, None, {"num_mem_blocks": 1}),
    "one_group": ("_conv", _one_group, {}),
    "no_conv_bias": ("_conv", _no_bias, {}),
    "eps_1e-6": (None, None, {"norm_eps": 1e-6}),
}


@pytest.mark.parametrize("variant", sorted(WRONG))
def test_each_wrong_variant_fails_the_tolerance(want, variant, monkeypatch):
    name, fn, over = WRONG[variant]
    if name is not None:
        monkeypatch.setattr(m2 if name == "_conv" else z, name, fn)
    model, params, toks = _port(False)
    cfg = dataclasses.replace(model.cfg, **over)
    with torch.no_grad():
        got, _ = z.zamba2_forward(cfg, params, toks)
    assert (got - want).abs().max().item() > 3 * TOL, variant


def test_decode_through_the_cache_is_the_forward():
    # The prompt's decode steps (the port's prefill), then further tokens:
    # every position's logits as the full forward's, in float32.
    model, params, toks = _port(False)
    toks = toks[:, :40]
    with torch.no_grad():
        full, _ = model.forward(params, toks)
        cache = model.init_cache(toks.shape[0], toks.shape[1])
        steps = [model.decode_step(params, cache, toks[:, i:i + 1], i)[0]
                 for i in range(toks.shape[1])]
    assert cache["shared"]["k"].shape[0] == len(model.cfg.hybrid_layer_ids)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=0, atol=TOL)


def _options(cfg):
    """(B and C groups, whether a Mamba layer has a conv bias, RMSNorm eps)."""
    names = {n for n, _ in build_model(cfg, "meta").init(
        torch.Generator()).named_parameters()}
    return (m2._groups(cfg), any(n.endswith("conv_bias") for n in names),
            L.norm_eps(cfg))


def test_the_hybrid_keeps_its_options():
    from repro_torch.configs import get_config

    assert _options(get_config("zamba2_1p2b", smoke=True)) == (1, False, 1e-6)
    cfg = program.model_config({**DOC["model"], **DOC["smoke"]})
    assert _options(cfg) == (2, True, 1e-5)


def test_config_type_reads_the_published_section():
    cfg = program.model_config(DOC["model"])
    assert type(cfg) is z.Zamba2Config
    assert (cfg.ssm_groups, cfg.conv_bias, cfg.num_mem_blocks) == (2, True, 2)
    assert cfg.hybrid_layer_ids == tuple(DOC["hybrid_layer_ids"])
    assert (cfg.adapter_rank, cfg.norm_eps) == (128, 1e-5)
    assert cfg.tie_embeddings and cfg.resolved_head_dim == 224
    assert not hasattr(cfg.ssm, "n_groups") and cfg.ssm.chunk == 256


def test_published_structure_is_the_references():
    m = DOC["model"]
    params = build_model(program.model_config(m), "meta").init(torch.Generator())
    have = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert have == dict(ref.param_shapes(m))
    assert sum(math.prod(s) for s in have.values()) == 7_356_749_648
    assert have["layers.0.ssm.w_in"] == (3584, 7168 + 7424 + 112)
    assert have["shared.1.attn.wq"] == (7168, 32, 224)
    assert have["uses.12.adapter_out"] == (128, 2 * 14336)


@pytest.mark.parametrize("arch,eps", [("phi3_mini_3p8b", 1e-6),
                                      ("zamba2_1p2b", 1e-6), ("zamba2_7b", 1e-5)])
def test_norm_takes_the_configs_eps(arch, eps):
    # One RMSNorm for every family: the published Zamba2's at its norm_eps,
    # the others at 1e-6 as before, bit for bit.
    from repro_torch.configs import get_config

    cfg = (program.model_config({**DOC["model"], **DOC["smoke"]})
           if arch == "zamba2_7b" else get_config(arch, smoke=True))
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator().manual_seed(4)) * 1e-3
    p = {"scale": torch.rand(cfg.d_model, generator=torch.Generator().manual_seed(5))}
    want = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]
    assert torch.equal(L.norm(cfg, p, x), want)


# ---- the grouped SSD's plain versions ---------------------------------------

def _ssd_inputs(b=2, t=64, h=6, p=8, n=4, g=2):
    gen = torch.Generator().manual_seed(t + h)
    x = torch.randn(b, t, h, p, generator=gen)
    a = -torch.rand(b, t, h, generator=gen)
    bm = torch.randn(b, t, g, n, generator=gen)
    cm = torch.randn(b, t, g, n, generator=gen)
    return x, a, bm, cm


def test_grouped_chunked_ssd_is_a_call_per_group():
    x, a, bm, cm = _ssd_inputs()
    s0 = torch.zeros(2, 6, 8, 4)
    y, st = m2.ssd_chunked(x, a, bm, cm, s0, 16)
    for g in range(2):
        hs = slice(3 * g, 3 * g + 3)
        yg, sg = m2.ssd_chunked(x[:, :, hs], a[:, :, hs], bm[:, :, g],
                                cm[:, :, g], s0[:, hs], 16)
        assert torch.equal(y[:, :, hs], yg) and torch.equal(st[:, hs], sg)
    # the groups differ: one group's b and c for every head is another function
    y1, _ = m2.ssd_chunked(x, a, bm[:, :, 0], cm[:, :, 0], s0, 16)
    assert not torch.allclose(y1[:, :, 3:], y[:, :, 3:], atol=1e-3)


def test_one_group_is_bit_for_bit_the_ungrouped_ssd():
    x, a, bm, cm = _ssd_inputs(g=1)
    s0 = torch.zeros(2, 6, 8, 4)
    for got, want in zip(m2.ssd_chunked(x, a, bm, cm, s0, 16),
                         m2.ssd_chunked(x, a, bm[:, :, 0], cm[:, :, 0], s0, 16)):
        assert torch.equal(got, want)
    xt, at = x.transpose(1, 2), a.transpose(1, 2)
    assert torch.equal(kref.ssd_ref(xt, at, bm, cm),
                       kref.ssd_ref(xt, at, bm[:, :, 0], cm[:, :, 0]))
    assert torch.equal(ops.ssd(x, a, bm, cm), ops.ssd(x, a, bm[:, :, 0], cm[:, :, 0]))


def test_grouped_oracle_step_and_chunked_forms_agree():
    x, a, bm, cm = _ssd_inputs(t=40)
    y, st = m2.ssd_chunked(x, a, bm, cm, torch.zeros(2, 6, 8, 4), 8)
    oracle = ops.ssd(x, a, bm, cm)
    state, steps = torch.zeros(2, 6, 8, 4), []
    for i in range(x.shape[1]):
        yi, state = m2.ssd_step(x[:, i], a[:, i], bm[:, i], cm[:, i], state)
        steps.append(yi)
    torch.testing.assert_close(oracle, y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.stack(steps, 1), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, st, rtol=1e-5, atol=1e-5)


def test_groups_that_do_not_divide_the_heads_are_refused():
    x, a, bm, cm = _ssd_inputs(h=5)
    with pytest.raises(ValueError, match="G dividing 5 heads"):
        ops.ssd(x, a, bm, cm)


# ---- the softmax scale ------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_every_attention_path_applies_the_scale(causal):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 16, 4, 8, generator=gen) for _ in range(3))
    scale = 4 ** -0.5            # (8 / 2) ** -0.5, not 8 ** -0.5
    flash = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    full = attn.attention_full(q, k, v, causal=causal, scale=scale)
    chunked = attn.attention_chunked(q, k, v, causal=causal, chunk_q=8,
                                     chunk_k=4, scale=scale)
    torch.testing.assert_close(flash, full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=1e-5)
    # the default stays D ** -0.5, bit for bit
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal),
                       ops.flash_attention(q, k, v, causal=causal,
                                           scale=8 ** -0.5))
    assert not torch.allclose(flash, ops.flash_attention(q, k, v, causal=causal))
