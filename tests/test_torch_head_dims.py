"""The two families whose attention runs at the head sizes the wgmma flash
design gained last, at their real head_dim and narrow widths: phi3_mini at
head_dim 96 (32 heads of 96 at full width) and paligemma's text forward
at head_dim 256 (8 heads of 256 over one kv head), each the SMOKE config
(two layers, d_model 64) with its full-width head_dim.

Each is held against the JAX package's ``lm_forward`` in float32 at 1e-4,
with ``use_kernels`` both ways (the JAX side through its interpret-mode
Pallas flash kernel, as tests/test_kernels.py runs it; the port's wrapper
takes the plain version for CPU tensors), with the reference's parameters
carried across by ``repro_torch.models.convert``. Decode is held against
teacher forcing at the reference's bar (tests/test_models.py:117-123) in
bf16 and against the reference's decode step in float32. The bf16 forward
hands every layer's attention to the flash wrapper in a layout the wgmma
design takes (``fa.wgmma_eligible``), which is what sends it there on the
card (``chip_smoke.py`` counts those launches at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

F32_TOL = 1e-4
BF16_TOL = 0.15
F32 = dict(param_dtype="float32", compute_dtype="float32")
# (arch, the full-width config's head_dim); paligemma runs text only.
CASES = [pytest.param("phi3_mini_3p8b", 96, id="phi3-d96"),
         pytest.param("paligemma_3b", 256, id="paligemma-text-d256")]
B, S = 2, 32


def _cfgs(arch, d, **kw):
    return tuple(mod.get_config(arch, smoke=True).replace(head_dim=d, **kw)
                 for mod in (jconfigs, configs))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _agree(got, want):
    return (np.argmax(_np(got), -1) == np.argmax(_np(want), -1)).mean()


@pytest.fixture(scope="module")
def jparams():
    """Each case's reference parameters (float32), made on first use."""
    cache = {}

    def get(arch, d):
        if (arch, d) not in cache:
            jcfg, _ = _cfgs(arch, d, **F32)
            cache[arch, d] = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        return cache[arch, d]
    return get


def _port(tcfg, tree):
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, tree))


def test_cases_take_the_full_width_head_dims():
    for arch, d in (p.values for p in CASES):
        assert configs.get_config(arch).head_dim == d
        assert d in fa.WGMMA_HEAD_DIMS
        cfg = configs.get_config(arch, smoke=True).replace(head_dim=d)
        assert cfg.resolved_head_dim == d


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch,d", CASES)
def test_forward_matches_reference_f32(rng, jparams, arch, d, use_kernels):
    jcfg, tcfg = _cfgs(arch, d, use_kernels=use_kernels, **F32)
    jp = jparams(arch, d)
    toks = rng.integers(0, tcfg.vocab_size, (B, S))
    want, _ = jlm.lm_forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = build_model(tcfg, "cpu").forward(_port(tcfg, jp),
                                                  torch.from_numpy(toks))
    assert got.shape == (B, S, tcfg.vocab_size)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("arch,d", CASES)
def test_kernel_forward_hands_every_layer_to_the_wgmma_design(
        monkeypatch, rng, jparams, arch, d):
    # bf16 as served: each layer's attention reaches the flash wrapper once,
    # in the model layout (views, no copy), in a layout and head size the
    # wgmma design takes; and the forward equals the plain one, since the
    # wrapper's CPU path is the plain attention.
    _, tcfg = _cfgs(arch, d)
    tp = _port(tcfg, jparams(arch, d))
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, S)))
    calls = []
    bhsd = ops.flash_attention_bhsd

    def record(q, k, v, *, causal=True, scale=None):
        calls.append((q.shape, k.shape, causal, fa.wgmma_eligible(q, k, v)))
        assert scale is None   # these models keep the default D ** -0.5
        return bhsd(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(ops, "flash_attention_bhsd", record)
    with torch.no_grad():
        got, _ = build_model(tcfg.replace(use_kernels=True), "cpu").forward(tp, toks)
        plain, _ = build_model(tcfg, "cpu").forward(tp, toks)
    want = (torch.Size([B, tcfg.n_heads, S, d]),
            torch.Size([B, tcfg.n_kv_heads, S, d]), True, True)
    assert calls == [want] * tcfg.n_layers
    _close(got, plain, 1e-6)


@pytest.mark.parametrize("arch,d", CASES)
def test_decode_matches_teacher_forcing(rng, jparams, arch, d):
    """The port's one-token decode over a forced stream against its own
    teacher-forced forward in bf16 compute (the reference's bar), and in
    float32 against the reference's decode step (1e-4)."""
    s = 16
    toks = rng.integers(0, 512, (B, s))
    jp = jparams(arch, d)
    for kw, tol in ((F32, F32_TOL), ({}, BF16_TOL)):
        jcfg, tcfg = _cfgs(arch, d, **kw)
        tp = _port(tcfg, jp)
        tmodel = build_model(tcfg, "cpu")
        cache = tmodel.init_cache(B, s)
        got = []
        with torch.no_grad():
            for t in range(s):
                logits, cache = tmodel.decode_step(
                    tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
                got.append(logits[:, 0])
            forced, _ = tmodel.forward(tp, torch.from_numpy(toks))
        got = torch.stack(got, dim=1)
        _close(got, forced, tol)
        assert _agree(got, forced) > 0.9, (arch, kw)
        if kw is F32:
            jmodel = jbuild_model(jcfg)
            jcache, want = jmodel.init_cache(B, s), []
            jstep = jax.jit(jmodel.decode_step)
            for t in range(s):
                lj, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(t))
                want.append(np.asarray(lj[:, 0]))
            _close(got, np.stack(want, axis=1), F32_TOL)
