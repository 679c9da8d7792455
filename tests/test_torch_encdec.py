"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper_large_v3
SMOKE) and its pieces (sinusoidal positions, cross-attention, the cross K/V
cache), held against the JAX package on the same numpy inputs, with the
reference's parameters carried across by ``repro_torch.models.convert``.

In float32 the bar is 1e-4 (only the summation order differs); decode
against teacher forcing is held as the reference holds it
(tests/test_models.py:126-150): greedy agreement above 0.9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import encdec as jed
from repro.models import layers as jL
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import encdec as ed
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy

F32_TOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCH = "whisper_large_v3"


def _cfgs(**kw):
    return (jget_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs(**F32)
    return jbuild_model(jcfg).init(jax.random.PRNGKey(3))


def _port(tcfg, jparams):
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))


def _frames(cfg, rng, b=2):
    return rng.normal(size=(b, cfg.frontend.n_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("n,dim", [(24, 64), (1500, 1280), (7, 6)])
def test_sinusoidal_positions(n, dim):
    _close(L.sinusoidal_positions(n, dim), jL.sinusoidal_positions(n, dim))


def _attn_params(rng, d=64, h=4, kv=2, hd=16):
    p = {"wq": rng.normal(size=(d, h, hd)) * 0.1,
         "wk": rng.normal(size=(d, kv, hd)) * 0.1,
         "wv": rng.normal(size=(d, kv, hd)) * 0.1,
         "wo": rng.normal(size=(h, hd, d)) * 0.1,
         "q_norm": 1 + 0.1 * rng.normal(size=(hd,)),
         "k_norm": 1 + 0.1 * rng.normal(size=(hd,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention(rng, use_kernels, qk_norm):
    """Decoder queries [2, 10] over encoder states [2, 24]: with kernels
    both sides run flash attention non-causal with Sq != Sk."""
    jcfg, tcfg = _cfgs(use_kernels=use_kernels, qk_norm=qk_norm, **F32)
    jp, tp = _attn_params(rng)
    x = rng.normal(size=(2, 10, 64)).astype(np.float32)
    enc = rng.normal(size=(2, 24, 64)).astype(np.float32)
    want = jattn.cross_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(enc))
    got = attn.cross_attention(tcfg, tp, _t(x), _t(enc))
    _close(got, want)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_decode_cross_attention(rng, qk_norm):
    jcfg, tcfg = _cfgs(qk_norm=qk_norm, **F32)
    jp, tp = _attn_params(rng)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    xk = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    xv = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    want = jattn.decode_cross_attention(jcfg, jp, jnp.asarray(x),
                                        {"xk": jnp.asarray(xk), "xv": jnp.asarray(xv)})
    got = attn.decode_cross_attention(tcfg, tp, _t(x), {"xk": _t(xk), "xv": _t(xv)})
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_encode(rng, jparams, use_kernels):
    jcfg, tcfg = _cfgs(use_kernels=use_kernels, **F32)
    frames = _frames(tcfg, rng)
    want = jed.encode(jcfg, jparams, jnp.asarray(frames))
    with torch.no_grad():
        got = ed.encode(tcfg, _port(tcfg, jparams), _t(frames))
    assert got.shape == (2, tcfg.frontend.n_tokens, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_train_and_loss(rng, jparams, use_kernels):
    jcfg, tcfg = _cfgs(use_kernels=use_kernels, **F32)
    tp = _port(tcfg, jparams)
    frames = _frames(tcfg, rng)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12))
    labels = rng.integers(0, tcfg.vocab_size, (2, 12))
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    enc = jed.encode(jcfg, jparams, jnp.asarray(frames))
    want = jed.decode_train(jcfg, jparams, jnp.asarray(toks), enc)
    want_loss, wm = jed.encdec_loss(jcfg, jparams, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
        "labels": jnp.asarray(labels), "mask": jnp.asarray(mask)})
    with torch.no_grad():
        got = ed.decode_train(tcfg, tp, torch.from_numpy(toks),
                              ed.encode(tcfg, tp, _t(frames)))
        loss, gm = ed.encdec_loss(tcfg, tp, {
            "frames": _t(frames), "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels), "mask": _t(mask)})
    _close(got, want)
    _close(loss, want_loss)
    assert float(gm["tokens"]) == float(wm["tokens"])
    assert float(gm["aux"]) == 0.0


def test_prefill_cross_cache_and_cache_layout(rng, jparams):
    jcfg, tcfg = _cfgs(**F32)
    tp = _port(tcfg, jparams)
    enc = rng.normal(size=(2, tcfg.frontend.n_tokens, tcfg.d_model)).astype(np.float32)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg, "cpu")
    jcache = jmodel.init_cache(2, 9)
    tcache = tmodel.init_cache(2, 9)
    assert {k: tuple(v.shape) for k, v in tcache["layers"].items()} == {
        k: tuple(v.shape) for k, v in jcache["layers"].items()}
    want = jed.prefill_cross_cache(jcfg, jparams, jcache, jnp.asarray(enc))
    got = ed.prefill_cross_cache(tcfg, tp, tcache, _t(enc))
    for name in ("xk", "xv", "k", "v"):
        _close(got["layers"][name], want["layers"][name])
    assert float(got["layers"]["xk"].abs().max()) > 0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_encdec_decode_matches_teacher_forcing(rng, jparams, precision):
    """tests/test_models.py:126-150 on the port (agreement above 0.9 with
    its own teacher-forced decoder), and in f32 each decode step against
    the reference's at 1e-4."""
    jcfg, tcfg = _cfgs(**(F32 if precision == "f32" else {}))
    tp = _port(tcfg, jparams)
    b, s = 2, 12
    toks = rng.integers(0, tcfg.vocab_size, (b, s))
    frames = _frames(tcfg, rng, b)
    tmodel = build_model(tcfg, "cpu")
    got = []
    with torch.no_grad():
        enc = ed.encode(tcfg, tp, _t(frames))
        ref, _ = tmodel.forward(tp, torch.from_numpy(toks), _t(frames))
        cache = ed.prefill_cross_cache(tcfg, tp, tmodel.init_cache(b, s), enc)
        for t in range(s):
            logits, cache = tmodel.decode_step(tp, cache,
                                               torch.from_numpy(toks[:, t:t + 1]), t)
            got.append(logits[:, 0])
    got = torch.stack(got, dim=1)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert agree > 0.9, agree
    if precision == "f32":
        _close(got, ref)
        jmodel = jbuild_model(jcfg)
        jenc = jed.encode(jcfg, jparams, jnp.asarray(frames))
        jcache = jed.prefill_cross_cache(jcfg, jparams, jmodel.init_cache(b, s), jenc)
        jstep, want = jax.jit(jmodel.decode_step), []
        for t in range(s):
            lj, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
            want.append(np.asarray(lj[:, 0]))
        _close(got, np.stack(want, axis=1))


def test_serve_frames_follow_the_prompts_draw():
    """The served frames are the reference driver's: the draw after the
    prompts' from one generator seeded 0 (src/repro/launch/serve.py:52-60)."""
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 4))
    frames = rng.normal(size=(2, cfg.frontend.n_tokens, cfg.d_model))
    np.testing.assert_array_equal(serve.make_prompts(cfg, 2, 4, "cpu").numpy(),
                                  prompts)
    got = serve.make_frames(cfg, 2, 4, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.as_tensor(frames, dtype=torch.float32).to(torch.bfloat16).float().numpy())
