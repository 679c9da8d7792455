"""The port's dense model (``repro_torch.models``) held against the JAX
package on relic_tiny SMOKE, with the reference's parameters carried across
by ``repro_torch.models.convert``.

In float32 (params and compute) only the summation order differs between the
frameworks, so the bar is 1e-4. With the default bf16 compute, bf16 rounds at
different places in the two, so the bar is the reference's own decode-vs-
teacher-forcing bar (tests/test_models.py:117-123): 0.15 on logits and greedy
agreement above 0.9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy

F32_TOL = 1e-4
BF16_TOL = 0.15
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cfgs(**kw):
    return (jget_config("relic_tiny", smoke=True).replace(**kw),
            get_config("relic_tiny", smoke=True).replace(**kw))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def jparams():
    """The reference's relic_tiny SMOKE parameters (float32), made once."""
    jcfg, _ = _cfgs()
    return jbuild_model(jcfg).init(jax.random.PRNGKey(0))


def _port(tcfg, jparams):
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(rng, kind):
    jcfg, tcfg = _cfgs(norm=kind)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    want = jL.norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.norm(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, F32_TOL)


def test_rms_norm_headwise(rng):
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    s = rng.normal(size=(16,)).astype(np.float32)
    _close(L.rms_norm_headwise(_t(x), _t(s)),
           jL.rms_norm_headwise(jnp.asarray(x), jnp.asarray(s)), F32_TOL)


def test_apply_rope(rng):
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = np.arange(100, 112)[None, :]
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = L.apply_rope(_t(x), torch.from_numpy(pos), 10_000.0)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu", False), ("gelu", False)])
def test_mlp(rng, act, gated):
    jcfg, tcfg = _cfgs(act=act, gated_mlp=gated, **F32)
    p = {k: (rng.normal(size=shape) * 0.2).astype(np.float32) for k, shape in
         [("w_up", (64, 128)), ("w_gate", (64, 128)), ("w_down", (128, 64))]}
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    want = jL.mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.mlp(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, F32_TOL)


def test_embed_unembed(rng):
    jcfg, tcfg = _cfgs(**F32)
    table = rng.normal(size=(512, 64)).astype(np.float32)
    kernel = rng.normal(size=(64, 512)).astype(np.float32)
    toks = rng.integers(0, 512, (2, 8))
    _close(L.embed(tcfg, {"table": _t(table)}, torch.from_numpy(toks)),
           jL.embed(jcfg, {"table": jnp.asarray(table)}, jnp.asarray(toks)), 0)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    got = L.unembed(tcfg, {"kernel": _t(kernel)}, _t(x))
    assert got.dtype == torch.float32
    _close(got, jL.unembed(jcfg, {"kernel": jnp.asarray(kernel)}, jnp.asarray(x)),
           F32_TOL)


# ---------------------------------------------------------------------------
# attention cores and the decode layer
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, sk, h, kv, d):
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, q_offset=5),
    dict(causal=False, kv_len=9), dict(causal=True, prefix_len=6)])
def test_attention_full(rng, kw):
    sq = 16 - kw.get("q_offset", 0)
    q, k, v = _qkv(rng, 2, sq, 16, 4, 2, 16)
    want = jattn.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attn.attention_full(_t(q), _t(k), _t(v), **kw)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, causal_skip=True),
    dict(causal=True, q_offset=8), dict(causal=True, prefix_len=20)])
def test_attention_chunked(rng, kw):
    q, k, v = _qkv(rng, 2, 64, 64, 4, 2, 16)
    want = jattn.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   chunk_q=16, chunk_k=32, **kw)
    got = attn.attention_chunked(_t(q), _t(k), _t(v), chunk_q=16, chunk_k=32, **kw)
    _close(got, want, F32_TOL)


def test_attention_core_takes_chunked_path_at_threshold(rng):
    jcfg, tcfg = _cfgs(attn_chunk_threshold=64, attn_chunk=32, attn_chunk_q=16,
                       causal_skip=True)
    q, k, v = _qkv(rng, 1, 64, 64, 4, 2, 16)
    want = jattn.attention_core(jcfg, jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True)
    got = attn.attention_core(tcfg, _t(q), _t(k), _t(v), causal=True)
    _close(got, want, F32_TOL)


def test_decode_self_attention(rng):
    jcfg, tcfg = _cfgs(**F32)
    p = {"wq": rng.normal(size=(64, 4, 16)) * 0.1, "wk": rng.normal(size=(64, 2, 16)) * 0.1,
         "wv": rng.normal(size=(64, 2, 16)) * 0.1, "wo": rng.normal(size=(4, 16, 64)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    pos = 7
    y_j, c_j = jattn.decode_self_attention(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.int32(pos))
    y_t, c_t = attn.decode_self_attention(
        tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
        {"k": _t(ck), "v": _t(cv)}, pos)
    _close(y_t, y_j, F32_TOL)
    _close(c_t["k"], c_j["k"], F32_TOL)
    _close(c_t["v"], c_j["v"], F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", ["self_attention", "decode_self_attention"])
def test_rope_under_use_kernels_is_plain_bit_for_bit(rng, monkeypatch, layer,
                                                     dtype):
    """With ``use_kernels`` q's and k's RoPE is one ``ops.rope`` call, whose
    plain version is ``apply_rope``'s: the layer equals the plain one bit
    for bit (prefill under a prefix, which keeps attention off the flash
    kernel both ways, and a decode step)."""
    from repro_torch.kernels import ops

    calls, rope = [], ops.rope
    monkeypatch.setattr(ops, "rope", lambda *a: calls.append(a) or rope(*a))
    td = getattr(torch, dtype)
    p = {"wq": rng.normal(size=(64, 4, 16)), "wk": rng.normal(size=(64, 2, 16)),
         "wv": rng.normal(size=(64, 2, 16)), "wo": rng.normal(size=(4, 16, 64))}
    p = {k: (_t(v) * 0.1).to(td) for k, v in p.items()}
    x = _t(rng.normal(size=(2, 12, 64))).to(td)
    cache = {n: _t(rng.normal(size=(2, 12, 2, 16))).to(td) for n in "kv"}
    out = {}
    for use_kernels in (False, True):
        cfg = get_config("relic_tiny", smoke=True).replace(
            param_dtype=dtype, compute_dtype=dtype, use_kernels=use_kernels)
        with torch.no_grad():
            if layer == "self_attention":
                out[use_kernels] = (attn.self_attention(cfg, p, x, prefix_len=6),)
            else:
                y, c = attn.decode_self_attention(
                    cfg, p, x[:, :1], {n: t.clone() for n, t in cache.items()}, 7)
                out[use_kernels] = (y, c["k"], c["v"])
    assert len(calls) == 1
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _tokens(cfg, rng, b=2, s=16):
    return rng.integers(0, cfg.vocab_size, (b, s))


def _agree(got, want):
    return (np.argmax(got.float().numpy(), -1)
            == np.argmax(np.asarray(want, np.float32), -1)).mean()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_forward_f32(rng, jparams, use_kernels):
    jcfg, tcfg = _cfgs(use_kernels=use_kernels, **F32)
    tparams = _port(tcfg, jparams)
    toks = _tokens(tcfg, rng)
    want, _ = jlm.lm_forward(jcfg, jparams, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = lm.lm_forward(tcfg, tparams, torch.from_numpy(toks))
    assert got.shape == (2, 16, tcfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_forward_bf16(rng, jparams, use_kernels):
    jcfg, tcfg = _cfgs(use_kernels=use_kernels)
    tparams = _port(tcfg, jparams)
    toks = _tokens(tcfg, rng)
    want, _ = jlm.lm_forward(jcfg, jparams, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = lm.lm_forward(tcfg, tparams, torch.from_numpy(toks))
    _close(got, want, BF16_TOL)
    assert _agree(got, want) > 0.9


def test_lm_loss_f32(rng, jparams):
    jcfg, tcfg = _cfgs(**F32)
    tparams = _port(tcfg, jparams)
    toks, labels = _tokens(tcfg, rng), _tokens(tcfg, rng)
    mask = (rng.random((2, 16)) > 0.25).astype(np.float32)
    want, wm = jlm.lm_loss(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels),
                                           "mask": jnp.asarray(mask)})
    with torch.no_grad():
        got, gm = lm.lm_loss(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                             "labels": torch.from_numpy(labels),
                                             "mask": _t(mask)})
    _close(got, want, F32_TOL)
    assert float(gm["tokens"]) == float(wm["tokens"])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lm_decode_step_forced(rng, jparams, precision):
    """16 forced tokens through the decode step of both packages, and the
    port's decode against its own teacher-forced forward."""
    jcfg, tcfg = _cfgs(**(F32 if precision == "f32" else {}))
    tol = F32_TOL if precision == "f32" else BF16_TOL
    tparams = _port(tcfg, jparams)
    b, s = 2, 16
    toks = _tokens(tcfg, rng, b, s)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg, "cpu")
    jcache, tcache = jmodel.init_cache(b, s), tmodel.init_cache(b, s)
    jstep = jax.jit(jmodel.decode_step)
    got, want = [], []
    with torch.no_grad():
        for t in range(s):
            lj, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
            lt, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
            want.append(np.asarray(lj[:, 0], np.float32))
            got.append(lt[:, 0])
        forced, _ = tmodel.forward(tparams, torch.from_numpy(toks))
    got = torch.stack(got, dim=1)
    want = np.stack(want, axis=1)
    _close(got, want, tol)
    _close(tcache["layers"]["cache"]["k"], jcache["layers"]["cache"]["k"], tol)
    _close(got, forced.numpy(), tol)
    assert _agree(got, want) > 0.9
    assert _agree(got, forced.numpy()) > 0.9


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_round_trip(param_dtype):
    jcfg, tcfg = _cfgs(param_dtype=param_dtype)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    back = params_to_numpy(params_from_numpy(tcfg, tree))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    port = params_from_numpy(tcfg, tree)
    assert port["layers"][0]["attn"]["wq"].shape == (64, 4, 16)
    assert port["layers"][1]["attn"]["wo"].shape == (4, 16, 64)
    assert port["layers"][0]["mlp"]["w_up"].dtype == getattr(torch, param_dtype)


def test_params_from_numpy_rejects_a_foreign_tree(jparams):
    _, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jparams)
    del tree["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(tcfg, tree)


def test_port_init_matches_reference_shapes_and_scales(jparams):
    _, tcfg = _cfgs()
    want = jax.tree.map(np.asarray, jparams)
    got = params_to_numpy(build_model(tcfg, "cpu").init(
        torch.Generator().manual_seed(0)))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        assert a.shape == b.shape, path
        # same distribution per leaf: ones, zeros, or normals of one scale
        np.testing.assert_allclose(b.std(), np.asarray(a, np.float32).std(),
                                   rtol=0.2, atol=1e-6, err_msg=str(path))


def test_unknown_arch_raises_and_the_vlm_branch_matches(rng, jparams):
    """An unknown arch raises as the reference's ``get_config`` does; the
    dense block under the VLM family (embeddings scaled by sqrt(d_model),
    the gemma convention) matches the reference on relic_tiny's weights,
    where the scale moves every logit."""
    with pytest.raises(ModuleNotFoundError):
        get_config("no_such_arch")
    jcfg, tcfg = _cfgs(family="vlm", frontend=None, **F32)
    tparams = _port(tcfg, jparams)
    toks = _tokens(tcfg, rng)
    want, _ = jlm.lm_forward(jcfg, jparams, jnp.asarray(toks))
    dense, _ = jlm.lm_forward(_cfgs(**F32)[0], jparams, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = lm.lm_forward(tcfg, tparams, torch.from_numpy(toks))
    _close(got, want, F32_TOL)
    assert float(aux) == 0.0
    assert np.abs(np.asarray(want) - np.asarray(dense)).max() > 1e-2
