"""The port's recurrent families (RWKV-6 and the Zamba2 hybrid) and their
kernels' wrappers, held against the JAX package on the same numpy inputs.

Kernels: ``ops.wkv6`` / ``ops.ssd`` take their plain version for a CPU
tensor; they are held against the JAX ``ops`` (interpret-mode Pallas, as
tests/test_kernels.py runs it) and the jnp oracles at the tolerances of
tests/test_kernels.py:74-111. The CUDA kernels themselves are held against
the same plain versions on the card by ``chip_smoke.py``.

Models: rwkv6_1p6b and zamba2_1p2b SMOKE, with the reference's parameters
carried across by ``repro_torch.models.convert``. In float32 the bar is
1e-4 (only the summation order differs); in bf16 it is the reference's own
decode-vs-teacher-forcing bar (tests/test_models.py:117-123): 0.15 on
logits and greedy agreement above 0.9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import lm as jlm
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jr6
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.models import build_model
from repro_torch.models import lm
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as r6
from repro_torch.models.convert import params_from_numpy, params_to_numpy

F32_TOL = 1e-4
BF16_TOL = 0.15
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ["rwkv6_1p6b", "zamba2_1p2b"]
KTOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-1)}  # test_kernels.py


def _cfgs(arch, **kw):
    return (jget_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(x, dtype="float32"):
    """The same values as a jax array and a torch tensor."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.fixture(scope="module")
def jparams():
    """Each arch's reference SMOKE parameters (float32), made once."""
    return {arch: jbuild_model(_cfgs(arch)[0]).init(jax.random.PRNGKey(0))
            for arch in ARCHS}


def _port(tcfg, tree):
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# kernel wrappers (plain versions on the CPU)
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, b, t, h, k, dtype):
    """Model layout [B,T,H,K]; aggressive decays as tests/test_kernels.py:84."""
    r, kk, v = (_pair(rng.normal(size=(b, t, h, k)), dtype) for _ in range(3))
    lw = _pair(-np.exp(rng.normal(size=(b, t, h, k))))
    u = _pair(rng.normal(size=(h, k)))
    return r, kk, v, lw, u


def _ssd_inputs(rng, b, t, h, p, n, dtype):
    x = _pair(rng.normal(size=(b, t, h, p)), dtype)
    a = _pair(-np.abs(rng.normal(size=(b, t, h))) * 0.5)
    bb = _pair(rng.normal(size=(b, t, n)))
    cc = _pair(rng.normal(size=(b, t, n)))
    return x, a, bb, cc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,k,chunk", [   # tests/test_kernels.py:75-79
    (2, 64, 2, 16, 16),
    (1, 128, 4, 32, 32),
    (2, 96, 2, 16, 32),
    (2, 64, 2, 6, 16),    # K = 6, no multiple of 4: the reference computes it
])
def test_wkv6_matches_jax(rng, dtype, b, t, h, k, chunk):
    (rj, rt), (kj, kt), (vj, vt), (wj, wt), (uj, ut) = _wkv_inputs(
        rng, b, t, h, k, dtype)
    before = wkv6_mod.launches
    got = ops.wkv6(rt, kt, vt, wt, ut, chunk=chunk)
    assert wkv6_mod.launches == before  # the CPU path launches no kernel
    assert got.shape == (b, t, h, k) and got.dtype == rt.dtype
    assert np.isfinite(_np(got)).all()
    pallas = jops.wkv6(rj, kj, vj, wj, uj, chunk=chunk)
    oracle = jref.wkv6_ref(*(a.swapaxes(1, 2) for a in (rj, kj, vj, wj)),
                           uj).swapaxes(1, 2)
    rtol, atol = KTOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,p,n,chunk", [   # tests/test_kernels.py:97-100
    (2, 64, 2, 16, 8, 16),
    (1, 128, 4, 32, 16, 32),
    (2, 64, 2, 6, 6, 16),     # P = N = 6, no multiple of 4: the reference computes it
])
def test_ssd_matches_jax(rng, dtype, b, t, h, p, n, chunk):
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(rng, b, t, h, p, n,
                                                         dtype)
    before = ssd_mod.launches
    got = ops.ssd(xt, at, bt, ct, chunk=chunk)
    assert ssd_mod.launches == before
    assert got.shape == (b, t, h, p) and got.dtype == xt.dtype
    pallas = jops.ssd(xj, aj, bj, cj, chunk=chunk)
    oracle = jref.ssd_ref(xj.swapaxes(1, 2), aj.swapaxes(1, 2), bj,
                          cj).swapaxes(1, 2)
    rtol, atol = KTOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_wkv6_ragged_t_matches_jax_oracle(rng):
    """T = 37 is no multiple of the chunk: the port's wrapper takes it as it
    is (the card's kernel masks the last chunk)."""
    (rj, rt), (kj, kt), (vj, vt), (wj, wt), (uj, ut) = _wkv_inputs(
        rng, 1, 37, 2, 16, "float32")
    got = ops.wkv6(rt, kt, vt, wt, ut, chunk=16)
    want = jref.wkv6_ref(*(a.swapaxes(1, 2) for a in (rj, kj, vj, wj)),
                         uj).swapaxes(1, 2)
    _close(got, want, 1e-3)


def test_ssd_ragged_t_matches_jax_oracle(rng):
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(rng, 1, 45, 2, 8, 8,
                                                         "float32")
    got = ops.ssd(xt, at, bt, ct, chunk=32)
    want = jref.ssd_ref(xj.swapaxes(1, 2), aj.swapaxes(1, 2), bj,
                        cj).swapaxes(1, 2)
    _close(got, want, 1e-3)


def test_cuda_entries_reject_cpu_tensors():
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_mod.wkv6_cuda(x, x, x, x, torch.zeros((2, 16)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_mod.ssd_cuda(x, torch.zeros((1, 2, 8)), torch.zeros((1, 8, 4)),
                         torch.zeros((1, 8, 4)))


@pytest.mark.parametrize("case", ["dtype", "u_shape"])
def test_wkv6_rejects_bad_inputs(case):
    dtype = torch.float16 if case == "dtype" else torch.float32
    k = 8
    x = torch.zeros((1, 2, 4, k), dtype=dtype)
    u = torch.zeros((3, k) if case == "u_shape" else (2, k))
    with pytest.raises(ValueError):
        wkv6_mod.wkv6_bhtk(x, x, x, x.float(), u)


@pytest.mark.parametrize("case", ["dtype", "a_shape", "bc_shape"])
def test_ssd_rejects_bad_inputs(case):
    x = torch.zeros((1, 2, 4, 8), dtype=torch.float16 if case == "dtype"
                    else torch.float32)
    a = torch.zeros((1, 3, 4) if case == "a_shape" else (1, 2, 4))
    b = torch.zeros((1, 5, 4) if case == "bc_shape" else (1, 4, 4))
    with pytest.raises(ValueError):
        ssd_mod.ssd_bhtp(x, a, b, torch.zeros((1, 4, 4)))


# ---------------------------------------------------------------------------
# chunked forms and their step twins (tests/test_models.py:175-218)
# ---------------------------------------------------------------------------

def test_wkv6_chunked_matches_jax_and_stepwise(rng):
    b, t, h, k = 1, 32, 2, 8
    r, kk, v = (rng.normal(size=(b, t, h, k)).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.normal(size=(b, t, h, k)).astype(np.float32) - 1)
    u = rng.normal(size=(h, k)).astype(np.float32)
    s0 = np.zeros((b, h, k, k), np.float32)
    out_j, state_j = jr6.wkv6_chunked(*map(jnp.asarray, (r, kk, v, lw, u, s0)), 8)
    out_c, state_c = r6.wkv6_chunked(*map(_t, (r, kk, v, lw, u, s0)), 8)
    _close(out_c, out_j, F32_TOL)
    _close(state_c, state_j, F32_TOL)
    state, outs = _t(s0), []
    for i in range(t):
        o, state = r6.wkv6_step(_t(r[:, i]), _t(kk[:, i]), _t(v[:, i]),
                                _t(lw[:, i]), _t(u), state)
        outs.append(o)
    _close(out_c, torch.stack(outs, dim=1), F32_TOL)
    _close(state_c, state, F32_TOL)


def test_ssd_chunked_matches_jax_and_stepwise(rng):
    b, t, h, p, n = 1, 32, 2, 8, 4
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    a = -np.abs(rng.normal(size=(b, t, h))).astype(np.float32)
    bb, cc = (rng.normal(size=(b, t, n)).astype(np.float32) for _ in range(2))
    s0 = np.zeros((b, h, p, n), np.float32)
    y_j, s_j = jm2.ssd_chunked(*map(jnp.asarray, (x, a, bb, cc, s0)), 8)
    y_c, s_c = m2.ssd_chunked(*map(_t, (x, a, bb, cc, s0)), 8)
    _close(y_c, y_j, F32_TOL)
    _close(s_c, s_j, F32_TOL)
    state, ys = _t(s0), []
    for i in range(t):
        y, state = m2.ssd_step(_t(x[:, i]), _t(a[:, i]), _t(bb[:, i]),
                               _t(cc[:, i]), state)
        ys.append(y)
    _close(y_c, torch.stack(ys, dim=1), F32_TOL)
    _close(s_c, state, F32_TOL)


def test_ssd_chunked_stays_finite_with_strong_decay(rng):
    """Upper-triangle exponents far above f32's range are selected away."""
    b, t, h, p, n = 1, 16, 1, 4, 4
    x = _t(rng.normal(size=(b, t, h, p)))
    a = torch.full((b, t, h), -20.0)
    bb, cc = _t(rng.normal(size=(b, t, n))), _t(rng.normal(size=(b, t, n)))
    y, state = m2.ssd_chunked(x, a, bb, cc, torch.zeros((b, h, p, n)), 16)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _close(y, ref.ssd_ref(x.transpose(1, 2), a.transpose(1, 2), bb,
                          cc).transpose(1, 2), 1e-3)


# ---------------------------------------------------------------------------
# blocks against the JAX package, f32
# ---------------------------------------------------------------------------

def _layer0(tree, name):
    return jax.tree.map(lambda a: np.asarray(a[0], np.float32),
                        tree["layers"][name])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_rwkv_time_mix(rng, jparams, use_kernels):
    jcfg, tcfg = _cfgs("rwkv6_1p6b", use_kernels=use_kernels, **F32)
    p = _layer0(jparams["rwkv6_1p6b"], "rwkv")
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    want = jr6.rwkv_time_mix(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = r6.rwkv_time_mix(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, F32_TOL)


def test_rwkv_time_mix_decode(rng, jparams):
    jcfg, tcfg = _cfgs("rwkv6_1p6b", **F32)
    p = _layer0(jparams["rwkv6_1p6b"], "rwkv")
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    cache = {"shift_state": rng.normal(size=(2, 64)).astype(np.float32),
             "wkv_state": rng.normal(size=(2, 4, 16, 16)).astype(np.float32)}
    y_j, c_j = jr6.rwkv_time_mix_decode(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache))
    y_t, c_t = r6.rwkv_time_mix_decode(
        tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
        {k: _t(v) for k, v in cache.items()})
    _close(y_t, y_j, F32_TOL)
    for name in ("shift_state", "wkv_state"):
        _close(c_t[name], c_j[name], F32_TOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_rwkv_channel_mix(rng, jparams, shifted):
    jcfg, tcfg = _cfgs("rwkv6_1p6b", **F32)
    p = _layer0(jparams["rwkv6_1p6b"], "cmix")
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    shift = rng.normal(size=(2, 64)).astype(np.float32) if shifted else None
    want = jr6.rwkv_channel_mix(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        shift_state=None if shift is None else jnp.asarray(shift))
    got = r6.rwkv_channel_mix(tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
                              shift_state=None if shift is None else _t(shift))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mamba2_block(rng, jparams, use_kernels):
    jcfg, tcfg = _cfgs("zamba2_1p2b", use_kernels=use_kernels, **F32)
    p = _layer0(jparams["zamba2_1p2b"], "ssm")
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    want = jm2.mamba2_block(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = m2.mamba2_block(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, F32_TOL)


def test_mamba2_block_decode(rng, jparams):
    jcfg, tcfg = _cfgs("zamba2_1p2b", **F32)
    p = _layer0(jparams["zamba2_1p2b"], "ssm")
    _, n_heads, conv_dim = m2._dims(tcfg)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    cache = {"conv_state": rng.normal(size=(2, 3, conv_dim)).astype(np.float32),
             "ssm_state": rng.normal(size=(2, n_heads, 16, 16)).astype(np.float32)}
    y_j, c_j = jm2.mamba2_block_decode(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache))
    y_t, c_t = m2.mamba2_block_decode(
        tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
        {k: _t(v) for k, v in cache.items()})
    _close(y_t, y_j, F32_TOL)
    for name in ("conv_state", "ssm_state"):
        _close(c_t[name], c_j[name], F32_TOL)


def test_causal_conv_with_state(rng):
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32)
    for state in (None, st):
        want, ws = jm2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if state is None else jnp.asarray(state))
        got, gs = m2._causal_conv(_t(x), _t(w),
                                  None if state is None else _t(state))
        _close(got, want, F32_TOL)
        _close(gs, ws, 0)


def test_hybrid_groups_match_reference():
    for arch in ARCHS:
        for smoke in (False, True):
            jcfg = jget_config(arch, smoke=smoke)
            tcfg = get_config(arch, smoke=smoke)
            assert lm._hybrid_groups(tcfg) == jlm._hybrid_groups(jcfg)
    assert lm._hybrid_groups(get_config("zamba2_1p2b")) == (6, 2)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _tokens(cfg, rng, b=2, s=16):
    return rng.integers(0, cfg.vocab_size, (b, s))


def _agree(got, want):
    return (np.argmax(_np(got), -1) == np.argmax(_np(want), -1)).mean()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_f32(rng, jparams, arch, use_kernels):
    jcfg, tcfg = _cfgs(arch, use_kernels=use_kernels, **F32)
    tparams = _port(tcfg, jparams[arch])
    toks = _tokens(tcfg, rng)
    want, _ = jlm.lm_forward(jcfg, jparams[arch], jnp.asarray(toks))
    with torch.no_grad():
        got, aux = lm.lm_forward(tcfg, tparams, torch.from_numpy(toks))
    assert got.shape == (2, 16, tcfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want, F32_TOL)


def _rel(got, want):
    return float(np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want)))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_bf16(rng, jparams, arch, use_kernels):
    """bf16 rounds at other places in the two frameworks (XLA on the CPU
    rounds each step of its bf16 sigmoid, for one). The bar is the JAX
    package's own bf16 noise: the port's bf16 logits lie no farther from
    the reference's bf16 logits than those lie from the reference's f32
    logits, in relative norm, and greedy agreement is above 0.9 over 128
    tokens. zamba2 also meets 0.15 elementwise; rwkv6 SMOKE cannot, since
    its own bf16 forward is off its f32 forward by more than 0.15 at some
    of these logits."""
    jcfg, tcfg = _cfgs(arch, use_kernels=use_kernels)
    tparams = _port(tcfg, jparams[arch])
    toks = _tokens(tcfg, rng, 4, 32)
    want, _ = jlm.lm_forward(jcfg, jparams[arch], jnp.asarray(toks))
    want_f32, _ = jlm.lm_forward(jcfg.replace(compute_dtype="float32"),
                                 jparams[arch], jnp.asarray(toks))
    with torch.no_grad():
        got, _ = lm.lm_forward(tcfg, tparams, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and np.isfinite(_np(got)).all()
    assert _rel(got, want) <= _rel(want, want_f32)
    assert _agree(got, want) > 0.9
    if arch == "zamba2_1p2b":
        _close(got, want, BF16_TOL)


def _cache_leaves(cache):
    """{key path: leaf} of a cache of either package."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        cache, is_leaf=lambda x: isinstance(x, torch.Tensor))
    return {jax.tree_util.keystr(k): v for k, v in flat}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_step_forced(rng, jparams, arch, precision):
    """16 forced tokens through the decode step of both packages, the
    recurrent states and shared kv caches after them, and the port's decode
    against its own teacher-forced forward."""
    jcfg, tcfg = _cfgs(arch, **(F32 if precision == "f32" else {}))
    tol = F32_TOL if precision == "f32" else BF16_TOL
    tparams = _port(tcfg, jparams[arch])
    b, s = 8, 16   # agreement over 128 tokens (see test_lm_forward_bf16)
    toks = _tokens(tcfg, rng, b, s)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg, "cpu")
    jcache, tcache = jmodel.init_cache(b, s), tmodel.init_cache(b, s)
    jstep = jax.jit(jmodel.decode_step)
    got, want = [], []
    with torch.no_grad():
        for t in range(s):
            lj, jcache = jstep(jparams[arch], jcache,
                               jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            lt, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
            want.append(np.asarray(lj[:, 0], np.float32))
            got.append(lt[:, 0])
        forced, _ = tmodel.forward(tparams, torch.from_numpy(toks))
    got = torch.stack(got, dim=1)
    want = np.stack(want, axis=1)
    jleaves, tleaves = _cache_leaves(jcache), _cache_leaves(tcache)
    assert set(tleaves) == set(jleaves)
    for name, arr in jleaves.items():
        assert tuple(tleaves[name].shape) == arr.shape, name
    if precision == "bf16" and arch == "rwkv6_1p6b":
        # Below the model's own bf16 noise (see test_lm_forward_bf16): hold
        # the logits and states in relative norm to the reference's
        # bf16-against-f32 distance on the same tokens.
        jf, _ = jlm.lm_forward(jcfg, jparams[arch], jnp.asarray(toks))
        jf32, _ = jlm.lm_forward(jcfg.replace(compute_dtype="float32"),
                                 jparams[arch], jnp.asarray(toks))
        bar = _rel(jf, jf32)
        assert _rel(got, want) <= bar and _rel(got, forced) <= bar
        for name, arr in jleaves.items():
            assert _rel(tleaves[name], arr) <= bar, name
    else:
        _close(got, want, tol)
        for name, arr in jleaves.items():
            np.testing.assert_allclose(_np(tleaves[name]), _np(arr), rtol=tol,
                                       atol=tol, err_msg=name)
        _close(got, forced, tol)
    assert _agree(got, want) > 0.9
    assert _agree(got, forced) > 0.9


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_cache_layout(arch):
    cfg = get_config(arch, smoke=True)
    cache = lm.init_lm_cache(cfg, 3, 7)
    jcache = jbuild_model(jget_config(arch, smoke=True)).init_cache(3, 7)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _cache_leaves(jcache).items()}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _cache_leaves(cache).items()}
    assert got == want


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, param_dtype):
    jcfg, tcfg = _cfgs(arch, param_dtype=param_dtype)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    port = params_from_numpy(tcfg, tree)
    back = params_to_numpy(port)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert len(port["layers"]) == tcfg.n_layers
    if arch == "zamba2_1p2b":
        assert "shared_attn" in tree
        assert port["shared_attn"]["attn"]["wq"].shape == (64, 4, 16)
        assert port["layers"][4]["ssm"]["w_in"].dtype == getattr(torch, param_dtype)
    else:
        assert port["layers"][1]["rwkv"]["mu"].shape == (5, 64)
        assert port["layers"][0]["cmix"]["w_k"].dtype == getattr(torch, param_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_shapes_and_scales(jparams, arch):
    _, tcfg = _cfgs(arch)
    want = jax.tree.map(np.asarray, jparams[arch])
    got = params_to_numpy(build_model(tcfg, "cpu").init(
        torch.Generator().manual_seed(0)))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        assert a.shape == b.shape, path
        # same distribution per leaf: constants, or normals of one scale
        np.testing.assert_allclose(b.std(), np.asarray(a, np.float32).std(),
                                   rtol=0.2, atol=1e-6, err_msg=str(path))
        if np.asarray(a).std() == 0:
            np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    if arch == "zamba2_1p2b":   # dt_bias comes from numpy's RandomState(0)
        np.testing.assert_allclose(got["layers"]["ssm"]["dt_bias"],
                                   want["layers"]["ssm"]["dt_bias"], rtol=1e-6)
